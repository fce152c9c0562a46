from .active import ActiveDataset
from .base import (
    BaseDataset,
    ZScoreNormalizeHost,
    get_path,
    host_joint_resize,
    host_zscore,
    load_image_grayscale,
    load_label,
)
from .common import ExtendableDataset, ImageDataset
from .fugc import FUGCDataset
from .loader import BatchLoader, collate, decode_path
from .sampler import TwoStreamBatchSampler
from .utils import SplitDictKeyException

# only FUGC is ported; the JAX package also has BUSI/ACDC/TN3K/TG3K/LA2018/BTCV
DATASETS = {"fugc": FUGCDataset}

__all__ = [
    "ActiveDataset",
    "BaseDataset",
    "BatchLoader",
    "DATASETS",
    "ExtendableDataset",
    "FUGCDataset",
    "ImageDataset",
    "SplitDictKeyException",
    "TwoStreamBatchSampler",
    "ZScoreNormalizeHost",
    "collate",
    "decode_path",
    "get_path",
    "host_joint_resize",
    "host_zscore",
    "load_image_grayscale",
    "load_label",
]
