from .acdc import ACDCDataset
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
from .busi import BUSIDataset
from .common import ExtendableDataset, ImageDataset
from .fugc import FUGCDataset
from .loader import BatchLoader, collate, decode_path
from .sampler import TwoStreamBatchSampler
from .utils import SplitDictKeyException

# the AL trainer's datasets (ACDC serves CPC-SAM); the JAX package also has
# TN3K/TG3K/LA2018/BTCV
DATASETS = {"fugc": FUGCDataset, "busi": BUSIDataset}

__all__ = [
    "ACDCDataset",
    "ActiveDataset",
    "BUSIDataset",
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
