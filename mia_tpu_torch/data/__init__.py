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
from .btcv import BTCVDataset
from .busi import BUSIDataset
from .common import ExtendableDataset, ImageDataset
from .fugc import FUGCDataset
from .la2018 import LA2018Dataset
from .loader import BatchLoader, collate, decode_path
from .sampler import TwoStreamBatchSampler
from .thyroid import TG3KDataset, TN3KDataset
from .utils import SplitDictKeyException

# the JAX package's registry (LA2018 keeps its (image, label) convention;
# BTCV is a stub upstream too)
DATASETS = {
    "fugc": FUGCDataset,
    "busi": BUSIDataset,
    "acdc": ACDCDataset,
    "tn3k": TN3KDataset,
    "tg3k": TG3KDataset,
    "la2018": LA2018Dataset,
    "btcv": BTCVDataset,
}

__all__ = [
    "ACDCDataset",
    "ActiveDataset",
    "BTCVDataset",
    "BUSIDataset",
    "BaseDataset",
    "BatchLoader",
    "DATASETS",
    "ExtendableDataset",
    "FUGCDataset",
    "ImageDataset",
    "LA2018Dataset",
    "SplitDictKeyException",
    "TG3KDataset",
    "TN3KDataset",
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
