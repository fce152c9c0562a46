from .common import ComposeTransform, RandomTransform, Transform
from .image import (
    RandomBrightness,
    RandomContrast,
    RandomGamma,
    RandomGaussianBlur,
    RandomGaussianNoise,
    SimulateLowRes,
    contrast_blend,
)
from .joint import FusedRandomAffines, RandomAffine
from .normalization import zscore_normalize
from .recipes import get_train_transform

__all__ = [
    "ComposeTransform",
    "FusedRandomAffines",
    "RandomAffine",
    "RandomBrightness",
    "RandomContrast",
    "RandomGamma",
    "RandomGaussianBlur",
    "RandomGaussianNoise",
    "RandomTransform",
    "SimulateLowRes",
    "Transform",
    "contrast_blend",
    "get_train_transform",
    "zscore_normalize",
]
