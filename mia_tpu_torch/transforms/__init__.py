from .common import ComposeTransform, Identity, RandomChoiceTransform, RandomTransform, Transform
from .image import (
    RandomBrightness,
    RandomContrast,
    RandomGamma,
    RandomGaussianBlur,
    RandomGaussianNoise,
    SimulateLowRes,
    contrast_blend,
)
from .joint import (
    FusedRandomAffines,
    JointResize,
    MirrorTransform,
    RandomAffine,
    RandomCrop2D,
    RandomRotation,
    RandomRotation90,
)
from .normalization import zscore_normalize
from .recipes import get_train_transform, get_valid_transform

__all__ = [
    "ComposeTransform",
    "FusedRandomAffines",
    "Identity",
    "JointResize",
    "MirrorTransform",
    "RandomAffine",
    "RandomBrightness",
    "RandomChoiceTransform",
    "RandomContrast",
    "RandomCrop2D",
    "RandomGamma",
    "RandomGaussianBlur",
    "RandomGaussianNoise",
    "RandomRotation",
    "RandomRotation90",
    "RandomTransform",
    "SimulateLowRes",
    "Transform",
    "contrast_blend",
    "get_train_transform",
    "get_valid_transform",
    "zscore_normalize",
]
