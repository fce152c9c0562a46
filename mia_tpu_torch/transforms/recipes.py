"""Per-dataset augmentation recipes (counterpart of
``mia_tpu/transforms/recipes.py``). Only the fugc/busi recipe is ported:
affine-scale(0.7-1.4)@0.2 and affine-rot(±15°)@0.2 fused into one warp,
noise(0-0.1)@0.1, blur(0.5-1)@0.2, brightness(0.25)@0.15,
contrast(0.25)@0.15, lowres(0.5-1)@0.15, gamma(0.7-1.5)@0.1.
"""

from __future__ import annotations

from .common import ComposeTransform, RandomTransform
from .image import (
    RandomBrightness,
    RandomContrast,
    RandomGamma,
    RandomGaussianBlur,
    RandomGaussianNoise,
    SimulateLowRes,
)
from .joint import FusedRandomAffines, RandomAffine


def get_train_transform(dataset: str, do_augment: bool = True) -> ComposeTransform:
    if not do_augment:
        return ComposeTransform([])
    if dataset not in ("fugc", "busi"):
        raise NotImplementedError(f"the {dataset!r} augmentation recipe is not ported")
    return ComposeTransform(
        [
            FusedRandomAffines(
                [
                    (RandomAffine(scale=(0.7, 1.4)), 0.2),
                    (RandomAffine(degrees=(-15, 15)), 0.2),
                ]
            ),
            RandomTransform(RandomGaussianNoise(sigma=(0, 0.1)), p=0.1),
            RandomTransform(RandomGaussianBlur(sigma=(0.5, 1)), p=0.2),
            RandomTransform(RandomBrightness(brightness=0.25), p=0.15),
            RandomTransform(RandomContrast(contrast=0.25), p=0.15),
            RandomTransform(SimulateLowRes(scale=(0.5, 1)), p=0.15),
            RandomTransform(RandomGamma(gamma=(0.7, 1.5)), p=0.1),
        ]
    )
