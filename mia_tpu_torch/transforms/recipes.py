"""Per-dataset augmentation recipes (counterpart of
``mia_tpu/transforms/recipes.py``).

fugc/busi: affine-scale(0.7-1.4)@0.2 and affine-rot(±15°)@0.2 fused into
one warp (kernel K1), noise(0-0.1)@0.1, blur(0.5-1)@0.2,
brightness(0.25)@0.15, contrast(0.25)@0.15, lowres(0.5-1)@0.15,
gamma(0.7-1.5)@0.1.

acdc/thyroid (and every other dataset): (rot90 + random H/W mirror)@0.5,
affine-rot(±20°)@0.5, the rotation by the direct nearest gather.
"""

from __future__ import annotations

from .common import ComposeTransform, RandomChoiceTransform, RandomTransform
from .image import (
    RandomBrightness,
    RandomContrast,
    RandomGamma,
    RandomGaussianBlur,
    RandomGaussianNoise,
    SimulateLowRes,
)
from .joint import FusedRandomAffines, MirrorTransform, RandomAffine, RandomRotation90


def get_train_transform(dataset: str, do_augment: bool = True) -> ComposeTransform:
    if not do_augment:
        return ComposeTransform([])
    if dataset in ("fugc", "busi"):
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
    return ComposeTransform(
        [
            RandomTransform(
                ComposeTransform(
                    [
                        RandomRotation90(),
                        RandomChoiceTransform([MirrorTransform(-2), MirrorTransform(-1)]),
                    ]
                ),
                p=0.5,
            ),
            RandomTransform(RandomAffine(degrees=(-20, 20)), p=0.5),
        ]
    )


def get_valid_transform() -> ComposeTransform:
    """Validation applies no transform."""
    return ComposeTransform([])
