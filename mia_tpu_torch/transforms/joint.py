"""Joint geometric transforms (image + label), batched.

Counterpart of ``mia_tpu/transforms/joint.py`` for the FUGC recipe:
``RandomAffine`` (its parameter sampling) and ``FusedRandomAffines``, which
composes several gated affines into one nearest warp of the stacked
image+label tensor through kernel K1.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.warp import affine_inverse_matrix, affine_warp_shift2pass_fused
from .common import Transform, uniform


class RandomAffine(Transform):
    """torchvision ``RandomAffine.get_params`` sampling (NEAREST, zero fill).
    Only its matrix sampling is ported; ``FusedRandomAffines`` warps."""

    def __init__(self, degrees=0.0, translate=None, scale=None, shear=None):
        if not isinstance(degrees, Sequence):
            degrees = [-degrees, degrees]
        self.degrees = [float(degrees[0]), float(degrees[1])]
        self.translate = list(translate) if translate else None
        self.scale = list(scale) if scale else None
        if shear:
            if not isinstance(shear, Sequence):
                shear = [-shear, shear]
            self.shear = [float(s) for s in shear]
        else:
            self.shear = None

    def _sample_matrix(self, gen, batch, h, w, center, device) -> torch.Tensor:
        """Draw torchvision's get_params per sample → ``(B, 2, 3)``."""
        zeros = torch.zeros(batch, dtype=torch.float32, device=device)
        angle = uniform(gen, batch, self.degrees[0], self.degrees[1], device)
        if self.translate is not None:
            max_dx = self.translate[0] * w
            max_dy = self.translate[1] * h
            tx = torch.round(uniform(gen, batch, -max_dx, max_dx, device))
            ty = torch.round(uniform(gen, batch, -max_dy, max_dy, device))
        else:
            tx = ty = zeros
        if self.scale is not None:
            scale = uniform(gen, batch, self.scale[0], self.scale[1], device)
        else:
            scale = torch.ones_like(zeros)
        shx = shy = zeros
        if self.shear is not None:
            shx = uniform(gen, batch, self.shear[0], self.shear[1], device)
            if len(self.shear) == 4:
                shy = uniform(gen, batch, self.shear[2], self.shear[3], device)
        return affine_inverse_matrix(
            angle, torch.stack([tx, ty], -1), scale, torch.stack([shx, shy], -1), center
        )

    def get_params_dict(self):
        return {
            "RandomAffine": {
                "degrees": self.degrees,
                "translate": self.translate,
                "scale": self.scale,
                "shear": self.shear,
            }
        }


class FusedRandomAffines(Transform):
    """Several Bernoulli-gated ``RandomAffine``s composed into ONE warp.

    The gate-conditional inverse matrices (identity where a gate misses)
    are multiplied, and the image and label stack is warped once with K1
    (``affine_warp_shift2pass_fused``). Samples whose composed map is the
    identity keep their input. Like the JAX package's TPU path, this is the
    split-rounding warp, so the recipe's ranges must keep the map far from
    a 90° axis swap (``max rotation + shear <= 45°``, ``min scale >= 0.4``).
    """

    def __init__(self, affines_with_p: list):
        self.affines_with_p = [(a, float(p)) for a, p in affines_with_p]
        max_rot = max_shear = 0.0
        min_scale = 1.0
        for a, _ in self.affines_with_p:
            max_rot += max(abs(a.degrees[0]), abs(a.degrees[1]))
            if a.shear:
                max_shear += max(abs(s) for s in a.shear)
            if a.scale:
                min_scale = min(min_scale, a.scale[0])
        if not (max_rot + max_shear <= 45.0 and min_scale >= 0.4):
            raise NotImplementedError(
                "only the split-rounding warp is ported: affine ranges must keep "
                "rotation + shear <= 45 degrees and scale >= 0.4"
            )

    def draw(self, gen, shape, device):
        batch, h, w = shape[0], shape[1], shape[2]
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
        identity = torch.eye(3, dtype=torch.float32, device=device)
        m = identity.expand(batch, 3, 3)
        bottom = identity[2:].expand(batch, 1, 3)
        for affine, p in self.affines_with_p:
            fire = torch.rand(batch, generator=gen, device=device) < p
            mi = torch.cat([affine._sample_matrix(gen, batch, h, w, center, device), bottom], 1)
            mi = torch.where(fire[:, None, None], mi, identity)
            m = m @ mi
        is_identity = ((m - identity).abs() < 1e-12).flatten(1).all(1)
        return {"matrix": m[:, :2].contiguous(), "is_identity": is_identity}

    def apply(self, params, images, labels):
        stacked = torch.cat([images.float(), labels[..., None].float()], -1).contiguous()
        warped = affine_warp_shift2pass_fused(stacked, params["matrix"])
        warped_img = warped[..., :-1].to(images.dtype)
        warped_lbl = torch.round(warped[..., -1]).to(labels.dtype)
        keep = params["is_identity"]
        images = torch.where(keep[:, None, None, None], images, warped_img)
        labels = torch.where(keep[:, None, None], labels, warped_lbl)
        return images, labels

    def get_params_dict(self):
        return {
            "FusedRandomAffines": {
                "affines": [
                    {"p": p, "transform": a.get_params_dict()}
                    for a, p in self.affines_with_p
                ]
            }
        }
