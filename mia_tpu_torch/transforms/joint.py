"""Joint geometric transforms (image + label), batched.

Counterpart of ``mia_tpu/transforms/joint.py``. Every draw is per sample:

- ``JointResize`` (bilinear antialiased image, nearest label) and
  ``RandomCrop2D`` change the shape, so no gate may wrap them;
- ``RandomRotation90`` (k ~ U{0..3}; square images only, as the JAX
  package's ``lax.switch`` over the four turns needs one output shape),
  ``MirrorTransform`` (deterministic flip; the reference's axes -2 / -1 are
  H / W), ``RandomRotation`` and ``RandomAffine`` warp image and label with
  the direct nearest gather ``ops.warp.affine_warp``, as the acdc/thyroid
  recipe does;
- ``FusedRandomAffines`` composes several gated affines into one nearest
  warp of the stacked image+label tensor through kernel K1 (the FUGC recipe).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.resize import resize
from ..ops.warp import (affine_inverse_matrix, affine_warp, affine_warp_shift2pass_fused,
                        rotate_warp)
from .common import Transform, uniform


def _pair(size) -> tuple[int, int]:
    if isinstance(size, int):
        return (size, size)
    size = tuple(int(s) for s in size)
    return size * 2 if len(size) < 2 else size


def _warp_pair(images, labels, warp):
    """``warp`` (nearest) of the images and of the labels as one channel."""
    return warp(images), warp(labels[..., None])[..., 0]


class JointResize(Transform):
    """Bilinear antialiased image / nearest label resize to ``image_size``."""

    def __init__(self, image_size):
        self.image_size = _pair(image_size)

    def apply(self, params, images, labels):
        images = resize(images, self.image_size, "bilinear", antialias=True)
        lbl = resize(labels[..., None], self.image_size, "nearest")[..., 0]
        return images, lbl.to(labels.dtype)

    def get_params_dict(self):
        return {"JointResize": {"image_size": list(self.image_size)}}


class RandomRotation90(Transform):
    """k ~ U{0..3} quarter-turns in the (H, W) plane, per sample."""

    def draw(self, gen, shape, device):
        if shape[1] != shape[2]:
            raise ValueError(
                f"RandomRotation90 needs square images, got {shape[1]}x{shape[2]}")
        return {"k": torch.randint(0, 4, (shape[0],), generator=gen, device=device)}

    def apply(self, params, images, labels):
        if images.shape[1] != images.shape[2]:
            raise ValueError(
                f"RandomRotation90 needs square images, got {images.shape[1]}x{images.shape[2]}")
        k = params["k"]
        out_img, out_lbl = images, labels
        for turns in (1, 2, 3):
            hit = k == turns
            out_img = torch.where(hit[:, None, None, None],
                                  torch.rot90(images, turns, (1, 2)), out_img)
            out_lbl = torch.where(hit[:, None, None], torch.rot90(labels, turns, (1, 2)), out_lbl)
        return out_img, out_lbl

    def get_params_dict(self):
        return {"RandomRotation90": {"axes": [0, 1]}}


def _hwc_axes(axes) -> tuple[int, ...]:
    """Map the reference's CHW axis indices (-2 = H, -1 = W) to HWC."""
    if not isinstance(axes, Sequence):
        axes = (axes,)
    return tuple({-2: 0, -1: 1, 0: 0, 1: 1}[int(a)] for a in axes)


class MirrorTransform(Transform):
    """Deterministic flip over the given axes; randomness comes from the
    combinators."""

    def __init__(self, axes):
        self.axes = _hwc_axes(axes)

    def apply(self, params, images, labels):
        if not self.axes:
            return images, labels
        dims = tuple(a + 1 for a in self.axes)  # past the batch axis
        return images.flip(dims), labels.flip(dims)

    def get_params_dict(self):
        return {"MirrorTransform": {"allowed_axes": list(self.axes)}}


class RandomRotation(Transform):
    """angle ~ U(degrees) per sample; torchvision ``F.rotate``'s NEAREST on
    image and label."""

    def __init__(self, degrees):
        if not isinstance(degrees, Sequence):
            degrees = [-degrees, degrees]
        self.degrees = [float(degrees[0]), float(degrees[1])]

    def draw(self, gen, shape, device):
        return {"angle": uniform(gen, shape[0], self.degrees[0], self.degrees[1], device)}

    def apply(self, params, images, labels):
        return _warp_pair(images, labels, lambda x: rotate_warp(x, params["angle"], "nearest"))

    def get_params_dict(self):
        return {"RandomRotation": {"degrees": self.degrees}}


class RandomCrop2D(Transform):
    """Uniform top-left corner per sample, a ``crop`` window out."""

    def __init__(self, crop):
        if not isinstance(crop, (list, tuple)):
            crop = (crop, crop)
        self.crop = (int(crop[0]), int(crop[1]))

    def draw(self, gen, shape, device):
        (th, tw), (h, w) = self.crop, shape[1:3]
        return {"i": torch.randint(0, max(h - th + 1, 1), (shape[0],), generator=gen,
                                   device=device),
                "j": torch.randint(0, max(w - tw + 1, 1), (shape[0],), generator=gen,
                                   device=device)}

    def apply(self, params, images, labels):
        th, tw = self.crop
        dev = images.device
        rows = params["i"][:, None, None] + torch.arange(th, device=dev)[None, :, None]
        cols = params["j"][:, None, None] + torch.arange(tw, device=dev)[None, None, :]
        b = torch.arange(images.shape[0], device=dev)[:, None, None]
        return images[b, rows, cols], labels[b, rows, cols]

    def get_params_dict(self):
        return {"RandomCrop2D": {"crop": list(self.crop)}}


class RandomAffine(Transform):
    """torchvision ``RandomAffine.get_params`` sampling per sample and
    ``F.affine`` (NEAREST, zero fill) on image and label with the direct
    gather. ``FusedRandomAffines`` uses its sampling alone."""

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

    def draw(self, gen, shape, device):
        h, w = shape[1], shape[2]
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
        return {"matrix": self._sample_matrix(gen, shape[0], h, w, center, device)}

    def apply(self, params, images, labels):
        return _warp_pair(images, labels, lambda x: affine_warp(x, params["matrix"], "nearest"))

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
