"""Image-only (photometric) transforms, batched with per-sample parameters.

Counterpart of ``mia_tpu/transforms/image.py``; each transform's ``apply``
is the JAX transform's math over a batch.
"""

from __future__ import annotations

import math

import torch

from ..ops import gaussian_blur, simulate_low_res
from .common import Transform, uniform


def _as_range(v, centered: bool = False):
    if isinstance(v, (tuple, list)):
        return [float(v[0]), float(v[1])]
    v = float(v)
    if centered:
        return [max(1.0 - v, 0.0), 1.0 + v]
    return [v, v]


def _per_sample(x: torch.Tensor) -> torch.Tensor:
    return x.view(-1, 1, 1, 1)


def contrast_blend(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """torchvision ``adjust_contrast``: blend each sample with the mean of
    its grayscale (ITU-R 601 luma for 3 channels), clamp to [0, 1]."""
    if images.shape[-1] == 3:
        gray = 0.2989 * images[..., 0] + 0.587 * images[..., 1] + 0.114 * images[..., 2]
    else:
        gray = images.mean(-1)
    mean = _per_sample(gray.mean((1, 2)))
    f = _per_sample(factor)
    return torch.clamp(f * images + (1.0 - f) * mean, 0.0, 1.0)


class RandomGamma(Transform):
    """``image ** gamma``, gamma ~ U(range)."""

    def __init__(self, gamma):
        self.gamma = _as_range(gamma)

    def draw(self, gen, shape, device):
        return {"gamma": uniform(gen, shape[0], *self.gamma, device)}

    def apply(self, params, images, labels):
        return torch.pow(images, _per_sample(params["gamma"])), labels

    def get_params_dict(self):
        return {"RandomGamma": {"gamma": self.gamma}}


class RandomContrast(Transform):
    """ColorJitter(contrast): factor ~ U(max(1-c, 0), 1+c)."""

    def __init__(self, contrast):
        self.contrast = _as_range(contrast, centered=True)

    def draw(self, gen, shape, device):
        return {"factor": uniform(gen, shape[0], *self.contrast, device)}

    def apply(self, params, images, labels):
        return contrast_blend(images, params["factor"]), labels

    def get_params_dict(self):
        return {"RandomContrast": {"contrast": self.contrast}}


class RandomBrightness(Transform):
    """The reference's ``RandomBrightness`` applies CONTRAST (it builds
    ``ColorJitter(contrast=brightness)``); the JAX package keeps that as
    ``contrast_compat=True``, the only setting its recipes use, and so does
    this port."""

    def __init__(self, brightness):
        self.brightness = _as_range(brightness, centered=True)

    def draw(self, gen, shape, device):
        return {"factor": uniform(gen, shape[0], *self.brightness, device)}

    def apply(self, params, images, labels):
        return contrast_blend(images, params["factor"]), labels

    def get_params_dict(self):
        return {"RandomBrightness": {"brightness": self.brightness, "contrast_compat": True}}


class RandomGaussianNoise(Transform):
    """Additive N(0, sigma), sigma ~ U(range), clamp [0, 1]. The unit
    noise array is a drawn parameter (``params["noise"]``)."""

    def __init__(self, sigma):
        self.sigma = _as_range(sigma)

    def draw(self, gen, shape, device):
        sigma = uniform(gen, shape[0], *self.sigma, device)
        noise = torch.randn(shape, generator=gen, device=device)
        return {"sigma": sigma, "noise": noise}

    def apply(self, params, images, labels):
        out = images + _per_sample(params["sigma"]) * params["noise"]
        return torch.clamp(out, 0.0, 1.0), labels

    def get_params_dict(self):
        return {"RandomGaussianNoise": {"sigma": self.sigma}}


def _round_to_odd(x: float) -> int:
    c = math.ceil(x)
    return c if c % 2 else c - 1


class RandomGaussianBlur(Transform):
    """sigma ~ U(range); kernel = odd(ceil(4*sigma + 0.5)); the static
    maximum kernel comes from the top of the sigma range."""

    def __init__(self, sigma):
        self.sigma = _as_range(sigma)
        self.max_kernel = _round_to_odd(self.sigma[1] * 4.0 + 0.5)

    def draw(self, gen, shape, device):
        sigma = uniform(gen, shape[0], *self.sigma, device)
        c = torch.ceil(4.0 * sigma + 0.5)
        kernel = torch.where(torch.remainder(c, 2) == 1, c, c - 1).to(torch.int64)
        return {"sigma": sigma, "kernel": kernel}

    def apply(self, params, images, labels):
        out = gaussian_blur(
            images, params["sigma"], params["kernel"], max_kernel_size=self.max_kernel
        )
        return out, labels

    def get_params_dict(self):
        return {"RandomGaussianBlur": {"sigma": self.sigma}}


class SimulateLowRes(Transform):
    """Per-axis scale ~ U(range): nearest-exact down, bilinear up."""

    def __init__(self, scale):
        self.scale = _as_range(scale)

    def draw(self, gen, shape, device):
        return {"scales": uniform(gen, (shape[0], 2), *self.scale, device)}

    def apply(self, params, images, labels):
        return simulate_low_res(images, params["scales"]), labels

    def get_params_dict(self):
        return {"SimulateLowRes": {"scale": self.scale}}
