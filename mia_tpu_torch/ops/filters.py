"""Smoothing / degradation filters of the augmentation pipeline, batched.

Counterpart of ``mia_tpu/ops/filters.py``. The JAX functions take one
``(H, W, C)`` image and are vmapped; these take ``(B, H, W, C)`` with one
parameter per sample:

- ``gaussian_blur``: torchvision ``F.gaussian_blur`` semantics (reflect
  padding, truncated + normalised kernel) with a static maximum radius and a
  per-sample effective kernel size.
- ``simulate_low_res``: nearest-exact downsample to a per-sample low-res
  size, then bilinear (align_corners=False) upsample back, as one gather
  and blend per axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def gaussian_blur(
    images: torch.Tensor,
    sigma: torch.Tensor,
    kernel_size: torch.Tensor,
    max_kernel_size: int = 13,
) -> torch.Tensor:
    """Blur ``(B, H, W, C)`` with per-sample ``sigma`` and odd
    ``kernel_size`` (both ``(B,)``), separable, reflect padding."""
    max_radius = (int(max_kernel_size) - 1) // 2
    offsets = torch.arange(
        -max_radius, max_radius + 1, dtype=torch.float32, device=images.device
    )
    sigma = sigma.to(torch.float32).clamp_min(1e-12)[:, None]
    radius = ((kernel_size.to(torch.int64) - 1) // 2)[:, None]
    wts = torch.exp(-0.5 * (offsets[None] / sigma) ** 2)
    wts = torch.where(offsets[None].abs() <= radius, wts, torch.zeros_like(wts))
    wts = wts / wts.sum(1, keepdim=True)  # (B, K)

    x = images.to(torch.float32).permute(0, 3, 1, 2)  # (B, C, H, W) view
    h, w = x.shape[2], x.shape[3]
    taps = 2 * max_radius + 1
    wb = wts[:, None, None, :]  # (B, 1, 1, K)
    xp = F.pad(x, (0, 0, max_radius, max_radius), mode="reflect")
    out = torch.zeros_like(x)
    for k in range(taps):
        out = out + wb[..., k : k + 1] * xp[:, :, k : k + h, :]
    xp = F.pad(out, (max_radius, max_radius, 0, 0), mode="reflect")
    out = torch.zeros_like(x)
    for k in range(taps):
        out = out + wb[..., k : k + 1] * xp[:, :, :, k : k + w]
    out = out.permute(0, 2, 3, 1).contiguous()
    return out.to(images.dtype) if images.dtype.is_floating_point else out


def _lowres_axis_indices(size: int, low_size: torch.Tensor):
    """Per-sample index/weight ``(B, size)`` arrays for
    down(nearest-exact, low_size) + up(bilinear)."""
    low = low_size.to(torch.float32)[:, None]
    i = torch.arange(size, dtype=torch.float32, device=low.device)[None, :]
    src = (i + 0.5) * low / size - 0.5
    j0 = torch.floor(src)
    frac = src - j0
    max_j = low - 1.0
    zero = torch.zeros((), device=low.device)
    j0c = torch.minimum(torch.maximum(j0, zero), max_j)
    j1c = torch.minimum(torch.maximum(j0 + 1.0, zero), max_j)

    def to_orig(j):
        o = torch.floor((j + 0.5) * size / low)
        return o.clamp(0.0, size - 1.0).to(torch.int64)

    return to_orig(j0c), to_orig(j1c), frac


def simulate_low_res(images: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Degrade ``(B, H, W, C)`` by per-sample, per-axis factors
    ``scales (B, 2)``: ``low = floor(scale * size)`` (at least 1),
    nearest-exact down then bilinear up."""
    bsz, h, w, c = images.shape
    scales = scales.to(torch.float32)
    low_h = torch.floor(scales[:, 0] * h).clamp_min(1.0)
    low_w = torch.floor(scales[:, 1] * w).clamp_min(1.0)
    x = images.to(torch.float32)

    i0, i1, fy = _lowres_axis_indices(h, low_h)
    g0 = torch.gather(x, 1, i0[:, :, None, None].expand(bsz, h, w, c))
    g1 = torch.gather(x, 1, i1[:, :, None, None].expand(bsz, h, w, c))
    fy = fy[:, :, None, None]
    x = g0 * (1.0 - fy) + g1 * fy

    j0, j1, fx = _lowres_axis_indices(w, low_w)
    g0 = torch.gather(x, 2, j0[:, None, :, None].expand(bsz, h, w, c))
    g1 = torch.gather(x, 2, j1[:, None, :, None].expand(bsz, h, w, c))
    fx = fx[:, None, :, None]
    x = g0 * (1.0 - fx) + g1 * fx
    return x.to(images.dtype) if images.dtype.is_floating_point else x
