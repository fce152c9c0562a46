"""Separable resize: ``(out, in)`` matrices built with numpy, applied on the
device as two matmuls.

Copied from ``mia_tpu/ops/resize.py`` (``_nearest_index``,
``_resize_matrix``, ``resize``, ``resize_longest_side``), whose module
imports JAX. Semantics of
torchvision ``F.resize``: antialiased (PIL-style triangle) or plain
bilinear, asymmetric nearest, nearest-exact. Arrays are channel-last,
``(..., H, W, C)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _nearest_index(out_size: int, in_size: int, exact: bool) -> np.ndarray:
    scale = in_size / out_size
    i = np.arange(out_size, dtype=np.float64)
    if exact:
        src = np.floor((i + 0.5) * scale)
    else:
        src = np.floor(i * scale)
    return np.clip(src, 0, in_size - 1).astype(np.int32)


@functools.lru_cache(maxsize=256)
def _resize_matrix(
    out_size: int, in_size: int, method: str, antialias: bool
) -> np.ndarray:
    """(out_size, in_size) row-stochastic interpolation matrix."""
    if method in ("nearest", "nearest_exact"):
        idx = _nearest_index(out_size, in_size, method == "nearest_exact")
        mat = np.zeros((out_size, in_size), dtype=np.float32)
        mat[np.arange(out_size), idx] = 1.0
        return mat

    if method != "bilinear":
        raise ValueError(f"unknown resize method: {method}")

    scale = in_size / out_size
    support = max(scale, 1.0) if antialias else 1.0
    centers = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    j = np.arange(in_size, dtype=np.float64)
    # Triangle filter evaluated at (j - center) / support, support-clamped.
    x = (j[None, :] - centers[:, None]) / support
    w = np.clip(1.0 - np.abs(x), 0.0, None)
    if not antialias:
        # Border handling: out-of-range taps collapse onto the edge pixel
        # (index clamping), which the plain triangle matrix misses.
        lo = np.clip(np.floor(centers).astype(np.int64), 0, in_size - 1)
        hi = np.clip(np.floor(centers).astype(np.int64) + 1, 0, in_size - 1)
        frac = centers - np.floor(centers)
        w = np.zeros((out_size, in_size), dtype=np.float64)
        np.add.at(w, (np.arange(out_size), lo), 1.0 - frac)
        np.add.at(w, (np.arange(out_size), hi), frac)
    row_sum = w.sum(axis=1, keepdims=True)
    row_sum[row_sum == 0] = 1.0
    return (w / row_sum).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _device_matrix(out_size: int, in_size: int, method: str, antialias: bool,
                   device: torch.device) -> torch.Tensor:
    # a normal tensor even when first asked for under inference mode (SAM serving):
    # a later resize under autograd saves it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(_resize_matrix(out_size, in_size, method, antialias)).to(device)


def resize(image: torch.Tensor, size, method: str = "bilinear", antialias: bool = True) -> torch.Tensor:
    """Resize ``(..., H, W, C)`` to ``(..., size[0], size[1], C)`` on the
    image's device: a float32 matmul over H with the ``(out, in)`` matrix,
    then one over W (cast back to a floating input dtype)."""
    out_h, out_w = int(size[0]), int(size[1])
    in_h, in_w = image.shape[-3], image.shape[-2]
    if (in_h, in_w) == (out_h, out_w):
        return image
    # under torch.export / torch.compile the matrix is a traced constant,
    # which the device cache must not keep for later eager calls
    matrix = _device_matrix.__wrapped__ if torch.compiler.is_compiling() else _device_matrix
    mh = matrix(out_h, in_h, method, antialias, image.device)
    mw = matrix(out_w, in_w, method, antialias, image.device)
    x = torch.einsum("oh,...hwc->...owc", mh, image.to(torch.float32))
    x = torch.einsum("ow,...hwc->...hoc", mw, x)
    return x.to(image.dtype) if image.dtype.is_floating_point else x


def resize_longest_side(image: torch.Tensor, target_length: int,
                        method: str = "bilinear") -> torch.Tensor:
    """SAM-style resize of ``(..., H, W, C)`` so that the longer side equals
    ``target_length`` (upstream ``ResizeLongestSide``'s rounding)."""
    h, w = image.shape[-3], image.shape[-2]
    scale = target_length / max(h, w)
    return resize(image, (int(round(h * scale)), int(round(w * scale))), method=method)
