"""Separable resize matrices (numpy, host-side).

Copied from ``mia_tpu/ops/resize.py`` (``_nearest_index``,
``_resize_matrix``), whose module imports JAX. The eval pipeline applies
these ``(out, in)`` matrices on the device as two matmuls, with semantics
of torchvision ``F.resize``: antialiased (PIL-style triangle) or plain
bilinear, asymmetric nearest, nearest-exact.
"""

from __future__ import annotations

import functools

import numpy as np


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
