"""Affine warps: the direct gather, and the split-rounding nearest warp —
kernel K1 and its plain version.

Counterpart of ``mia_tpu/ops/warp.py``. Layout is the JAX package's,
channel-last, with the batch written out instead of ``vmap``: images
``(B, H, W, C)``, output→input pixel matrices ``(B, 2, 3)``.

- :func:`affine_inverse_matrix` — torchvision's inverse affine matrix.
- :func:`affine_warp` / :func:`rotate_warp` — the direct gather (nearest or
  bilinear, zero fill) that the acdc/thyroid recipe warps with. Plain
  PyTorch, as it is plain XLA in the JAX package; it does not go through
  K1, whose split rounding can land one source pixel away under rotation.
- :func:`_warp_shift2pass_indices` — the split-rounding index vectors.
- :func:`affine_warp_shift2pass` — the plain PyTorch version (any device).
- :func:`affine_warp_shift2pass_fused` — the wrapper of the CUDA kernel
  ``csrc/affine_warp.cu``, which replaces the TPU kernel
  ``mia_tpu/ops/warp.py::affine_warp_pallas``. A CUDA tensor launches the
  kernel (or raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library


def affine_inverse_matrix(
    angle_deg: torch.Tensor,
    translate: torch.Tensor,
    scale: torch.Tensor,
    shear_deg: torch.Tensor,
    center: tuple[float, float],
) -> torch.Tensor:
    """Batched output-pixel → input-pixel ``(B, 2, 3)`` matrices.

    ``angle_deg``/``scale`` are ``(B,)``; ``translate``/``shear_deg`` are
    ``(B, 2)`` in (x, y) order; ``center`` is (x, y) pixels. Computes the
    inverse of ``T(translate) C RotateShearScale C^-1`` like torchvision's
    ``_get_inverse_affine_matrix``, in float32.
    """
    f32 = torch.float32
    rot = torch.deg2rad(angle_deg.to(f32))
    sx = torch.deg2rad(shear_deg[:, 0].to(f32))
    sy = torch.deg2rad(shear_deg[:, 1].to(f32))
    cx, cy = center
    tx, ty = translate[:, 0].to(f32), translate[:, 1].to(f32)

    a = torch.cos(rot - sy) / torch.cos(sy)
    b = -torch.cos(rot - sy) * torch.tan(sx) / torch.cos(sy) - torch.sin(rot)
    c = torch.sin(rot - sy) / torch.cos(sy)
    d = -torch.sin(rot - sy) * torch.tan(sx) / torch.cos(sy) + torch.cos(rot)

    inv_scale = 1.0 / scale.to(f32)
    m00, m01 = d * inv_scale, -b * inv_scale
    m10, m11 = -c * inv_scale, a * inv_scale
    m02 = m00 * (-cx - tx) + m01 * (-cy - ty) + cx
    m12 = m10 * (-cx - tx) + m11 * (-cy - ty) + cy
    return torch.stack(
        [torch.stack([m00, m01, m02], -1), torch.stack([m10, m11, m12], -1)], -2
    )


def _source_coords(matrices: torch.Tensor, h: int, w: int):
    """``(B, H, W)`` source x and y of every output pixel, in the JAX order
    ``m00·x + m01·y + m02`` (a multiply and two adds, no fused multiply-add,
    so exact .5 ties round as they do there)."""
    m = matrices.to(torch.float32)[:, :, :, None, None]
    ys = torch.arange(h, dtype=torch.float32, device=m.device)[:, None]
    xs = torch.arange(w, dtype=torch.float32, device=m.device)[None, :]
    src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
    src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
    return src_x, src_y


def _gather(images: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor):
    """``images[b, yi, xi]`` for ``(B, H', W')`` int indices (clamped), and
    the mask of indices inside the source."""
    bsz, h, w, c = images.shape
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = yi.clamp(0, h - 1).long() * w + xi.clamp(0, w - 1).long()
    idx = flat.view(bsz, -1, 1).expand(-1, -1, c)
    v = torch.gather(images.reshape(bsz, h * w, c), 1, idx).view(*xi.shape, c)
    return v, valid[..., None]


def affine_warp(images: torch.Tensor, matrices: torch.Tensor,
                method: str = "bilinear") -> torch.Tensor:
    """Warp ``(B, H, W, C)`` by output→input ``(B, 2, 3)`` matrices with a
    direct gather, zero fill outside the source.

    ``nearest`` rounds half to even (``torch.round``, like ``jnp.round``) and
    keeps the input dtype; ``bilinear`` sums the four taps in the JAX
    order in float32 and casts back to a floating input dtype.
    """
    if images.dim() != 4 or tuple(matrices.shape) != (images.shape[0], 2, 3):
        raise ValueError(
            f"expected (B, H, W, C) images and (B, 2, 3) matrices, got "
            f"{tuple(images.shape)} and {tuple(matrices.shape)}"
        )
    _, h, w, _ = images.shape
    src_x, src_y = _source_coords(matrices, h, w)
    if method == "nearest":
        v, valid = _gather(images, torch.round(src_x).to(torch.int32),
                           torch.round(src_y).to(torch.int32))
        return torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
    if method != "bilinear":
        raise ValueError(f"unknown warp method: {method}")
    image = images.to(torch.float32)
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    wx, wy = src_x - x0, src_y - y0
    x0i, y0i = x0.to(torch.int32), y0.to(torch.int32)
    out = None
    for dy, wy_ in ((0, 1.0 - wy), (1, wy)):
        for dx, wx_ in ((0, 1.0 - wx), (1, wx)):
            v, valid = _gather(image, x0i + dx, y0i + dy)
            v = torch.where(valid, v, torch.zeros((), device=v.device))
            term = v * (wx_ * wy_)[..., None]
            out = term if out is None else out + term
    return out.to(images.dtype) if images.dtype.is_floating_point else out


def rotate_warp(images: torch.Tensor, angle_deg: torch.Tensor,
                method: str = "bilinear") -> torch.Tensor:
    """torchvision ``F.rotate`` without expand: rotate each ``(H, W, C)``
    image by its ``(B,)`` angle about the centre pixel."""
    bsz, h, w, _ = images.shape
    angle = angle_deg.to(torch.float32).reshape(bsz)
    zeros = torch.zeros(bsz, 2, dtype=torch.float32, device=angle.device)
    m = affine_inverse_matrix(angle, zeros, torch.ones_like(angle), zeros,
                              ((w - 1) * 0.5, (h - 1) * 0.5))
    return affine_warp(images, m, method)


def _warp_shift2pass_indices(matrix: torch.Tensor, h: int, w: int):
    """Per-sample int32 index vectors of the split-rounding warp.

    ``round(a*x + b*i + c)`` is split into ``round(a*x + c) + round(b*i)``
    (exact for axis-aligned maps, within one source pixel of the unsplit
    rounding otherwise). ``torch.round`` rounds half to even, like
    ``jnp.round``. Returns ``ts (B, h)`` per-source-row column shift,
    ``m1 (B, w)`` shared column map, ``us (B, w)`` per-column row shift and
    ``m2 (B, h)`` shared row map.
    """
    m = matrix.to(torch.float32)
    m00, m01, m02 = m[:, 0, 0:1], m[:, 0, 1:2], m[:, 0, 2:3]
    m10, m11, m12 = m[:, 1, 0:1], m[:, 1, 1:2], m[:, 1, 2:3]
    safe_m11 = torch.where(m11.abs() < 1e-3, torch.full_like(m11, 1e-3), m11)
    b = m01 / safe_m11
    a = m00 - b * m10
    c = m02 - b * m12
    ii = torch.arange(h, dtype=torch.float32, device=m.device)[None, :]
    xx = torch.arange(w, dtype=torch.float32, device=m.device)[None, :]
    i32 = torch.int32
    ts = torch.round(b * ii).to(i32)
    m1 = torch.round(a * xx + c).to(i32)
    us = torch.round(m10 * xx).to(i32)
    m2 = torch.round(m11 * ii + m12).to(i32)
    return ts, m1, us, m2


def _shift2pass_gather(images, ts, m1, us, m2):
    """Plain gather form of the kernel's algebra on float32 ``(B,H,W,C)``."""
    bsz, h, w, c = images.shape
    r = m2[:, :, None] + us[:, None, :]  # (B, H_out, W_out) source row
    r_ok = (r >= 0) & (r < h)
    r = r.clamp(0, h - 1).long()
    s = m1[:, None, :] + torch.gather(ts, 1, r.view(bsz, -1)).view(bsz, h, w)
    ok = r_ok & (s >= 0) & (s < w)
    flat = (r * w + s.clamp(0, w - 1).long()).view(bsz, h * w, 1).expand(-1, -1, c)
    out = torch.gather(images.reshape(bsz, h * w, c), 1, flat).view(bsz, h, w, c)
    return torch.where(ok[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def affine_warp_shift2pass(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch split-rounding nearest warp of ``(B, H, W, C)``.

    Same sampling as ``mia_tpu.ops.warp.affine_warp_shift2pass`` (and so as
    the TPU kernel): float inputs keep their dtype, integer inputs are
    rounded back. Zero fill outside the source.
    """
    _, h, w, _ = images.shape
    ts, m1, us, m2 = _warp_shift2pass_indices(matrices, h, w)
    out = _shift2pass_gather(images.to(torch.float32), ts, m1, us, m2)
    if images.dtype.is_floating_point:
        return out.to(images.dtype)
    return torch.round(out).to(images.dtype)


_K1_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.cache
def _k1_function():
    fn = load_library().mia_affine_warp_shift2pass_f32
    fn.argtypes = _K1_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_k1(images, ts, m1, us, m2) -> torch.Tensor:
    """Launch the CUDA kernel; raise on anything it does not take."""
    if images.device.type != "cuda":
        raise ValueError(f"K1 needs a CUDA tensor, got {images.device}")
    if images.dtype != torch.float32 or not images.is_contiguous():
        raise ValueError("K1 needs a contiguous float32 (B, H, W, C) tensor")
    bsz, h, w, c = images.shape
    for name, vec, n in (("ts", ts, h), ("m1", m1, w), ("us", us, w), ("m2", m2, h)):
        if (vec.dtype != torch.int32 or vec.device != images.device
                or tuple(vec.shape) != (bsz, n) or not vec.is_contiguous()):
            raise ValueError(f"K1 index vector {name} must be contiguous int32 {(bsz, n)}")
    if max(bsz * h, bsz * w, h, w, c) >= 2 ** 31:
        raise ValueError(f"K1 shape {tuple(images.shape)} overflows int32 sizes")
    out = torch.empty_like(images)
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream(images.device).cuda_stream
        err = _k1_function()(
            images.data_ptr(), ts.data_ptr(), m1.data_ptr(), us.data_ptr(),
            m2.data_ptr(), out.data_ptr(), bsz, h, w, c, stream,
        )
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    affine_warp_shift2pass_fused.launches += 1
    return out


def affine_warp_shift2pass_fused(images: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """K1: split-rounding nearest warp of float32 ``(B, H, W, C)`` by
    ``(B, 2, 3)`` matrices.

    A CUDA tensor launches ``csrc/affine_warp.cu`` (and raises if it cannot);
    a CPU tensor takes the plain gather. ``launches`` counts kernel launches.
    """
    if images.dim() != 4 or tuple(matrices.shape) != (images.shape[0], 2, 3):
        raise ValueError(
            f"expected (B, H, W, C) images and (B, 2, 3) matrices, got "
            f"{tuple(images.shape)} and {tuple(matrices.shape)}"
        )
    _, h, w, _ = images.shape
    ts, m1, us, m2 = _warp_shift2pass_indices(matrices, h, w)
    if images.device.type == "cpu":
        return _shift2pass_gather(images.to(torch.float32), ts, m1, us, m2)
    return _launch_k1(images, ts, m1, us, m2)


affine_warp_shift2pass_fused.launches = 0
