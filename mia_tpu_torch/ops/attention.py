"""Rel-pos attention on the packed qkv layout — kernels K2 and K3 and their
plain versions.

Counterpart of the packed paths of ``mia_tpu/ops/attention.py``. ``qkv`` is
the qkv Linear's output ``(B', N, 3·H·D)`` in ``(3, heads, head_dim)``
order; the context comes back as ``(B', N, H·D)``, head ``h`` at columns
``[h·D, (h+1)·D)``, ready for the proj Linear. Both compute
``softmax(q·kᵀ·scale + rel_h[n, k // k_w] + rel_w[n, k % k_w])·v`` in
float32, with the rel terms taken from the unscaled q.

- :func:`attention_rel_packed` — plain K3: rel terms arrive head-major as
  ``(B'·H, N, k_h)`` and ``(B'·H, N, k_w)`` (global blocks).
- :func:`attention_rel_packed_ik` — plain K2: rel terms computed from the
  gathered ``(q_h·k_h, D)`` and ``(k_w·k_w, D)`` tables, shared across
  heads (windowed blocks).
- :func:`fused_attention_rel_packed` and
  :func:`fused_attention_rel_packed_ik` — the wrappers of the CUDA kernels
  in ``csrc/attention_rel.cu``, which replace the TPU kernels of the same
  names. A CUDA tensor launches the kernel (or raises); a CPU tensor takes
  the plain version. Each wrapper counts its launches in ``launches``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library

KERNEL_HEAD_DIMS = (64, 80)  # head dims csrc/attention_rel.cu is built for (ViT-B/L, ViT-H)


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    b, n, three_hd = qkv.shape
    if three_hd % (3 * num_heads):
        raise ValueError(f"qkv width {three_hd} is not 3·heads·D for heads={num_heads}")
    return three_hd // (3 * num_heads)


def attention_rel_packed(qkv, rel_h, rel_w, scale: float, k_hw, num_heads: int) -> torch.Tensor:
    """Plain K3: ``(B, N, 3·H·D)`` packed qkv + head-major rel terms →
    ``(B, N, H·D)``."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    if n != k_h * k_w:
        raise ValueError(f"token count {n} != k_h*k_w {k_h * k_w}")
    d = _head_dim(qkv, num_heads)
    q, k, v = qkv.view(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (B, H, N, D) each
    attn = (q * scale) @ k.transpose(-2, -1)
    bias = rel_h.view(b, num_heads, n, k_h, 1) + rel_w.view(b, num_heads, n, 1, k_w)
    attn = (attn + bias.view(b, num_heads, n, n)).softmax(-1)
    return (attn @ v).transpose(1, 2).reshape(b, n, num_heads * d)


def window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads: int):
    """The rel terms K2 computes in the kernel, head-major:
    ``rel_h[n, j] = q_n·rh_flat[y_n·k_h + j]``,
    ``rel_w[n, j] = q_n·rw_flat[x_n·k_w + j]`` with ``y_n, x_n = divmod(n, k_w)``."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    q_h = n // k_w
    q5 = qkv[..., : num_heads * d].reshape(b, q_h, k_w, num_heads, d)
    rel_h = torch.einsum("byxhc,ykc->bhyxk", q5, rh_flat.view(q_h, k_h, d))
    rel_w = torch.einsum("byxhc,xkc->bhyxk", q5, rw_flat.view(k_w, k_w, d))
    return rel_h.reshape(b * num_heads, n, k_h), rel_w.reshape(b * num_heads, n, k_w)


def attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale: float, k_hw, num_heads: int) -> torch.Tensor:
    """Plain K2: packed qkv + gathered rel tables → ``(B, N, H·D)``."""
    rel_h, rel_w = window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads)
    return attention_rel_packed(qkv, rel_h, rel_w, scale, k_hw, num_heads)


@functools.cache
def _kernel_function(name: str):
    fn = getattr(load_library(), name)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_operand(label: str, t: torch.Tensor, shape, device) -> None:
    if (t.dtype != torch.float32 or t.device != device or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"{label} must be a contiguous, 16-byte aligned float32 {tuple(shape)} tensor "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _launch(label, symbol, qkv, rel_a, rel_b, a_shape, b_shape, scale, k_hw, num_heads):
    if qkv.device.type != "cuda":
        raise ValueError(f"{label} needs a CUDA tensor, got {qkv.device}")
    b, n, three_hd = qkv.shape
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{label} is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    if n != k_h * k_w:
        raise ValueError(f"{label}: token count {n} != k_h*k_w {k_h * k_w}")
    if b >= 65536 or num_heads >= 65536 or b * n * three_hd >= 2 ** 31:
        raise ValueError(f"{label}: qkv shape {tuple(qkv.shape)} exceeds the launch grid or int32")
    _check_operand(f"{label} qkv", qkv, qkv.shape, qkv.device)
    _check_operand(f"{label} rel operand", rel_a, a_shape, qkv.device)
    _check_operand(f"{label} rel operand", rel_b, b_shape, qkv.device)
    out = torch.empty((b, n, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _kernel_function(symbol)(
            qkv.data_ptr(), rel_a.data_ptr(), rel_b.data_ptr(), out.data_ptr(),
            b, n, num_heads, d, k_h, k_w, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"{label} launch failed: cudaError {err}")
    return out


def _launch_k2(qkv, rh_flat, rw_flat, scale, k_hw, num_heads) -> torch.Tensor:
    """Launch K2 (``mia_attention_rel_packed_ik_f32``); raise on anything it
    does not take."""
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    q_h = qkv.shape[1] // k_w
    out = _launch("K2", "mia_attention_rel_packed_ik_f32", qkv, rh_flat, rw_flat,
                  (q_h * k_h, d), (k_w * k_w, d), scale, k_hw, num_heads)
    fused_attention_rel_packed_ik.launches += 1
    return out


def _launch_k3(qkv, rel_h, rel_w, scale, k_hw, num_heads) -> torch.Tensor:
    """Launch K3 (``mia_attention_rel_packed_f32``); raise on anything it
    does not take."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    out = _launch("K3", "mia_attention_rel_packed_f32", qkv, rel_h, rel_w,
                  (b * num_heads, n, k_h), (b * num_heads, n, k_w), scale, k_hw, num_heads)
    fused_attention_rel_packed.launches += 1
    return out


def fused_attention_rel_packed(qkv, rel_h, rel_w, scale: float, k_hw, num_heads: int) -> torch.Tensor:
    """K3: global rel-pos attention with precomputed head-major rel terms.

    A CUDA tensor launches ``csrc/attention_rel.cu`` (and raises if it
    cannot); a CPU tensor takes :func:`attention_rel_packed`.
    """
    if qkv.device.type == "cpu":
        return attention_rel_packed(qkv, rel_h, rel_w, scale, k_hw, num_heads)
    return _launch_k3(qkv, rel_h, rel_w, scale, k_hw, num_heads)


def fused_attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale: float, k_hw,
                                  num_heads: int) -> torch.Tensor:
    """K2: windowed rel-pos attention with the rel terms computed in the kernel.

    A CUDA tensor launches ``csrc/attention_rel.cu`` (and raises if it
    cannot); a CPU tensor takes :func:`attention_rel_packed_ik`.
    """
    if qkv.device.type == "cpu":
        return attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale, k_hw, num_heads)
    return _launch_k2(qkv, rh_flat, rw_flat, scale, k_hw, num_heads)


fused_attention_rel_packed.launches = 0
fused_attention_rel_packed_ik.launches = 0
