"""LayerNorm fused with the window partition — kernel K4 and its plain version.

Counterpart of ``mia_tpu/ops/ln_window.py``. Layout is the JAX package's,
channel-last: ``x (B, H, W, C)`` → windows ``(B·nW, ws, ws, C)`` in
``window_partition``'s order, pad slots zero.

- :func:`layer_norm` — flax's LayerNorm arithmetic (fast variance
  ``max(E[x²] − μ², 0)``, ``y = (x − μ)·(rsqrt(σ² + ε)·scale) + bias``).
- :func:`window_partition` — zero-pad to whole windows and partition.
- :func:`ln_window_partition` — the plain PyTorch version (any device):
  LayerNorm, then pad with zeros, then partition.
- :func:`ln_window_partition_fused` — the wrapper of the CUDA kernel
  ``csrc/ln_window.cu``, which replaces the TPU kernel
  ``mia_tpu/ops/ln_window.py::ln_window_partition``. A CUDA tensor launches
  the kernel (or raises); a CPU tensor takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in flax's operation order."""
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return (x - mu) * (torch.rsqrt(var + eps) * weight) + bias


def window_partition(x: torch.Tensor, window_size: int):
    """(B, H, W, C) → ((B·nW, ws, ws, C), (Hp, Wp)) with zero padding."""
    b, h, w, c = x.shape
    ws = window_size
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def ln_window_partition(x, scale, bias, window_size: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain ``window_partition(LayerNorm(x))``: pad slots are 0, not ``bias``."""
    return window_partition(layer_norm(x, scale, bias, eps), window_size)[0]


_K4_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]


@functools.cache
def _k4_function():
    fn = load_library().mia_ln_window_partition_f32
    fn.argtypes = _K4_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _launch_k4(x, scale, bias, window_size: int, eps: float) -> torch.Tensor:
    """Launch the CUDA kernel; raise on anything it does not take."""
    if x.device.type != "cuda":
        raise ValueError(f"K4 needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous() or x.dim() != 4:
        raise ValueError("K4 needs a contiguous float32 (B, H, W, C) tensor")
    b, h, w, c = x.shape
    for name, p in (("scale", scale), ("bias", bias)):
        if (p.dtype != torch.float32 or p.device != x.device or tuple(p.shape) != (c,)
                or not p.is_contiguous()):
            raise ValueError(f"K4 {name} must be a contiguous float32 ({c},) tensor on {x.device}")
    ws = int(window_size)
    if ws <= 0:
        raise ValueError(f"K4 window size must be positive, got {ws}")
    nwy, nwx = -(-h // ws), -(-w // ws)
    if max(b, h, w, c, b * nwy * nwx * ws * ws) >= 2 ** 31:
        raise ValueError(f"K4 shape {tuple(x.shape)} overflows int32 sizes")
    out = torch.empty((b * nwy * nwx, ws, ws, c), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _k4_function()(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
                             b, h, w, c, ws, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    ln_window_partition_fused.launches += 1
    return out


def ln_window_partition_fused(x, scale, bias, window_size: int, eps: float = 1e-6) -> torch.Tensor:
    """K4: ``window_partition(LayerNorm(x))`` of float32 ``(B, H, W, C)``.

    A CUDA tensor launches ``csrc/ln_window.cu`` (and raises if it cannot);
    a CPU tensor takes the plain version. ``launches`` counts kernel launches.
    """
    if x.device.type == "cpu":
        return ln_window_partition(x, scale, bias, window_size, eps)
    return _launch_k4(x, scale, bias, window_size, eps)


ln_window_partition_fused.launches = 0
