"""Window unpartition + residual add + LayerNorm — kernel K9 and its plain
version.

Counterpart of ``mia_tpu/ops/unpartition_residual.py``. Every windowed
encoder block ends with ``x = shortcut + window_unpartition(attn_out)`` and
``y = LayerNorm(x)`` feeding the MLP; the fused form keeps the attention
block's output partitioned and produces both in one pass.

- :func:`unpartition_add_ln_plain` — the plain PyTorch version (any
  device): unpartition (pad slots dropped), add, LayerNorm in flax's
  operation order (``ops/ln_window.py::layer_norm``).
- :func:`unpartition_add_ln` — the wrapper of the CUDA kernel
  ``csrc/unpartition_residual.cu``, which replaces the TPU kernel of the
  same name. A CUDA tensor launches the kernel (or raises); a CPU tensor
  takes the plain version. The kernel is forward only: a CUDA tensor that
  needs a gradient raises ``NotImplementedError`` (the backward kernel is
  not ported yet); on the CPU the plain version is differentiable.
  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library
from .ln_window import layer_norm, window_unpartition


def unpartition_add_ln_plain(windows, shortcut, scale, bias, window_size: int, eps: float = 1e-6):
    """Plain K9: ``windows (B·nW, ws, ws, C)``, ``shortcut (B, H, W, C)`` →
    ``(x_new, y)``, both ``(B, H, W, C)``."""
    x_new = shortcut + window_unpartition(windows, window_size, shortcut.shape[1:3])
    return x_new, layer_norm(x_new, scale, bias, eps)


@functools.cache
def _k9_function():
    fn = load_library().mia_unpartition_add_ln_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_k9(windows, shortcut, scale, bias, window_size: int, eps: float = 1e-6):
    """Launch the CUDA kernel; raise on anything it does not take."""
    if shortcut.device.type != "cuda":
        raise ValueError(f"K9 needs a CUDA tensor, got {shortcut.device}")
    if shortcut.dtype != torch.float32 or not shortcut.is_contiguous() or shortcut.dim() != 4:
        raise ValueError("K9 needs a contiguous float32 (B, H, W, C) shortcut")
    b, h, w, c = shortcut.shape
    ws = int(window_size)
    if ws <= 0:
        raise ValueError(f"K9 window size must be positive, got {ws}")
    n_win = b * -(-h // ws) * -(-w // ws)
    for name, t, shape in (("windows", windows, (n_win, ws, ws, c)), ("scale", scale, (c,)),
                           ("bias", bias, (c,))):
        if (t.dtype != torch.float32 or t.device != shortcut.device or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"K9 {name} must be a contiguous float32 {shape} tensor on "
                             f"{shortcut.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    if max(b, h, w, c) >= 2 ** 31 or windows.numel() >= 2 ** 62:
        raise ValueError(f"K9 shape {tuple(shortcut.shape)} overflows the kernel's sizes")
    x_new, y = torch.empty_like(shortcut), torch.empty_like(shortcut)
    with torch.cuda.device(shortcut.device):
        stream = torch.cuda.current_stream(shortcut.device).cuda_stream
        err = _k9_function()(windows.data_ptr(), shortcut.data_ptr(), scale.data_ptr(),
                             bias.data_ptr(), x_new.data_ptr(), y.data_ptr(), b, h, w, c, ws,
                             float(eps), stream)
    if err != 0:
        raise RuntimeError(f"K9 launch failed: cudaError {err}")
    unpartition_add_ln.launches += 1
    return x_new, y


def unpartition_add_ln(windows, shortcut, scale, bias, window_size: int, eps: float = 1e-6):
    """K9: ``x_new = shortcut + window_unpartition(windows)``,
    ``y = LayerNorm(x_new)``; returns ``(x_new, y)``.

    ``windows`` is the attention block's output still in the partitioned
    ``(B·nW, ws, ws, C)`` layout (pad-slot values are ignored), ``shortcut``
    the ``(B, H, W, C)`` residual stream, ``scale``/``bias`` norm2's
    parameters. A CUDA tensor launches ``csrc/unpartition_residual.cu`` (or
    raises; forward only); a CPU tensor takes the plain version.
    """
    if shortcut.device.type == "cpu":
        return unpartition_add_ln_plain(windows, shortcut, scale, bias, window_size, eps)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (windows, shortcut, scale, bias)):
        raise NotImplementedError(
            "unpartition_add_ln (K9) has no backward kernel yet: its CUDA kernel is forward "
            "only, so a CUDA tensor that needs a gradient cannot take this route")
    return _launch_k9(windows.contiguous(), shortcut.contiguous(), scale, bias, window_size, eps)


unpartition_add_ln.launches = 0
