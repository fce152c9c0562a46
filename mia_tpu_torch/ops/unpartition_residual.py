"""Window unpartition + residual add + LayerNorm — kernels K9 and K9b and
their plain versions.

Counterpart of ``mia_tpu/ops/unpartition_residual.py``. Every windowed
encoder block ends with ``x = shortcut + window_unpartition(attn_out)`` and
``y = LayerNorm(x)`` feeding the MLP; the fused form keeps the attention
block's output partitioned and produces both in one pass.

- :func:`unpartition_add_ln_plain` — the plain PyTorch version (any
  device): unpartition (pad slots dropped), add, LayerNorm in flax's
  operation order (``ops/ln_window.py::layer_norm``).
- :func:`unpartition_add_ln_bwd` — the plain VJP from ``x_new`` and the
  per-token statistics: ``total = dx_new + LayerNorm-VJP(dy)``, returned
  carved into window tiles with zero pad slots (the windows' cotangent) and
  as the grid (the shortcut's), with ``dscale``/``dbias`` only when asked.
- :func:`unpartition_add_ln` — the wrapper of the CUDA kernel
  ``csrc/unpartition_residual.cu``, which replaces the TPU kernel of the
  same name. A CUDA tensor launches the kernel (or raises); a CPU tensor
  takes the plain version. When autograd needs a gradient it runs inside a
  ``torch.autograd.Function`` whose forward also keeps ``mu``/``rstd`` and
  whose backward is :func:`unpartition_add_ln_fused_bwd` (the backward
  kernel K9b of the same file, or the plain VJP on the CPU). ``launches``
  on each wrapper counts kernel launches, ``bf16_launches`` those of the
  bfloat16 instances.

A bfloat16 residual stream (a bfloat16 encoder's) is rounded where the
Pallas kernels round it: the residual add in float32 rounded to bfloat16
before the LayerNorm statistics, ``y`` in float32 rounded once; the
backward in float32 from the widened operands, both cotangents rounded once
to bfloat16, ``mu``, ``rstd``, ``scale``, ``bias`` and their gradients
float32. The kernels' bfloat16 instances (K9·bf16, K9b·bf16) do the same.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library
from .ln_window import layer_norm, layer_norm_stats, window_partition, window_unpartition


def unpartition_add_ln_plain(windows, shortcut, scale, bias, window_size: int, eps: float = 1e-6):
    """Plain K9: ``windows (B·nW, ws, ws, C)``, ``shortcut (B, H, W, C)`` →
    ``(x_new, y)``, both ``(B, H, W, C)`` in the stream's dtype (bfloat16: see
    the module docstring)."""
    joined = window_unpartition(windows, window_size, shortcut.shape[1:3])
    if shortcut.dtype == torch.bfloat16:
        x_new = (shortcut.float() + joined.float()).to(torch.bfloat16)
        return x_new, layer_norm(x_new.float(), scale, bias, eps).to(torch.bfloat16)
    x_new = shortcut + joined
    return x_new, layer_norm(x_new, scale, bias, eps)


def unpartition_add_ln_bwd(x_new, dx_new, dy, mu, rstd, scale, window_size: int,
                           params: bool = True):
    """Plain VJP of K9 (the JAX package's ``_bwd_impl`` semantics) from the
    per-token statistics ``mu``, ``rstd`` ``(B, H, W)``: the cotangents
    ``dx_new`` and ``dy`` ``(B, H, W, C)`` → ``(dwindows, dshortcut, dscale,
    dbias)``; ``dwindows (B·nW, ws, ws, C)`` is zero at the pad slots, the
    last two are None unless ``params``. bfloat16 operands are widened to
    float32 and both cotangents rounded once to bfloat16; ``dscale`` and
    ``dbias`` stay float32."""
    dtype = x_new.dtype
    if dtype == torch.bfloat16:
        x_new, dx_new, dy = x_new.float(), dx_new.float(), dy.float()
    mu, rstd = mu[..., None], rstd[..., None]
    xhat = (x_new - mu) * rstd
    g = dy * scale
    total = dx_new + rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    total = total.to(dtype)
    dwin = window_partition(total, window_size)[0]
    if not params:
        return dwin, total, None, None
    return dwin, total, (dy * xhat).sum((0, 1, 2)), dy.sum((0, 1, 2))


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.cache
def _k9_function(name: str):
    fn = getattr(load_library(), name)
    if "_bwd_" not in name:  # the forward entries
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_k9(label, grid, window_size, **operands):
    """Check a float32 or bfloat16 ``(B, H, W, C)`` grid tensor and the named
    operands (name → (tensor, kind of shape: windows, grid, token or
    channel)): windows and grid operands in the grid's dtype, token and
    channel ones float32; return the sizes."""
    if grid.device.type != "cuda":
        raise ValueError(f"{label} needs a CUDA tensor, got {grid.device}")
    if grid.dtype not in _SUFFIX or not grid.is_contiguous() or grid.dim() != 4:
        raise ValueError(f"{label} needs a contiguous float32 or bfloat16 (B, H, W, C) tensor, "
                         f"got {grid.dtype}")
    b, h, w, c = grid.shape
    ws = int(window_size)
    if ws <= 0:
        raise ValueError(f"{label} window size must be positive, got {ws}")
    n_win = b * -(-h // ws) * -(-w // ws)
    if max(b, h, w, c) >= 2 ** 31 or n_win * ws * ws * c >= 2 ** 62:
        raise ValueError(f"{label} shape {tuple(grid.shape)} overflows the kernel's sizes")
    shapes = {"windows": (n_win, ws, ws, c), "grid": (b, h, w, c), "token": (b, h, w),
              "channel": (c,)}
    for name, (t, kind) in operands.items():
        shape = shapes[kind]
        dtype = grid.dtype if kind in ("windows", "grid") else torch.float32
        if (t.dtype != dtype or t.device != grid.device or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"{label} {name} must be a contiguous {dtype} {shape} tensor on "
                             f"{grid.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
    return b, h, w, c, ws, n_win


def _launch_k9(windows, shortcut, scale, bias, window_size: int, eps: float = 1e-6,
               with_stats: bool = False):
    """Launch the CUDA kernel (``mia_unpartition_add_ln_f32``, or ``_bf16``
    for a bfloat16 stream); raise on anything it does not take.
    ``with_stats`` also returns the float32 per-token ``mu``, ``rstd``
    ``(B, H, W)``."""
    b, h, w, c, ws, _ = _check_k9("K9", shortcut, window_size, windows=(windows, "windows"),
                                  scale=(scale, "channel"), bias=(bias, "channel"))
    x_new, y = torch.empty_like(shortcut), torch.empty_like(shortcut)
    mu = torch.empty((b, h, w), dtype=torch.float32, device=shortcut.device) if with_stats else None
    rstd = torch.empty_like(mu) if with_stats else None
    with torch.cuda.device(shortcut.device):
        stream = torch.cuda.current_stream(shortcut.device).cuda_stream
        err = _k9_function("mia_unpartition_add_ln_" + _SUFFIX[shortcut.dtype])(
            windows.data_ptr(), shortcut.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            x_new.data_ptr(), y.data_ptr(), None if mu is None else mu.data_ptr(),
            None if rstd is None else rstd.data_ptr(), b, h, w, c, ws, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"K9 launch failed: cudaError {err}")
    _count(unpartition_add_ln, shortcut)
    return (x_new, y, mu, rstd) if with_stats else (x_new, y)


_PARAM_CHUNKS = 256  # token chunks of the kernel's dscale/dbias partial sums


def _launch_k9_bwd(x_new, dx_new, dy, mu, rstd, scale, window_size: int, params: bool = True):
    """Launch K9's backward (``mia_unpartition_add_ln_bwd_f32``, or ``_bf16``
    for a bfloat16 stream) → (dwindows, dshortcut in the stream's dtype,
    float32 dscale, dbias), the last two only when ``params``."""
    b, h, w, c, ws, n_win = _check_k9(
        "K9 backward", x_new, window_size, dx_new=(dx_new, "grid"), dy=(dy, "grid"),
        mu=(mu, "token"), rstd=(rstd, "token"), scale=(scale, "channel"))
    dsc = torch.empty_like(x_new)
    dwin = torch.empty((n_win, ws, ws, c), dtype=x_new.dtype, device=x_new.device)
    dscale = torch.empty_like(scale) if params else None
    dbias = torch.empty_like(scale) if params else None
    part = (torch.empty((2 * _PARAM_CHUNKS * c,), dtype=torch.float32, device=x_new.device)
            if params else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x_new.device):
        stream = torch.cuda.current_stream(x_new.device).cuda_stream
        err = _k9_function("mia_unpartition_add_ln_bwd_" + _SUFFIX[x_new.dtype])(
            x_new.data_ptr(), dx_new.data_ptr(), dy.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
            scale.data_ptr(), dsc.data_ptr(), dwin.data_ptr(), ptr(dscale), ptr(dbias), ptr(part),
            b, h, w, c, ws, stream)
    if err != 0:
        raise RuntimeError(f"K9 backward launch failed: cudaError {err}")
    _count(unpartition_add_ln_fused_bwd, x_new)
    return dwin, dsc, dscale, dbias


def unpartition_add_ln_fused_bwd(x_new, dx_new, dy, mu, rstd, scale, window_size: int,
                                 params: bool = True):
    """K9 backward: a CUDA tensor launches the backward kernel of
    ``csrc/unpartition_residual.cu`` (and raises if it cannot); a CPU tensor
    takes :func:`unpartition_add_ln_bwd`."""
    if x_new.device.type == "cpu":
        return unpartition_add_ln_bwd(x_new, dx_new, dy, mu, rstd, scale, window_size, params)
    return _launch_k9_bwd(x_new, dx_new, dy, mu, rstd, scale, window_size, params)


class _UnpartitionAddLN(torch.autograd.Function):
    """K9 with a gradient: ``(windows, shortcut, scale, bias)`` → ``(x_new, y)``."""

    @staticmethod
    def forward(ctx, windows, shortcut, scale, bias, window_size, eps):
        windows, shortcut = windows.contiguous(), shortcut.contiguous()
        if shortcut.device.type == "cpu":
            x_new, y = unpartition_add_ln_plain(windows, shortcut, scale, bias, window_size, eps)
            stats_of = x_new.float() if x_new.dtype == torch.bfloat16 else x_new
            mu, rstd = (t[..., 0] for t in layer_norm_stats(stats_of, eps))
        else:
            x_new, y, mu, rstd = _launch_k9(windows, shortcut, scale, bias, window_size, eps,
                                            with_stats=True)
        ctx.save_for_backward(x_new, mu, rstd, scale)
        ctx.window_size = window_size
        return x_new, y

    @staticmethod
    def backward(ctx, dx_new, dy):
        x_new, mu, rstd, scale = ctx.saved_tensors
        params = ctx.needs_input_grad[2] or ctx.needs_input_grad[3]
        dwin, dsc, dscale, dbias = unpartition_add_ln_fused_bwd(
            x_new, dx_new.contiguous(), dy.contiguous(), mu, rstd, scale, ctx.window_size, params)
        return dwin, dsc, dscale, dbias, None, None


def unpartition_add_ln(windows, shortcut, scale, bias, window_size: int, eps: float = 1e-6):
    """K9: ``x_new = shortcut + window_unpartition(windows)``,
    ``y = LayerNorm(x_new)``; returns ``(x_new, y)``.

    ``windows`` is the attention block's output still in the partitioned
    ``(B·nW, ws, ws, C)`` layout (pad-slot values are ignored), ``shortcut``
    the ``(B, H, W, C)`` residual stream, ``scale``/``bias`` norm2's
    parameters. A CUDA tensor launches ``csrc/unpartition_residual.cu`` (or
    raises); a CPU tensor takes the plain version. Differentiable through
    the backward kernel (K9b) when an input requires a gradient.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (windows, shortcut, scale, bias)):
        return _UnpartitionAddLN.apply(windows, shortcut, scale, bias, int(window_size), float(eps))
    if shortcut.device.type == "cpu":
        return unpartition_add_ln_plain(windows, shortcut, scale, bias, window_size, eps)
    return _launch_k9(windows.contiguous(), shortcut.contiguous(), scale, bias, window_size, eps)


def _count(wrapper, grid) -> None:
    """One launch of the float32 kernel (``launches``) or of its bfloat16
    instance (``bf16_launches``)."""
    if grid.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    else:
        wrapper.launches += 1


unpartition_add_ln.launches = 0
unpartition_add_ln_fused_bwd.launches = 0
unpartition_add_ln.bf16_launches = 0
unpartition_add_ln_fused_bwd.bf16_launches = 0
