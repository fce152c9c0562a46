"""LayerNorm fused with the window partition — kernel K4 and its plain version.

Counterpart of ``mia_tpu/ops/ln_window.py``. Layout is the JAX package's,
channel-last: ``x (B, H, W, C)`` → windows ``(B·nW, ws, ws, C)`` in
``window_partition``'s order, pad slots zero.

- :func:`layer_norm` — flax's LayerNorm arithmetic (fast variance
  ``max(E[x²] − μ², 0)``, ``y = (x − μ)·(rsqrt(σ² + ε)·scale) + bias``).
- :func:`window_partition` — zero-pad to whole windows and partition.
- :func:`ln_window_partition` — the plain PyTorch version (any device):
  LayerNorm, then pad with zeros, then partition; a bfloat16 ``x`` is
  normalised in float32 and its windows rounded to bfloat16.
- :func:`ln_window_partition_bwd` — the plain VJP from the saved per-token
  statistics: the LayerNorm VJP of the un-partitioned cotangent (pad-slot
  cotangents dropped), ``dscale``/``dbias`` only when asked.
- :func:`ln_window_partition_fused` — the wrapper of the CUDA kernel
  ``csrc/ln_window.cu``, which replaces the TPU kernel
  ``mia_tpu/ops/ln_window.py::ln_window_partition``. A CUDA tensor launches
  the kernel (or raises); a CPU tensor takes the plain version. When
  autograd needs a gradient it runs inside a ``torch.autograd.Function``
  whose forward also keeps ``mu``/``rstd`` and whose backward is
  :func:`ln_window_partition_fused_bwd` (the backward kernel of the same
  file, or the plain VJP on the CPU).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from .cuda_build import load_library


def layer_norm_stats(x: torch.Tensor, eps: float):
    """Per-token mean and ``rsqrt(max(E[x²] − μ², 0) + ε)`` over the last axis."""
    mu = x.mean(-1, keepdim=True)
    var = ((x * x).mean(-1, keepdim=True) - mu * mu).clamp_min(0.0)
    return mu, torch.rsqrt(var + eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in flax's operation order."""
    mu, rstd = layer_norm_stats(x, eps)
    return (x - mu) * (rstd * weight) + bias


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


def window_unpartition(windows: torch.Tensor, window_size: int, hw) -> torch.Tensor:
    """(B·nW, ws, ws, C) → (B, H, W, C), dropping the pad slots."""
    h, w = hw
    ws = window_size
    nwy, nwx = -(-h // ws), -(-w // ws)
    c = windows.shape[-1]
    x = windows.reshape(-1, nwy, nwx, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, nwy * ws, nwx * ws, c)[:, :h, :w]


def ln_window_partition(x, scale, bias, window_size: int, eps: float = 1e-6) -> torch.Tensor:
    """Plain ``window_partition(LayerNorm(x))``: pad slots are 0, not ``bias``.
    A bfloat16 ``x`` is normalised in float32 with the float32 ``scale`` and
    ``bias`` and the windows come out in bfloat16, as the Pallas kernel's."""
    y = layer_norm(x.float(), scale, bias, eps).to(x.dtype)
    return window_partition(y, window_size)[0]


def ln_window_partition_bwd(x, dy, mu, rstd, scale, window_size: int, params: bool = True):
    """Plain VJP of :func:`ln_window_partition` from the per-token statistics
    ``mu``, ``rstd`` ``(B, H, W)``: ``dy`` ``(B·nW, ws, ws, C)`` → ``(dx,
    dscale, dbias)``; the last two are None unless ``params``."""
    g_full = window_unpartition(dy, window_size, x.shape[1:3])
    mu, rstd = mu[..., None], rstd[..., None]
    xhat = (x - mu) * rstd
    g = g_full * scale
    dx = rstd * (g - g.mean(-1, keepdim=True) - xhat * (g * xhat).mean(-1, keepdim=True))
    if not params:
        return dx, None, None
    return dx, (g_full * xhat).sum((0, 1, 2)), g_full.sum((0, 1, 2))


_K4_SYMBOLS = {torch.float32: "mia_ln_window_partition_f32",
               torch.bfloat16: "mia_ln_window_partition_bf16"}


@functools.cache
def _k4_function(name: str):
    fn = getattr(load_library(), name)
    forward = name != "mia_ln_window_partition_bwd_f32"
    pointers = 6 if forward else 9
    ints = 5
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + ([ctypes.c_float] if forward else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_k4(label, x, window_size, dtypes=(torch.float32,), **params):
    if x.device.type != "cuda":
        raise ValueError(f"{label} needs a CUDA tensor, got {x.device}")
    if x.dtype not in dtypes or not x.is_contiguous() or x.dim() != 4:
        raise ValueError(f"{label} needs a contiguous {' or '.join(map(str, dtypes))} "
                         f"(B, H, W, C) tensor, got {x.dtype}")
    b, h, w, c = x.shape
    for name, p in params.items():
        if (p.dtype != torch.float32 or p.device != x.device or tuple(p.shape) != (c,)
                or not p.is_contiguous()):
            raise ValueError(f"{label} {name} must be a contiguous float32 ({c},) tensor on {x.device}")
    ws = int(window_size)
    if ws <= 0:
        raise ValueError(f"{label} window size must be positive, got {ws}")
    nwy, nwx = -(-h // ws), -(-w // ws)
    if max(b, h, w, c, b * nwy * nwx * ws * ws) >= 2 ** 31:
        raise ValueError(f"{label} shape {tuple(x.shape)} overflows int32 sizes")
    return b, h, w, c, ws, b * nwy * nwx


def _launch_k4(x, scale, bias, window_size: int, eps: float, with_stats: bool = False):
    """Launch the CUDA kernel (float32 or bfloat16 ``x`` and windows, float32
    ``scale``, ``bias`` and statistics); raise on anything it does not take.
    ``with_stats`` also returns the per-token ``mu``, ``rstd`` ``(B, H, W)``."""
    b, h, w, c, ws, windows = _check_k4("K4", x, window_size, tuple(_K4_SYMBOLS), scale=scale,
                                        bias=bias)
    out = torch.empty((windows, ws, ws, c), dtype=x.dtype, device=x.device)
    mu = torch.empty((b, h, w), dtype=torch.float32, device=x.device) if with_stats else None
    rstd = torch.empty_like(mu) if with_stats else None
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _k4_function(_K4_SYMBOLS[x.dtype])(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if mu is None else mu.data_ptr(), None if rstd is None else rstd.data_ptr(),
            b, h, w, c, ws, float(eps), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    if x.dtype == torch.bfloat16:
        ln_window_partition_fused.bf16_launches += 1
    else:
        ln_window_partition_fused.launches += 1
    return (out, mu, rstd) if with_stats else out


_PARAM_CHUNKS = 256  # token chunks of the kernel's dscale/dbias partial sums


def _launch_k4_bwd(x, dy, mu, rstd, scale, window_size: int, params: bool = True):
    """Launch K4's backward (``mia_ln_window_partition_bwd_f32``) → (dx,
    dscale, dbias), the last two only when ``params``."""
    b, h, w, c, ws, windows = _check_k4("K4 backward", x, window_size, scale=scale)
    for name, t, shape in (("cotangent", dy, (windows, ws, ws, c)), ("mu", mu, (b, h, w)),
                           ("rstd", rstd, (b, h, w))):
        if (t.dtype != torch.float32 or t.device != x.device or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"K4 backward {name} must be a contiguous float32 {shape} tensor")
    dx = torch.empty_like(x)
    dscale = torch.empty_like(scale) if params else None
    dbias = torch.empty_like(scale) if params else None
    part = (torch.empty((2 * _PARAM_CHUNKS * c,), dtype=torch.float32, device=x.device)
            if params else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _k4_function("mia_ln_window_partition_bwd_f32")(
            x.data_ptr(), dy.data_ptr(), mu.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
            dx.data_ptr(), ptr(dscale), ptr(dbias), ptr(part), b, h, w, c, ws, stream)
    if err != 0:
        raise RuntimeError(f"K4 backward launch failed: cudaError {err}")
    ln_window_partition_fused_bwd.launches += 1
    return dx, dscale, dbias


def ln_window_partition_fused_bwd(x, dy, mu, rstd, scale, window_size: int, params: bool = True):
    """K4 backward: a CUDA tensor launches the backward kernel of
    ``csrc/ln_window.cu`` (and raises if it cannot); a CPU tensor takes
    :func:`ln_window_partition_bwd`."""
    if x.device.type == "cpu":
        return ln_window_partition_bwd(x, dy, mu, rstd, scale, window_size, params)
    return _launch_k4_bwd(x, dy, mu, rstd, scale, window_size, params)


class _LNWindowPartition(torch.autograd.Function):
    """K4 with a gradient: ``(x, scale, bias)`` → windows."""

    @staticmethod
    def forward(ctx, x, scale, bias, window_size, eps):
        x = x.contiguous()
        if x.device.type == "cpu":
            mu, rstd = (t[..., 0] for t in layer_norm_stats(x, eps))
            out = ln_window_partition(x, scale, bias, window_size, eps)
        else:
            out, mu, rstd = _launch_k4(x, scale, bias, window_size, eps, with_stats=True)
        ctx.save_for_backward(x, mu, rstd, scale)
        ctx.window_size = window_size
        return out

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, scale = ctx.saved_tensors
        params = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dscale, dbias = ln_window_partition_fused_bwd(
            x, dy.contiguous(), mu, rstd, scale, ctx.window_size, params)
        return dx, dscale, dbias, None, None


def ln_window_partition_fused(x, scale, bias, window_size: int, eps: float = 1e-6) -> torch.Tensor:
    """K4: ``window_partition(LayerNorm(x))`` of float32 or bfloat16
    ``(B, H, W, C)`` (float32 ``scale`` and ``bias``; the windows in ``x``'s
    dtype).

    A CUDA tensor launches ``csrc/ln_window.cu`` (and raises if it cannot);
    a CPU tensor takes the plain version. Differentiable through the
    backward kernel when an input requires a gradient, in float32 only: a
    bfloat16 call that needs a gradient raises. ``launches`` counts kernel
    launches, ``bf16_launches`` those of the bfloat16 instance.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, scale, bias)):
        if x.dtype == torch.bfloat16:
            raise NotImplementedError(
                "K4 in bfloat16 has no backward yet: its gradient needs K4b in bfloat16, "
                "which is not ported (use compute dtype float32 to train)")
        return _LNWindowPartition.apply(x, scale, bias, int(window_size), float(eps))
    if x.device.type == "cpu":
        return ln_window_partition(x, scale, bias, window_size, eps)
    return _launch_k4(x, scale, bias, window_size, eps)


ln_window_partition_fused.launches = 0
ln_window_partition_fused.bf16_launches = 0
ln_window_partition_fused_bwd.launches = 0
