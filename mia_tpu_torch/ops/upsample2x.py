"""k=2/s=2 transposed convolution (2x upsample) — kernels K10 and K10b and
their plain versions.

Counterpart of ``mia_tpu/ops/upsample2x.py``. For channel-last
``x (B, H, W, Cin)``, taps ``w (2, 2, Cin, Cout)`` (NOT reversed: the caller
passes them in output order) and ``b (Cout,)``::

    y[b, 2i+di, 2j+dj, :] = x[b, i, j, :] · w[di, dj] + b

- :func:`conv_transpose2x_plain` — the plain PyTorch version (any device):
  one matrix product of the ``(B·H·W, Cin)`` pixels with the ``(Cin, 4·Cout)``
  taps, then the interleave reshape.
- :func:`conv_transpose2x_bwd_plain` — its VJP written out: ``dx`` from the
  cotangent's four taps, ``dw`` in the weight's dtype, ``db`` in float32.
- :func:`conv_transpose2x` — the wrapper of the CUDA kernels
  ``csrc/upsample2x.cu``, which replace the TPU kernels ``conv_transpose2x_p``
  and its ``_bwd_impl``. A CUDA tensor launches the kernel (or raises); a CPU
  tensor takes the plain version. When autograd needs a gradient it runs
  inside a ``torch.autograd.Function`` whose backward is
  :func:`conv_transpose2x_fused_bwd` (the backward kernel K10b, or the plain
  VJP on the CPU). Each of the three products (forward, ``dx``, ``dw``) runs
  on the tensor cores in 3xTF32 (float32 accuracy) where its float32 time is
  set by operations, and as a float32 tile on the CUDA cores where bytes set
  it (the thin stages); :func:`k10_routes` says which a shape takes. K10b adds
  its per-chunk partial sums of ``dw``/``db`` in a fixed order, so two
  launches agree bit for bit. ``launches`` on each wrapper counts kernel
  launches.
- bfloat16 ``x``, ``w`` (and ``dy``) with a float32 bias take the Pallas
  kernel's rounding, :func:`conv_transpose2x_plain_bf16` and
  :func:`conv_transpose2x_bwd_plain_bf16`: every product summed in float32,
  the float32 bias added, each output rounded once (``dx`` and ``y`` to
  bfloat16, ``dw`` to the weight's dtype, ``db`` left float32). On the card
  they are the bfloat16 instances of the same kernels (bfloat16
  ``mma.sync`` where operations bound a product, bfloat16 loads and float32
  FMA on the thin stages), counted in ``bf16_launches``; the bfloat16
  backward of the stages with Cin <= 64 and Cout <= 32 (prompt-large 2-4,
  UNet 4, SAM 2) is one pass over ``dy`` that makes ``dx``, ``dw`` and
  ``db`` together, as the Pallas kernel does, then the reduces of its
  partials (:func:`k10_routes` names it ``"one pass"``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library


def conv_transpose2x_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain K10: ``x (B, H, W, Cin)``, ``w (2, 2, Cin, Cout)``, ``b (Cout,)``
    → ``(B, 2H, 2W, Cout)`` as one GEMM."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    y = x.reshape(bsz * h * wd, cin) @ w.permute(2, 0, 1, 3).reshape(cin, 4 * cout)
    y = y.view(bsz, h, wd, 2, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(bsz, 2 * h, 2 * wd, cout)
    return y + b


def conv_transpose2x_bwd_plain(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """Plain VJP of K10 (the JAX package's ``_bwd_impl`` semantics): ``dy
    (B, 2H, 2W, Cout)`` → ``(dx, dw, db)``; ``dw`` takes ``w``'s dtype, ``db``
    is float32. ``dx`` is None unless ``need_dx``, ``dw``/``db`` unless
    ``need_dw``."""
    bsz, h, wd, cin = x.shape
    cout = w.shape[-1]
    # (B, H, 2, W, 2, Cout) → pixels by (di, dj, co)
    taps = dy.reshape(bsz, h, 2, wd, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(-1, 4 * cout)
    dx = dw = db = None
    if need_dx:
        dx = (taps @ w.permute(0, 1, 3, 2).reshape(4 * cout, cin)).view(bsz, h, wd, cin)
    if need_dw:
        dw = (x.reshape(-1, cin).t() @ taps).view(cin, 2, 2, cout).permute(1, 2, 0, 3)
        dw = dw.contiguous().to(w.dtype)
        db = taps.to(torch.float32).sum(0).view(4, cout).sum(0)
    return dx, dw, db


def conv_transpose2x_plain_bf16(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain K10 in the Pallas kernel's rounding: bfloat16 ``x`` and ``w``,
    a float32 ``b``; the float32 product of the operands plus the float32
    bias, rounded once to bfloat16."""
    return conv_transpose2x_plain(x.float(), w.float(), b.float()).to(torch.bfloat16)


def conv_transpose2x_bwd_plain_bf16(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """Plain VJP of K10 in the Pallas kernel's rounding: float32 sums of the
    bfloat16 operands, ``dx`` rounded once to ``x``'s dtype, ``dw`` to
    ``w``'s, ``db`` float32."""
    dx, dw, db = conv_transpose2x_bwd_plain(x.float(), w.float(), dy.float(), need_dx, need_dw)
    return (None if dx is None else dx.to(x.dtype), None if dw is None else dw.to(w.dtype), db)


@functools.cache
def _k10_functions(dtype):
    """The C entries of ``dtype``'s instance: forward, dw's chunk count,
    backward and the route of a product."""
    lib = load_library()
    suffix = _SUFFIX[dtype]
    fwd = getattr(lib, f"mia_conv_transpose2x_{suffix}")
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    chunks = getattr(lib, f"mia_conv_transpose2x_bwd_chunks_{suffix}")
    chunks.argtypes = [ctypes.c_int] * 5
    chunks.restype = ctypes.c_longlong
    bwd = getattr(lib, f"mia_conv_transpose2x_bwd_{suffix}")
    bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    route = getattr(lib, f"mia_conv_transpose2x_route_{suffix}")
    route.argtypes = [ctypes.c_int] * 6
    route.restype = ctypes.c_int
    return fwd, chunks, bwd, route


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_CHANNEL_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}  # 16 bytes of either
PRODUCTS = ("forward", "dx", "dw")


def k10_routes(x_shape, cout: int, dtype=torch.float32) -> dict:
    """The route each of K10's products takes on the card for ``x (B, H, W,
    Cin)`` and ``Cout`` in ``dtype``: ``"tensor cores"`` (3xTF32, or
    bfloat16 ``mma.sync``), ``"cuda cores"`` (float32 FMA) or, for the
    bfloat16 backward with Cin <= 64 and Cout <= 32, ``"one pass"`` (dx and
    dw both), by product (forward, dx, dw). Builds the library."""
    route = _k10_functions(dtype)[3]
    names = {1: "tensor cores", 0: "cuda cores", 2: "one pass"}
    return {name: names[route(*x_shape, cout, i)] for i, name in enumerate(PRODUCTS)}


def _check_k10(label, x, w, bias=None, **operands):
    """Check ``x (B, H, W, Cin)``, ``w (2, 2, Cin, Cout)`` of one dtype
    (float32, or bfloat16 with channel counts multiples of 8), the named
    operands of that dtype (name → (tensor, shape)) and the float32
    ``bias``; return the sizes."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (2, 2, x.shape[3]):
        raise ValueError(f"{label} needs x (B, H, W, Cin) and w (2, 2, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    dtype = x.dtype
    if dtype not in _SUFFIX:
        raise ValueError(f"{label} needs float32 or bfloat16 operands, got {dtype}")
    bsz, h, wd, cin = x.shape
    cout = w.shape[3]
    multiple = _CHANNEL_MULTIPLE[dtype]
    if cin == 0 or cout == 0 or cin % multiple or cout % multiple:
        raise ValueError(f"{label} needs channel counts that are multiples of {multiple} in "
                         f"{dtype}, got Cin {cin}, Cout {cout}")
    if max(bsz, 2 * h, 2 * wd, cin, 4 * cout) >= 2 ** 31 or bsz * h * wd * 4 * max(cin, cout) >= 2 ** 62:
        raise ValueError(f"{label} shape {tuple(x.shape)} overflows the kernel's sizes")
    checked = {name: (t, shape, dtype) for name, (t, shape) in
               {"x": (x, tuple(x.shape)), "w": (w, tuple(w.shape)), **operands}.items()}
    if bias is not None:
        checked["b"] = (bias, (cout,), torch.float32)
    for name, (t, shape, want) in checked.items():
        if (t.dtype != want or t.device != x.device or tuple(t.shape) != tuple(shape)
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{label} {name} must be a contiguous, 16-byte aligned {want} "
                             f"{tuple(shape)} tensor on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if x.device.type != "cuda":
        raise ValueError(f"{label} needs a CUDA tensor, got {x.device}")
    return bsz, h, wd, cin, cout


def _launch_k10(x, w, b):
    """Launch the forward kernel of ``x``'s dtype (float32, or bfloat16 with a
    float32 bias); raise on anything it does not take."""
    bsz, h, wd, cin, cout = _check_k10("K10", x, w, bias=b)
    out = torch.empty((bsz, 2 * h, 2 * wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _k10_functions(x.dtype)[0](x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                         out.data_ptr(), bsz, h, wd, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"K10 launch failed: cudaError {err}")
    if x.dtype == torch.bfloat16:
        conv_transpose2x.bf16_launches += 1
    else:
        conv_transpose2x.launches += 1
    return out


def _launch_k10_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """Launch K10's backward (``mia_conv_transpose2x_bwd_f32``, or ``_bf16``
    for bfloat16 ``x``, ``w`` and ``dy``) → (dx in ``x``'s dtype, dw in
    ``w``'s, float32 db), None where not asked."""
    bsz, h, wd, cin, cout = _check_k10(
        "K10 backward", x, w, dy=(dy, (x.shape[0], 2 * x.shape[1], 2 * x.shape[2], w.shape[3])))
    if not (need_dx or need_dw):
        return None, None, None
    _, chunks_of, bwd, _ = _k10_functions(x.dtype)
    dev = x.device
    dx = torch.empty_like(x) if need_dx else None
    dw = db = part = sums = None
    if need_dw:
        chunks = int(chunks_of(bsz, h, wd, cin, cout))
        dw = torch.empty_like(w)
        db = torch.empty((cout,), dtype=torch.float32, device=dev)
        part = torch.empty((chunks * cin * 4 * cout,), dtype=torch.float32, device=dev)
        sums = torch.empty((chunks * 4 * cout,), dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = bwd(x.data_ptr(), w.data_ptr(), dy.data_ptr(), ptr(dx), ptr(dw), ptr(db), ptr(part),
                  ptr(sums), bsz, h, wd, cin, cout, stream)
    if err != 0:
        raise RuntimeError(f"K10 backward launch failed: cudaError {err}")
    if x.dtype == torch.bfloat16:
        conv_transpose2x_fused_bwd.bf16_launches += 1
    else:
        conv_transpose2x_fused_bwd.launches += 1
    return dx, dw, db


def conv_transpose2x_fused_bwd(x, w, dy, need_dx: bool = True, need_dw: bool = True):
    """K10 backward: a CUDA tensor launches the backward kernels of
    ``csrc/upsample2x.cu`` of ``x``'s dtype (and raises if it cannot); a CPU
    tensor takes :func:`conv_transpose2x_bwd_plain` (bfloat16:
    :func:`conv_transpose2x_bwd_plain_bf16`)."""
    if x.device.type == "cpu":
        plain = (conv_transpose2x_bwd_plain_bf16 if x.dtype == torch.bfloat16
                 else conv_transpose2x_bwd_plain)
        return plain(x, w, dy, need_dx, need_dw)
    return _launch_k10_bwd(x, w, dy, need_dx, need_dw)


def _plain_of(x):
    """The plain K10 of ``x``'s dtype (the CPU's side of the wrapper)."""
    return conv_transpose2x_plain_bf16 if x.dtype == torch.bfloat16 else conv_transpose2x_plain


class _ConvTranspose2x(torch.autograd.Function):
    """K10 with a gradient: ``(x, w, b)`` → ``y``."""

    @staticmethod
    def forward(ctx, x, w, b):
        x, w = x.contiguous(), w.contiguous()
        ctx.save_for_backward(x, w)
        if x.device.type == "cpu":
            return _plain_of(x)(x, w, b)
        return _launch_k10(x, w, b.contiguous())

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_dw = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dx, dw, db = conv_transpose2x_fused_bwd(x, w, dy.contiguous(), ctx.needs_input_grad[0],
                                                need_dw)
        return dx, dw, db


def conv_transpose2x(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """K10: ``y[b, 2i+di, 2j+dj] = x[b, i, j] · w[di, dj] + b`` for ``x
    (B, H, W, Cin)``, ``w (2, 2, Cin, Cout)``, ``b (Cout,)`` → ``(B, 2H, 2W,
    Cout)``, written without an interleave copy.

    A CUDA tensor launches ``csrc/upsample2x.cu`` (or raises): float32 ``x``
    and ``w`` with channel counts multiples of 4, or bfloat16 ones with
    multiples of 8, and a float32 ``b``. A CPU tensor takes the plain version
    of its dtype. Differentiable through the backward kernel (K10b) when an
    input requires a gradient. ``launches`` counts the float32 instance's
    launches, ``bf16_launches`` the bfloat16 one's (here and on
    :func:`conv_transpose2x_fused_bwd`).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w, b)):
        return _ConvTranspose2x.apply(x, w, b)
    if x.device.type == "cpu":
        return _plain_of(x)(x, w, b)
    return _launch_k10(x.contiguous(), w.contiguous(), b.contiguous())


conv_transpose2x.launches = 0
conv_transpose2x.bf16_launches = 0
conv_transpose2x_fused_bwd.launches = 0
conv_transpose2x_fused_bwd.bf16_launches = 0
