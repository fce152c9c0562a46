"""Rel-pos attention — kernels K2, K3 (packed qkv layout), K6, K7 (head-major
operands) and K8 (windows carved from the token grid), with their plain
versions.

Counterpart of ``mia_tpu/ops/attention.py``. All compute
``softmax(q·kᵀ·scale + bias)·v`` in float32. K2 and K3 also take bfloat16
operands (the JAX kernels' fast path, a bfloat16 model's ``qkv``) and round
where the Pallas kernels round (:func:`_softmax_probs_bf16`), forward and
backward (:func:`attention_rel_packed_bwd_bf16`,
:func:`attention_rel_packed_ik_bwd_bf16`); their bfloat16 CUDA instances
(K2·bf16, K3·bf16, K2b·bf16, K3b·bf16) run on bfloat16 ``mma.sync``.

Packed layout (K2, K3): ``qkv`` is the qkv Linear's output ``(B', N, 3·H·D)``
in ``(3, heads, head_dim)`` order; the context comes back as ``(B', N, H·D)``,
head ``h`` at columns ``[h·D, (h+1)·D)``, ready for the proj Linear. The bias
is ``rel_h[n, k // k_w] + rel_w[n, k % k_w]``, the rel terms taken from the
unscaled q.

- :func:`attention_rel_packed` — plain K3: rel terms arrive head-major as
  ``(B'·H, N, k_h)`` and ``(B'·H, N, k_w)`` (global blocks).
- :func:`attention_rel_packed_ik` — plain K2: rel terms computed from the
  gathered ``(q_h·k_h, D)`` and ``(k_w·k_w, D)`` tables, shared across
  heads (windowed blocks).
- :func:`attention_rel_packed_bwd` and :func:`attention_rel_packed_ik_bwd`
  — the plain VJPs: recompute the softmax, ``delta = rowsum(g∘o)``,
  ``ds = p(dp − delta)``, then ``dq``, ``dk``, ``dv`` and the rel-term
  (K3) or table (K2) gradients; their bfloat16 halves take ``p`` from the
  forward's log-sum-exp, as the CUDA kernels do.
- :func:`fused_attention_rel_packed` and
  :func:`fused_attention_rel_packed_ik` — the wrappers of the CUDA kernels
  in ``csrc/attention_rel.cu`` (3xTF32 on the tensor cores, the template of
  ``csrc/attention_fwd_tc.cuh``; K2 first computes its rel terms from the
  tables into a scratch), which replace the TPU kernels of the same names.
  A CUDA tensor launches the kernel (or raises); a CPU tensor takes
  the plain version. When autograd needs a gradient they run inside a
  ``torch.autograd.Function`` whose forward also keeps the per-row
  log-sum-exp and whose backward is :func:`fused_attention_rel_packed_bwd`
  / :func:`fused_attention_rel_packed_ik_bwd` (the backward kernels of the
  operands' dtype, or the plain VJPs on the CPU). Each wrapper counts its
  launches in ``launches``, and its bfloat16 launches in ``bf16_launches``.

The other routes (K6 on K3's instance of the 3xTF32 tensor-core template
``csrc/attention_fwd_tc.cuh`` on head-major strides, C entry in
``csrc/attention_rel.cu``; K7 on the same template with a dense bias and K8
on its window instance, which carves the windows from the token grid by the
slot map of ``csrc/attention_window.cuh``, C entries in
``csrc/attention_routes.cu``):

- :func:`attention_rel` / :func:`fused_attention_rel` (K6) — head-major
  ``q, k, v (B·H, N, D)`` with rel terms ``(B·H, N, k_h)``, ``(B·H, N, k_w)``;
  any ``N = k_h·k_w``. :func:`attention_rel_with_padding` is the same call
  (the name is the JAX package's; nothing is padded on this card).
- :func:`attention_dense` / :func:`fused_attention` (K7) — head-major
  operands and a dense additive bias ``(B·H, N, N)``, any ``N``; the bias may
  mask keys with ``-inf`` (a row needs one finite key).
  :func:`attention_with_padding` is the same call: the TPU form pads ``N``
  to 128 and masks the pad keys, the CUDA kernel masks its ragged last
  tile itself.
- :func:`attention_rel_win` / :func:`fused_attention_rel_win` (K8) —
  windowed attention on the **unpartitioned** grid: ``qkv (B, Hg, Wg, 3·H·D)``,
  rel terms of the real tokens in grid layout ``(B·H, Hg, Wg, ws)``,
  ``bias_kv (3, H·D)`` (the qkv Linear's output for a zero token) → context
  ``(B, Hg, Wg, H·D)``. Window slots outside the grid are real keys whose
  k and v are ``bias_kv`` and which carry the query's rel bias for their
  slot position; pad queries are dropped.

Their gradients, as for K2 and K3: when an input needs one the wrapper runs
inside a ``torch.autograd.Function`` whose forward keeps the kernel's
log-sum-exp and whose backward is

- :func:`fused_attention_rel_bwd` (K6b) — ``dq, dk, dv, drel_h, drel_w``
  from K3b's 3xTF32 tensor-core backward (``csrc/attention_bwd_tc.cuh``,
  C entry in ``csrc/attention_rel.cu``) on head-major strides; plain VJP
  :func:`attention_rel_bwd`.
- :func:`fused_attention_rel_win_bwd` (K8b) — ``dqkv`` written in place in
  the grid layout, ``drel_h``, ``drel_w`` and ``dbias_kv`` (row 0 zero, rows
  1-2 the summed ``dk``, ``dv`` of every pad slot, reduced in a fixed order)
  from the windowed instance of the same tensor-core backward (C entry in
  ``csrc/attention_routes.cu``); plain VJP :func:`attention_rel_win_bwd`.
- :func:`attention_dense_bwd` for K7, on every device: the JAX package has
  no backward kernel there either, its VJP is the same plain tensor code.

On the CPU the Functions run the plain forward and the plain VJP.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load_library
from .ln_window import window_partition, window_unpartition

KERNEL_HEAD_DIMS = (64, 80)  # head dims csrc/attention_rel.cu is built for (ViT-B/L, ViT-H)


def _head_dim(qkv: torch.Tensor, num_heads: int) -> int:
    three_hd = qkv.shape[-1]
    if three_hd % (3 * num_heads):
        raise ValueError(f"qkv width {three_hd} is not 3·heads·D for heads={num_heads}")
    return three_hd // (3 * num_heads)


def _softmax_probs(qkv, rel_h, rel_w, scale, k_hw, num_heads):
    """(q, k, v) as (B, H, N, D) and the attention probabilities (B, H, N, N)."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    if n != k_h * k_w:
        raise ValueError(f"token count {n} != k_h*k_w {k_h * k_w}")
    d = _head_dim(qkv, num_heads)
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)  # (B, H, N, D) each
    attn = (q * scale) @ k.transpose(-2, -1)
    bias = rel_h.reshape(b, num_heads, n, k_h, 1) + rel_w.reshape(b, num_heads, n, 1, k_w)
    return q, k, v, (attn + bias.view(b, num_heads, n, n)).softmax(-1)


def _softmax_probs_bf16(qkv, rel_h, rel_w, scale, k_hw, num_heads):
    """:func:`_softmax_probs` of bfloat16 operands, rounded where the Pallas
    kernels round: ``q·scale`` is a bfloat16 product with the scale itself
    rounded to bfloat16 (exact at head dim 64), the scores are float32 sums
    of the exact products plus the bfloat16 rel terms, and the softmax is
    float32. Returns v and the float32 probabilities, and the per-row
    log-sum-exp ``(B·H, N)`` the CUDA kernel writes."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    if n != k_h * k_w:
        raise ValueError(f"token count {n} != k_h*k_w {k_h * k_w}")
    d = _head_dim(qkv, num_heads)
    q, k, v = qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    qs = q * torch.tensor(scale, dtype=qkv.dtype)
    bias = (rel_h.float().reshape(b, num_heads, n, k_h, 1)
            + rel_w.float().reshape(b, num_heads, n, 1, k_w)).view(b, num_heads, n, n)
    s = qs.float() @ k.float().transpose(-2, -1) + bias
    return v, s.softmax(-1), s.logsumexp(-1).reshape(b * num_heads, n)


def attention_rel_packed(qkv, rel_h, rel_w, scale: float, k_hw, num_heads: int) -> torch.Tensor:
    """Plain K3: ``(B, N, 3·H·D)`` packed qkv + head-major rel terms →
    ``(B, N, H·D)``. In bfloat16 the normalised probabilities are rounded to
    bfloat16 before the float32 sum of P·V, and the output to bfloat16."""
    b, n, _ = qkv.shape
    if qkv.dtype == torch.bfloat16:
        return attention_rel_packed_bf16(qkv, rel_h, rel_w, scale, k_hw, num_heads)[0]
    _, _, v, attn = _softmax_probs(qkv, rel_h, rel_w, scale, k_hw, num_heads)
    return (attn @ v).transpose(1, 2).reshape(b, n, -1)


def attention_rel_packed_bf16(qkv, rel_h, rel_w, scale: float, k_hw, num_heads: int):
    """Plain bfloat16 K3 → (context ``(B, N, H·D)`` in bfloat16, float32
    log-sum-exp ``(B·H, N)``)."""
    b, n, _ = qkv.shape
    v, p, lse = _softmax_probs_bf16(qkv, rel_h, rel_w, scale, k_hw, num_heads)
    out = p.to(torch.bfloat16).float() @ v.float()
    return out.to(torch.bfloat16).transpose(1, 2).reshape(b, n, -1), lse


def attention_rel_packed_bwd(qkv, rel_h, rel_w, out, g, scale: float, k_hw, num_heads: int):
    """Plain VJP of K3 (the JAX package's ``_rel_packed_bwd`` semantics):
    cotangent ``g`` of the ``(B, N, H·D)`` output → ``(dqkv, drel_h, drel_w)``
    in the shapes of ``qkv``, ``rel_h``, ``rel_w``."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    q, k, v, p = _softmax_probs(qkv, rel_h, rel_w, scale, k_hw, num_heads)
    g4 = g.reshape(b, n, num_heads, -1).transpose(1, 2)
    o4 = out.reshape(b, n, num_heads, -1).transpose(1, 2)
    delta = (g4 * o4).sum(-1, keepdim=True)
    dv = p.transpose(-2, -1) @ g4
    ds = p * (g4 @ v.transpose(-2, -1) - delta)
    dq = (ds @ k) * scale
    dk = (ds.transpose(-2, -1) @ q) * scale
    dqkv = _stack_dqkv(dq, dk, dv, qkv.shape)
    ds5 = ds.reshape(b * num_heads, n, k_h, k_w)
    return dqkv, ds5.sum(-1), ds5.sum(-2)


def _rel_packed_bwd_bf16(qkv, rel_h, rel_w, out, g, lse, scale, k_hw, num_heads):
    """The bfloat16 VJP of the packed attention, rounded where the Pallas
    kernel ``_rel_packed_bwd_kernel`` rounds: ``p = exp(s − lse)`` in float32
    from the forward's log-sum-exp ``(B·H, N)`` and the scores of
    :func:`_softmax_probs_bf16`; ``delta = rowsum(g·o)`` a float32 sum of the
    bfloat16 ``g`` and ``o``; ``p`` rounded to bfloat16 for ``dv = pᵀ·g``;
    ``ds = p(dp − delta)`` from the float32 ``p``, rounded to bfloat16 for
    every product that reads it; ``dk = dsᵀ·(q·scale)`` with the bfloat16
    ``q·scale`` of the forward. Every product is a float32 sum of exact
    products. → (``dq`` in float32 before its one rounding, ``dk``, ``dv``
    in bfloat16 ``(B, H, N, D)``, and ``drel_h``, ``drel_w``: the float32
    sums of the rounded ``ds`` over a key row / column, rounded once)."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    bf = torch.bfloat16
    q, k, v = (t.float() for t in qkv.reshape(b, n, 3, num_heads, d).permute(2, 0, 3, 1, 4))
    qs = (q.to(bf) * torch.tensor(scale, dtype=bf)).float()
    bias = (rel_h.float().reshape(b, num_heads, n, k_h, 1)
            + rel_w.float().reshape(b, num_heads, n, 1, k_w)).view(b, num_heads, n, n)
    p = torch.exp(qs @ k.transpose(-2, -1) + bias - lse.reshape(b, num_heads, n, 1))
    g4 = g.reshape(b, n, num_heads, d).transpose(1, 2).float()
    o4 = out.reshape(b, n, num_heads, d).transpose(1, 2).float()
    delta = (g4 * o4).sum(-1, keepdim=True)
    dv = p.to(bf).float().transpose(-2, -1) @ g4
    ds = (p * (g4 @ v.transpose(-2, -1) - delta)).to(bf).float()
    dq = (ds @ k) * scale
    dk = ds.transpose(-2, -1) @ qs
    ds5 = ds.reshape(b * num_heads, n, k_h, k_w)
    return dq, dk.to(bf), dv.to(bf), ds5.sum(-1).to(bf), ds5.sum(-2).to(bf)


def _stack_dqkv(dq, dk, dv, shape):
    """Head-major ``(B, H, N, D)`` gradients → packed ``(B, N, 3·H·D)``."""
    return torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4).reshape(shape)


def attention_rel_packed_bwd_bf16(qkv, rel_h, rel_w, out, g, lse, scale: float, k_hw,
                                  num_heads: int):
    """Plain bfloat16 VJP of K3 (the JAX package's ``_rel_packed_bwd`` on
    bfloat16 operands; :func:`_rel_packed_bwd_bf16`'s roundings, ``dq``
    rounded once) → ``(dqkv, drel_h, drel_w)`` in bfloat16."""
    dq, dk, dv, drel_h, drel_w = _rel_packed_bwd_bf16(qkv, rel_h, rel_w, out, g, lse, scale,
                                                      k_hw, num_heads)
    return _stack_dqkv(dq.to(torch.bfloat16), dk, dv, qkv.shape), drel_h, drel_w


def window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads: int):
    """The rel terms K2 computes in the kernel, head-major:
    ``rel_h[n, j] = q_n·rh_flat[y_n·k_h + j]``,
    ``rel_w[n, j] = q_n·rw_flat[x_n·k_w + j]`` with ``y_n, x_n = divmod(n, k_w)``;
    in bfloat16 each is a float32 sum rounded once to bfloat16, as the Pallas
    kernel's candidate product."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    q_h = n // k_w
    q5 = qkv[..., : num_heads * d].reshape(b, q_h, k_w, num_heads, d)
    if qkv.dtype == torch.bfloat16:  # float32 sums of the exact products, rounded once
        q5, rh_flat, rw_flat = q5.float(), rh_flat.float(), rw_flat.float()
    rel_h = torch.einsum("byxhc,ykc->bhyxk", q5, rh_flat.view(q_h, k_h, d)).to(qkv.dtype)
    rel_w = torch.einsum("byxhc,xkc->bhyxk", q5, rw_flat.view(k_w, k_w, d)).to(qkv.dtype)
    return rel_h.reshape(b * num_heads, n, k_h), rel_w.reshape(b * num_heads, n, k_w)


def attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale: float, k_hw, num_heads: int) -> torch.Tensor:
    """Plain K2: packed qkv + gathered rel tables → ``(B, N, H·D)``."""
    rel_h, rel_w = window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads)
    return attention_rel_packed(qkv, rel_h, rel_w, scale, k_hw, num_heads)


def attention_rel_packed_ik_bwd(qkv, rh_flat, rw_flat, out, g, scale: float, k_hw,
                                num_heads: int, tables: bool = True):
    """Plain VJP of K2 (``_rel_packed_ik_bwd`` semantics): the K3 VJP with the
    rel-term cotangents routed into ``dq`` through the two tables, plus the
    tables' own gradient when ``tables`` (else ``None, None``)."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    q_h = n // k_w
    rel_h, rel_w = window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads)
    dqkv, drel_h, drel_w = attention_rel_packed_bwd(qkv, rel_h, rel_w, out, g, scale, k_hw,
                                                    num_heads)
    drh5 = drel_h.reshape(b, num_heads, q_h, k_w, k_h)
    drw5 = drel_w.reshape(b, num_heads, q_h, k_w, k_w)
    rh3, rw3 = rh_flat.view(q_h, k_h, d), rw_flat.view(k_w, k_w, d)
    dq5 = (torch.einsum("bhyxk,ykc->byxhc", drh5, rh3)
           + torch.einsum("bhyxk,xkc->byxhc", drw5, rw3))
    dqkv = dqkv.clone()
    dqkv[..., : num_heads * d] += dq5.reshape(b, n, num_heads * d)
    if not tables:
        return dqkv, None, None
    q5 = qkv[..., : num_heads * d].reshape(b, q_h, k_w, num_heads, d)
    drh = torch.einsum("bhyxk,byxhc->ykc", drh5, q5).reshape(q_h * k_h, d)
    drw = torch.einsum("bhyxk,byxhc->xkc", drw5, q5).reshape(k_w * k_w, d)
    return dqkv, drh, drw


def attention_rel_packed_ik_bwd_bf16(qkv, rh_flat, rw_flat, out, g, lse, scale: float, k_hw,
                                     num_heads: int, tables: bool = True):
    """Plain bfloat16 VJP of K2 (``_rel_packed_ik_bwd_kernel`` on bfloat16
    operands): :func:`_rel_packed_bwd_bf16` on the forward's bfloat16 rel
    terms; the rel cotangents, already rounded to bfloat16, are routed
    through the tables (float32 sums) and added to the float32 ``dq``
    before its one rounding; the tables' gradient (when ``tables``) is a
    float32 sum of ``drel·q`` rounded once to the tables' dtype."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    d = _head_dim(qkv, num_heads)
    q_h = n // k_w
    rel_h, rel_w = window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads)
    dq, dk, dv, drel_h, drel_w = _rel_packed_bwd_bf16(qkv, rel_h, rel_w, out, g, lse, scale,
                                                      k_hw, num_heads)
    drh5 = drel_h.float().reshape(b, num_heads, q_h, k_w, k_h)
    drw5 = drel_w.float().reshape(b, num_heads, q_h, k_w, k_w)
    rh3, rw3 = rh_flat.float().view(q_h, k_h, d), rw_flat.float().view(k_w, k_w, d)
    dq_rel = (torch.einsum("bhyxk,ykc->bhyxc", drh5, rh3)
              + torch.einsum("bhyxk,xkc->bhyxc", drw5, rw3)).reshape(b, num_heads, n, d)
    dqkv = _stack_dqkv((dq + dq_rel).to(torch.bfloat16), dk, dv, qkv.shape)
    if not tables:
        return dqkv, None, None
    q5 = qkv[..., : num_heads * d].float().reshape(b, q_h, k_w, num_heads, d)
    drh = torch.einsum("bhyxk,byxhc->ykc", drh5, q5).reshape(q_h * k_h, d)
    drw = torch.einsum("bhyxk,byxhc->xkc", drw5, q5).reshape(k_w * k_w, d)
    return dqkv, drh.to(rh_flat.dtype), drw.to(rw_flat.dtype)


_ARGTYPES = {  # (pointers, ints) of each C entry point; then scale and the stream
    "mia_attention_rel_packed_f32": (5, 6),  # ints: batch, n, heads, d, kh, kw
    "mia_attention_rel_packed_ik_f32": (6, 6),
    "mia_attention_rel_packed_bf16": (5, 6),
    "mia_attention_rel_packed_ik_bf16": (6, 6),
    "mia_attention_rel_packed_bwd_f32": (10, 6),
    "mia_attention_rel_packed_ik_bwd_f32": (11, 6),
    "mia_attention_rel_packed_bwd_bf16": (10, 6),
    "mia_attention_rel_packed_ik_bwd_bf16": (12, 6),
    "mia_attention_rel_f32": (7, 5),  # bh, n, d, kh, kw
    "mia_attention_rel_bwd_f32": (14, 5),
    "mia_attention_dense_f32": (5, 3),  # bh, n, d
    "mia_attention_rel_win_f32": (6, 6),  # batch, hg, wg, heads, d, ws
    "mia_attention_rel_win_bwd_f32": (13, 6),
}


@functools.cache
def _kernel_function(name: str):
    fn = getattr(load_library(), name)
    pointers, ints = _ARGTYPES[name]
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check_operand(label: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if (t.dtype != dtype or t.device != device or tuple(t.shape) != tuple(shape)
            or not t.is_contiguous() or t.data_ptr() % 16):
        raise ValueError(
            f"{label} must be a contiguous, 16-byte aligned {dtype} {tuple(shape)} tensor "
            f"on {device}, got {t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _geometry(label, qkv, k_hw, num_heads, dtype=torch.float32):
    """Check what every attention launch needs; return (b, n, d)."""
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
    _check_operand(f"{label} qkv", qkv, qkv.shape, qkv.device, dtype)
    return b, n, d


def _call(label, symbol, qkv, tensors, k_hw, num_heads, scale):
    """Call C entry ``symbol`` with the tensors' pointers (None → NULL) on
    the current stream; raise if it reports an error."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        err = _kernel_function(symbol)(
            *(None if t is None else t.data_ptr() for t in tensors),
            b, n, num_heads, _head_dim(qkv, num_heads), k_h, k_w, float(scale), stream,
        )
    if err != 0:
        raise RuntimeError(f"{label} launch failed: cudaError {err}")


def _rel_shapes(kernel, qkv, k_hw, num_heads):
    """Shapes of K2's two tables or K3's two rel-term tensors."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    if kernel == "K2":
        d = _head_dim(qkv, num_heads)
        return (n // k_w * k_h, d), (k_w * k_w, d)
    return (b * num_heads, n, k_h), (b * num_heads, n, k_w)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _count(wrapper, qkv) -> None:
    """One launch of the float32 kernel (``launches``) or of its bfloat16
    instance (``bf16_launches``)."""
    if qkv.dtype == torch.bfloat16:
        wrapper.bf16_launches += 1
    else:
        wrapper.launches += 1


def _launch_forward(kernel, qkv, rel_a, rel_b, scale, k_hw, num_heads, with_lse):
    """Launch K2 or K3 on float32 operands (3xTF32) or bfloat16 ones (the
    bfloat16 tensor-core instance): the rel operands, the output and K2's
    rel-term scratch take ``qkv``'s dtype, the log-sum-exp is float32."""
    dtype = qkv.dtype if qkv.dtype in _SUFFIX else torch.float32
    b, n, d = _geometry(kernel, qkv, k_hw, num_heads, dtype)
    a_shape, b_shape = _rel_shapes(kernel, qkv, k_hw, num_heads)
    _check_operand(f"{kernel} rel operand", rel_a, a_shape, qkv.device, dtype)
    _check_operand(f"{kernel} rel operand", rel_b, b_shape, qkv.device, dtype)
    out = torch.empty((b, n, num_heads * d), dtype=dtype, device=qkv.device)
    lse = torch.empty((b * num_heads, n), dtype=torch.float32, device=qkv.device) if with_lse else None
    tensors = (qkv, rel_a, rel_b, out, lse)
    if kernel == "K2":  # scratch for the rel terms, computed from the tables before the attention
        tensors += (torch.empty((b * num_heads, n, sum(k_hw)), dtype=dtype, device=qkv.device),)
    symbol = ("mia_attention_rel_packed_ik_" if kernel == "K2"
              else "mia_attention_rel_packed_") + _SUFFIX[dtype]
    _call(kernel, symbol, qkv, tensors, k_hw, num_heads, scale)
    return (out, lse) if with_lse else out


def _launch_k2(qkv, rh_flat, rw_flat, scale, k_hw, num_heads, with_lse=False):
    """Launch K2 (``mia_attention_rel_packed_ik_f32``, or ``_bf16`` for
    bfloat16 operands); raise on anything it does not take. ``with_lse`` also returns the per-row log-sum-exp
    ``(B·H, N)`` the backward reads."""
    out = _launch_forward("K2", qkv, rh_flat, rw_flat, scale, k_hw, num_heads, with_lse)
    _count(fused_attention_rel_packed_ik, qkv)
    return out


def _launch_k3(qkv, rel_h, rel_w, scale, k_hw, num_heads, with_lse=False):
    """Launch K3 (``mia_attention_rel_packed_f32``, or ``_bf16`` for
    bfloat16 operands); raise on anything it does not take. ``with_lse`` as for :func:`_launch_k2`."""
    out = _launch_forward("K3", qkv, rel_h, rel_w, scale, k_hw, num_heads, with_lse)
    _count(fused_attention_rel_packed, qkv)
    return out


def _check_backward(label, qkv, out, g, lse, num_heads, dtype):
    b, n, _ = qkv.shape
    hd = out.shape[-1]
    _check_operand(f"{label} out", out, (b, n, hd), qkv.device, dtype)
    _check_operand(f"{label} cotangent", g, (b, n, hd), qkv.device, dtype)
    _check_operand(f"{label} lse", lse, (b * num_heads, n), qkv.device)


def _launch_k3_bwd(qkv, rel_h, rel_w, out, g, lse, scale, k_hw, num_heads):
    """Launch K3's backward (``mia_attention_rel_packed_bwd_f32``, or
    ``_bf16`` for bfloat16 operands) → (dqkv, drel_h, drel_w) in the
    operands' dtype; raise on anything it does not take. ``out`` and ``g``
    take ``qkv``'s dtype, ``lse`` is float32."""
    dtype = qkv.dtype if qkv.dtype in _SUFFIX else torch.float32
    _geometry("K3 backward", qkv, k_hw, num_heads, dtype)
    a_shape, b_shape = _rel_shapes("K3", qkv, k_hw, num_heads)
    _check_operand("K3 backward rel_h", rel_h, a_shape, qkv.device, dtype)
    _check_operand("K3 backward rel_w", rel_w, b_shape, qkv.device, dtype)
    _check_backward("K3 backward", qkv, out, g, lse, num_heads, dtype)
    dqkv = torch.empty_like(qkv)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    delta = torch.empty_like(lse)
    _call("K3 backward", "mia_attention_rel_packed_bwd_" + _SUFFIX[dtype], qkv,
          (qkv, rel_h, rel_w, out, g, lse, dqkv, delta, drel_h, drel_w), k_hw, num_heads, scale)
    _count(fused_attention_rel_packed_bwd, qkv)
    return dqkv, drel_h, drel_w


def _launch_k2_bwd(qkv, rh_flat, rw_flat, out, g, lse, scale, k_hw, num_heads, tables=True):
    """Launch K2's backward (``mia_attention_rel_packed_ik_bwd_f32``, or
    ``_bf16`` for bfloat16 operands) → (dqkv, drh, drw) in the operands'
    dtype; the table gradients only when ``tables`` (else None). The rel
    terms and their cotangent (scratch) take the operands' dtype; the
    bfloat16 entry also takes a float32 ``dq`` scratch, which its kernel Q
    rounds once after adding the routed rel cotangent."""
    dtype = qkv.dtype if qkv.dtype in _SUFFIX else torch.float32
    b, n, d = _geometry("K2 backward", qkv, k_hw, num_heads, dtype)
    k_h, k_w = k_hw
    a_shape, b_shape = _rel_shapes("K2", qkv, k_hw, num_heads)
    _check_operand("K2 backward rh_flat", rh_flat, a_shape, qkv.device, dtype)
    _check_operand("K2 backward rw_flat", rw_flat, b_shape, qkv.device, dtype)
    _check_backward("K2 backward", qkv, out, g, lse, num_heads, dtype)
    dqkv = torch.empty_like(qkv)
    delta = torch.empty_like(lse)
    rel = torch.empty((b * num_heads, n, k_h + k_w), dtype=dtype, device=qkv.device)
    drel = torch.empty_like(rel)
    dthw = (torch.empty((a_shape[0] + b_shape[0], a_shape[1]), dtype=dtype,
                        device=qkv.device) if tables else None)
    tensors = (qkv, rh_flat, rw_flat, out, g, lse, dqkv, delta, rel, drel)
    if dtype == torch.bfloat16:
        tensors += (torch.empty((b, n, num_heads * d), dtype=torch.float32, device=qkv.device),)
    _call("K2 backward", "mia_attention_rel_packed_ik_bwd_" + _SUFFIX[dtype], qkv,
          tensors + (dthw,), k_hw, num_heads, scale)
    _count(fused_attention_rel_packed_ik_bwd, qkv)
    if not tables:
        return dqkv, None, None
    return dqkv, dthw[: a_shape[0]], dthw[a_shape[0]:]


def fused_attention_rel_packed_bwd(qkv, rel_h, rel_w, out, g, lse, scale: float, k_hw,
                                   num_heads: int):
    """K3 backward: a CUDA tensor launches the backward kernels of
    ``csrc/attention_rel.cu`` of the operands' dtype (and raises if it
    cannot); a CPU tensor takes :func:`attention_rel_packed_bwd` (``lse``
    unused) or, in bfloat16, :func:`attention_rel_packed_bwd_bf16`."""
    if qkv.device.type != "cpu":
        return _launch_k3_bwd(qkv, rel_h, rel_w, out, g, lse, scale, k_hw, num_heads)
    if qkv.dtype == torch.bfloat16:
        return attention_rel_packed_bwd_bf16(qkv, rel_h, rel_w, out, g, lse, scale, k_hw,
                                             num_heads)
    return attention_rel_packed_bwd(qkv, rel_h, rel_w, out, g, scale, k_hw, num_heads)


def fused_attention_rel_packed_ik_bwd(qkv, rh_flat, rw_flat, out, g, lse, scale: float, k_hw,
                                      num_heads: int, tables: bool = True):
    """K2 backward, as :func:`fused_attention_rel_packed_bwd` (plain
    versions :func:`attention_rel_packed_ik_bwd` and
    :func:`attention_rel_packed_ik_bwd_bf16`); the table gradients are
    computed only when ``tables``."""
    if qkv.device.type != "cpu":
        return _launch_k2_bwd(qkv, rh_flat, rw_flat, out, g, lse, scale, k_hw, num_heads, tables)
    if qkv.dtype == torch.bfloat16:
        return attention_rel_packed_ik_bwd_bf16(qkv, rh_flat, rw_flat, out, g, lse, scale, k_hw,
                                                num_heads, tables)
    return attention_rel_packed_ik_bwd(qkv, rh_flat, rw_flat, out, g, scale, k_hw, num_heads,
                                       tables)


class _AttentionRelPacked(torch.autograd.Function):
    """K3 with a gradient: ``(qkv, rel_h, rel_w)`` → context."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, scale, k_hw, num_heads):
        qkv, rel_h, rel_w = qkv.contiguous(), rel_h.contiguous(), rel_w.contiguous()
        if qkv.device.type == "cpu" and qkv.dtype == torch.bfloat16:  # the VJP reads its lse
            out, lse = attention_rel_packed_bf16(qkv, rel_h, rel_w, scale, k_hw, num_heads)
        elif qkv.device.type == "cpu":
            out, lse = attention_rel_packed(qkv, rel_h, rel_w, scale, k_hw, num_heads), None
        else:
            out, lse = _launch_k3(qkv, rel_h, rel_w, scale, k_hw, num_heads, with_lse=True)
        ctx.save_for_backward(qkv, rel_h, rel_w, out, lse)
        ctx.cfg = (scale, k_hw, num_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, rel_h, rel_w, out, lse = ctx.saved_tensors
        dqkv, drel_h, drel_w = fused_attention_rel_packed_bwd(
            qkv, rel_h, rel_w, out, g.contiguous(), lse, *ctx.cfg)
        return dqkv, drel_h, drel_w, None, None, None


class _AttentionRelPackedIK(torch.autograd.Function):
    """K2 with a gradient: ``(qkv, rh_flat, rw_flat)`` → context; the tables'
    gradient is computed only where autograd asks for it (they are frozen
    under LoRA)."""

    @staticmethod
    def forward(ctx, qkv, rh_flat, rw_flat, scale, k_hw, num_heads):
        qkv, rh_flat, rw_flat = qkv.contiguous(), rh_flat.contiguous(), rw_flat.contiguous()
        if qkv.device.type == "cpu" and qkv.dtype == torch.bfloat16:  # the VJP reads its lse
            out, lse = attention_rel_packed_bf16(
                qkv, *window_rel_terms(qkv, rh_flat, rw_flat, k_hw, num_heads), scale, k_hw,
                num_heads)
        elif qkv.device.type == "cpu":
            out = attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale, k_hw, num_heads)
            lse = None
        else:
            out, lse = _launch_k2(qkv, rh_flat, rw_flat, scale, k_hw, num_heads, with_lse=True)
        ctx.save_for_backward(qkv, rh_flat, rw_flat, out, lse)
        ctx.cfg = (scale, k_hw, num_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        qkv, rh_flat, rw_flat, out, lse = ctx.saved_tensors
        tables = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dqkv, drh, drw = fused_attention_rel_packed_ik_bwd(
            qkv, rh_flat, rw_flat, out, g.contiguous(), lse, *ctx.cfg, tables=tables)
        return dqkv, drh, drw, None, None, None


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def fused_attention_rel_packed(qkv, rel_h, rel_w, scale: float, k_hw, num_heads: int) -> torch.Tensor:
    """K3: global rel-pos attention with precomputed head-major rel terms.

    A CUDA tensor launches ``csrc/attention_rel.cu`` (and raises if it
    cannot); a CPU tensor takes :func:`attention_rel_packed`. float32 or
    bfloat16 operands (``qkv`` and the rel terms of one dtype). Differentiable
    through the backward kernels of the operands' dtype when an input
    requires a gradient.
    """
    if _needs_grad(qkv, rel_h, rel_w):
        return _AttentionRelPacked.apply(qkv, rel_h, rel_w, scale, k_hw, num_heads)
    if qkv.device.type == "cpu":
        return attention_rel_packed(qkv, rel_h, rel_w, scale, k_hw, num_heads)
    return _launch_k3(qkv, rel_h, rel_w, scale, k_hw, num_heads)


def fused_attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale: float, k_hw,
                                  num_heads: int) -> torch.Tensor:
    """K2: windowed rel-pos attention with the rel terms computed from the tables.

    A CUDA tensor launches ``csrc/attention_rel.cu`` (and raises if it
    cannot); a CPU tensor takes :func:`attention_rel_packed_ik`. float32 or
    bfloat16 operands (``qkv`` and the tables of one dtype). Differentiable
    through the backward kernels of the operands' dtype when an input
    requires a gradient.
    """
    if _needs_grad(qkv, rh_flat, rw_flat):
        return _AttentionRelPackedIK.apply(qkv, rh_flat, rw_flat, scale, k_hw, num_heads)
    if qkv.device.type == "cpu":
        return attention_rel_packed_ik(qkv, rh_flat, rw_flat, scale, k_hw, num_heads)
    return _launch_k2(qkv, rh_flat, rw_flat, scale, k_hw, num_heads)


# ---------------------------------------------------------------------------
# K6, K7, K8: head-major operands, dense bias, windows on the token grid
# ---------------------------------------------------------------------------


def attention_rel(q, k, v, rel_h, rel_w, scale: float, k_hw) -> torch.Tensor:
    """Plain K6: head-major ``q, k, v (B·H, N, D)`` and rel terms
    ``(B·H, N, k_h)``, ``(B·H, N, k_w)`` → ``(B·H, N, D)``."""
    bh, n, _ = q.shape
    k_h, k_w = k_hw
    if n != k_h * k_w:
        raise ValueError(f"token count {n} != k_h*k_w {k_h * k_w}")
    bias = rel_h.reshape(bh, n, k_h, 1) + rel_w.reshape(bh, n, 1, k_w)
    return attention_dense(q, k, v, bias.reshape(bh, n, n), scale)


def attention_dense(q, k, v, bias, scale: float) -> torch.Tensor:
    """Plain K7: ``softmax(q·kᵀ·scale + bias)·v`` with ``bias (B·H, N, N)``."""
    return ((q * scale) @ k.transpose(-2, -1) + bias).softmax(-1) @ v


def _pad_grid(x, ws: int, fill=None):
    """Pad ``(B, H, W, C)`` on the bottom and right to whole windows with the
    row ``fill`` ``(C,)`` (zeros when None); exact and differentiable."""
    b, h, w, c = x.shape
    pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
    row = x.new_zeros(c) if fill is None else fill
    if pad_w:
        x = torch.cat([x, row.expand(b, h, pad_w, c)], 2)
    if pad_h:
        x = torch.cat([x, row.expand(b, pad_h, w + pad_w, c)], 1)
    return x


def partition_rel_win(qkv, rel_h, rel_w, bias_kv, ws: int, num_heads: int):
    """K8's operands as whole windows: the pad slots of the ``(B, Hg, Wg, 3·H·D)``
    qkv grid filled with ``bias_kv``, those of the rel terms with zeros, all
    three partitioned → packed qkv ``(B·nW, ws², 3·H·D)`` and rel terms
    ``(B·nW·H, ws², ws)`` twice (window-major, then head)."""
    b, three_hd = qkv.shape[0], qkv.shape[-1]
    windows, (hp, wp) = window_partition(_pad_grid(qkv, ws, bias_kv.reshape(-1)), ws)
    n_win = windows.shape[0]

    def rel_windows(rel):  # (B·H, Hg, Wg, ws) → (B·nW·H, ws·ws, ws)
        r = _pad_grid(rel, ws).reshape(b, num_heads, hp // ws, ws, wp // ws, ws, ws)
        return r.permute(0, 2, 4, 1, 3, 5, 6).reshape(n_win * num_heads, ws * ws, ws)

    return windows.reshape(n_win, ws * ws, three_hd), rel_windows(rel_h), rel_windows(rel_w)


def attention_rel_win(qkv, rel_h, rel_w, bias_kv, scale: float, ws: int,
                      num_heads: int) -> torch.Tensor:
    """Plain K8: partition the qkv grid and the rel terms into whole windows
    (:func:`partition_rel_win`), attend within each window (pad slots are
    keys), unpartition and drop the pad queries → ``(B, Hg, Wg, H·D)``."""
    hg, wg = qkv.shape[1:3]
    out = attention_rel_packed(*partition_rel_win(qkv, rel_h, rel_w, bias_kv, ws, num_heads),
                               scale, (ws, ws), num_heads)
    return window_unpartition(out.view(-1, ws, ws, out.shape[-1]), ws, (hg, wg))


def attention_dense_bwd(q, k, v, bias, g, scale: float):
    """Plain VJP of K7 (the JAX package's ``_bwd`` of ``fused_attention``, which
    is tensor code there too): cotangent ``g (B·H, N, D)`` → ``(dq, dk, dv,
    dbias)`` with ``dbias = ds``. Materialises the ``(B·H, N, N)``
    probabilities, ``dp`` and ``ds``."""
    p = ((q * scale) @ k.transpose(-2, -1) + bias).softmax(-1)
    dv = p.transpose(-2, -1) @ g
    dp = g @ v.transpose(-2, -1)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    return (ds @ k) * scale, (ds.transpose(-2, -1) @ q) * scale, dv, ds


def attention_rel_bwd(q, k, v, rel_h, rel_w, out, g, scale: float, k_hw):
    """Plain VJP of K6 (``_rel_bwd`` semantics): from the forward's output and
    the cotangent ``g (B·H, N, D)`` → ``(dq, dk, dv, drel_h, drel_w)`` in the
    shapes of the inputs; ``drel_h[n, j]`` sums ``ds[n, k]`` over the keys of
    grid row ``j``, ``drel_w`` over those of column ``j``."""
    bh, n, _ = q.shape
    k_h, k_w = k_hw
    bias = (rel_h.reshape(bh, n, k_h, 1) + rel_w.reshape(bh, n, 1, k_w)).reshape(bh, n, n)
    p = ((q * scale) @ k.transpose(-2, -1) + bias).softmax(-1)
    delta = (g * out).sum(-1, keepdim=True)
    dv = p.transpose(-2, -1) @ g
    ds = p * (g @ v.transpose(-2, -1) - delta)
    ds4 = ds.reshape(bh, n, k_h, k_w)
    return (ds @ k) * scale, (ds.transpose(-2, -1) @ q) * scale, dv, ds4.sum(-1), ds4.sum(-2)


def attention_rel_win_bwd(qkv, rel_h, rel_w, bias_kv, out, g, scale: float, ws: int,
                          num_heads: int):
    """Plain VJP of K8 (``_rel_win_bwd`` semantics): ``out`` and its cotangent
    ``g`` ``(B, Hg, Wg, H·D)`` → ``(dqkv, drel_h, drel_w, dbias_kv)``. The K3
    VJP on whole windows (the pad queries carry a zero cotangent), with the
    real slots unpartitioned back to the grid and the pad slots' ``dk`` and
    ``dv`` summed into rows 1 and 2 of ``dbias_kv``; row 0 is zero."""
    b, hg, wg, three_hd = qkv.shape
    hd = three_hd // 3
    packed = partition_rel_win(qkv, rel_h, rel_w, bias_kv, ws, num_heads)
    out_w, (hp, wp) = window_partition(out, ws)
    g_w, _ = window_partition(g, ws)
    n_win = out_w.shape[0]
    dqkv_w, drh_w, drw_w = attention_rel_packed_bwd(
        *packed, out_w.reshape(n_win, ws * ws, hd), g_w.reshape(n_win, ws * ws, hd), scale,
        (ws, ws), num_heads)
    dqkv_w = dqkv_w.view(n_win, ws, ws, three_hd)
    pad = 1.0 - window_partition(qkv.new_ones(b, hg, wg, 1), ws)[0]
    dbias_kv = (dqkv_w * pad).sum((0, 1, 2)).view(3, hd).clone()
    dbias_kv[0] = 0.0

    def rel_grid(rel):  # (B·nW·H, ws·ws, ws) → (B·H, Hg, Wg, ws)
        r = rel.reshape(b, hp // ws, wp // ws, num_heads, ws, ws, ws)
        r = r.permute(0, 3, 1, 4, 2, 5, 6).reshape(b * num_heads, hp, wp, ws)
        return r[:, :hg, :wg].contiguous()

    dqkv = window_unpartition(dqkv_w, ws, (hg, wg)).contiguous()
    return dqkv, rel_grid(drh_w), rel_grid(drw_w), dbias_kv


def _check_head_major(label, q, k, v):
    """Check K6's and K7's operands; return (bh, n, d)."""
    if q.dim() != 3:
        raise ValueError(f"{label} needs (B·H, N, D) operands, got {tuple(q.shape)}")
    bh, n, d = q.shape
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{label} is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    if q.device.type != "cuda":
        raise ValueError(f"{label} needs a CUDA tensor, got {q.device}")
    if bh >= 65536 or bh * n * d >= 2 ** 31:
        raise ValueError(f"{label}: shape {tuple(q.shape)} exceeds the launch grid or int32")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(f"{label} {name}", t, (bh, n, d), q.device)
    return bh, n, d


def _launch_on_stream(label, symbol, device, *args):
    """Call C entry ``symbol`` with ``args`` (None → NULL) and the current
    stream; raise if it reports an error."""
    with torch.cuda.device(device):
        err = _kernel_function(symbol)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{label} launch failed: cudaError {err}")


def _check_k6(label, q, k, v, rel_h, rel_w, k_hw):
    bh, n, d = _check_head_major(label, q, k, v)
    k_h, k_w = k_hw
    if n != k_h * k_w:
        raise ValueError(f"{label}: token count {n} != k_h*k_w {k_h * k_w}")
    _check_operand(f"{label} rel_h", rel_h, (bh, n, k_h), q.device)
    _check_operand(f"{label} rel_w", rel_w, (bh, n, k_w), q.device)
    return bh, n, d


def _launch_k6(q, k, v, rel_h, rel_w, scale, k_hw, with_lse=False):
    """Launch K6 (``mia_attention_rel_f32``); raise on anything it does not
    take. ``with_lse`` also returns the per-row log-sum-exp ``(B·H, N)`` the
    backward reads."""
    bh, n, d = _check_k6("K6", q, k, v, rel_h, rel_w, k_hw)
    out = torch.empty_like(q)
    lse = torch.empty((bh, n), dtype=torch.float32, device=q.device) if with_lse else None
    _launch_on_stream("K6", "mia_attention_rel_f32", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), rel_h.data_ptr(), rel_w.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(), bh, n, d, *k_hw, float(scale))
    fused_attention_rel.launches += 1
    return (out, lse) if with_lse else out


def _launch_k6_bwd(q, k, v, rel_h, rel_w, out, g, lse, scale, k_hw):
    """Launch K6's backward (``mia_attention_rel_bwd_f32``) → (dq, dk, dv,
    drel_h, drel_w); raise on anything it does not take."""
    bh, n, d = _check_k6("K6 backward", q, k, v, rel_h, rel_w, k_hw)
    _check_operand("K6 backward out", out, (bh, n, d), q.device)
    _check_operand("K6 backward cotangent", g, (bh, n, d), q.device)
    _check_operand("K6 backward lse", lse, (bh, n), q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    delta = torch.empty_like(lse)
    _launch_on_stream("K6 backward", "mia_attention_rel_bwd_f32", q.device,
                      *(t.data_ptr() for t in (q, k, v, rel_h, rel_w, out, g, lse, dq, dk, dv,
                                               delta, drel_h, drel_w)),
                      bh, n, d, *k_hw, float(scale))
    fused_attention_rel_bwd.launches += 1
    return dq, dk, dv, drel_h, drel_w


def _launch_k7(q, k, v, bias, scale):
    """Launch K7 (``mia_attention_dense_f32``); raise on anything it does not take."""
    bh, n, d = _check_head_major("K7", q, k, v)
    _check_operand("K7 bias", bias, (bh, n, n), q.device)
    out = torch.empty_like(q)
    _launch_on_stream("K7", "mia_attention_dense_f32", q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), bias.data_ptr(), out.data_ptr(), bh, n, d, float(scale))
    fused_attention.launches += 1
    return out


def _check_k8(label, qkv, rel_h, rel_w, bias_kv, ws, num_heads):
    """Check K8's operands; return (b, hg, wg, d, ws, windows per image)."""
    if qkv.dim() != 4:
        raise ValueError(f"{label} needs a (B, Hg, Wg, 3·H·D) qkv grid, got {tuple(qkv.shape)}")
    b, hg, wg, _ = qkv.shape
    d = _head_dim(qkv, num_heads)
    ws = int(ws)
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{label} is built for head dims {KERNEL_HEAD_DIMS}, got {d}")
    if qkv.device.type != "cuda":
        raise ValueError(f"{label} needs a CUDA tensor, got {qkv.device}")
    if ws <= 0:
        raise ValueError(f"{label} window size must be positive, got {ws}")
    n_win = -(-hg // ws) * -(-wg // ws)
    if b * n_win >= 65536 or num_heads >= 65536 or qkv.numel() >= 2 ** 31:
        raise ValueError(f"{label}: qkv shape {tuple(qkv.shape)} exceeds the launch grid or int32")
    _check_operand(f"{label} qkv", qkv, qkv.shape, qkv.device)
    _check_operand(f"{label} rel_h", rel_h, (b * num_heads, hg, wg, ws), qkv.device)
    _check_operand(f"{label} rel_w", rel_w, (b * num_heads, hg, wg, ws), qkv.device)
    _check_operand(f"{label} bias_kv", bias_kv, (3, num_heads * d), qkv.device)
    return b, hg, wg, d, ws, n_win


def _launch_k8(qkv, rel_h, rel_w, bias_kv, scale, ws, num_heads, with_lse=False):
    """Launch K8 (``mia_attention_rel_win_f32``); raise on anything it does
    not take. ``with_lse`` also returns the log-sum-exp of every real query by
    token, ``(B·H, Hg·Wg)``, which the backward reads."""
    b, hg, wg, d, ws, _ = _check_k8("K8", qkv, rel_h, rel_w, bias_kv, ws, num_heads)
    out = torch.empty((b, hg, wg, num_heads * d), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b * num_heads, hg * wg), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    _launch_on_stream("K8", "mia_attention_rel_win_f32", qkv.device, qkv.data_ptr(),
                      rel_h.data_ptr(), rel_w.data_ptr(), bias_kv.data_ptr(), out.data_ptr(),
                      None if lse is None else lse.data_ptr(),
                      b, hg, wg, num_heads, d, ws, float(scale))
    fused_attention_rel_win.launches += 1
    return (out, lse) if with_lse else out


_BWD_TILE = 64  # key rows per block of the backward template (kTcTile in csrc/tf32_mma.cuh)


def _launch_k8_bwd(qkv, rel_h, rel_w, bias_kv, out, g, lse, scale, ws, num_heads):
    """Launch K8's backward (``mia_attention_rel_win_bwd_f32``) → (dqkv,
    drel_h, drel_w, dbias_kv); raise on anything it does not take."""
    b, hg, wg, d, ws, n_win = _check_k8("K8 backward", qkv, rel_h, rel_w, bias_kv, ws, num_heads)
    hd = num_heads * d
    _check_operand("K8 backward out", out, (b, hg, wg, hd), qkv.device)
    _check_operand("K8 backward cotangent", g, (b, hg, wg, hd), qkv.device)
    _check_operand("K8 backward lse", lse, (b * num_heads, hg * wg), qkv.device)
    dqkv = torch.empty_like(qkv)
    drel_h, drel_w = torch.empty_like(rel_h), torch.empty_like(rel_w)
    delta = torch.empty_like(lse)
    # one partial row of pad-slot dk | dv per (window, key tile), summed by the reduce kernel
    dpad = torch.empty((b * n_win * -(-ws * ws // _BWD_TILE), 2, hd), dtype=torch.float32,
                       device=qkv.device)
    dbias_kv = torch.empty_like(bias_kv)
    _launch_on_stream("K8 backward", "mia_attention_rel_win_bwd_f32", qkv.device,
                      *(t.data_ptr() for t in (qkv, rel_h, rel_w, bias_kv, out, g, lse, dqkv,
                                               delta, drel_h, drel_w, dpad, dbias_kv)),
                      b, hg, wg, num_heads, d, ws, float(scale))
    fused_attention_rel_win_bwd.launches += 1
    return dqkv, drel_h, drel_w, dbias_kv


def fused_attention_rel_bwd(q, k, v, rel_h, rel_w, out, g, lse, scale: float, k_hw):
    """K6 backward: a CUDA tensor launches the tensor-core backward kernels
    of ``csrc/attention_bwd_tc.cuh`` (C entry in ``csrc/attention_rel.cu``)
    and raises if it cannot; a CPU tensor takes :func:`attention_rel_bwd`
    (``lse`` unused)."""
    if q.device.type == "cpu":
        return attention_rel_bwd(q, k, v, rel_h, rel_w, out, g, scale, k_hw)
    return _launch_k6_bwd(q, k, v, rel_h, rel_w, out, g, lse, scale, k_hw)


def fused_attention_rel_win_bwd(qkv, rel_h, rel_w, bias_kv, out, g, lse, scale: float, ws: int,
                                num_heads: int):
    """K8 backward, as :func:`fused_attention_rel_bwd`; the plain version is
    :func:`attention_rel_win_bwd`."""
    if qkv.device.type == "cpu":
        return attention_rel_win_bwd(qkv, rel_h, rel_w, bias_kv, out, g, scale, ws, num_heads)
    return _launch_k8_bwd(qkv, rel_h, rel_w, bias_kv, out, g, lse, scale, ws, num_heads)


class _AttentionRel(torch.autograd.Function):
    """K6 with a gradient: ``(q, k, v, rel_h, rel_w)`` → context."""

    @staticmethod
    def forward(ctx, q, k, v, rel_h, rel_w, scale, k_hw):
        q, k, v, rel_h, rel_w = (t.contiguous() for t in (q, k, v, rel_h, rel_w))
        if q.device.type == "cpu":
            out, lse = attention_rel(q, k, v, rel_h, rel_w, scale, k_hw), None
        else:
            out, lse = _launch_k6(q, k, v, rel_h, rel_w, scale, k_hw, with_lse=True)
        ctx.save_for_backward(q, k, v, rel_h, rel_w, out, lse)
        ctx.cfg = (scale, k_hw)
        return out

    @staticmethod
    def backward(ctx, g):
        *operands, lse = ctx.saved_tensors
        return (*fused_attention_rel_bwd(*operands, g.contiguous(), lse, *ctx.cfg), None, None)


class _AttentionDense(torch.autograd.Function):
    """K7 with a gradient: ``(q, k, v, bias)`` → context. The backward is
    :func:`attention_dense_bwd` on every device, as in the JAX package, and
    materialises ``(B·H, N, N)`` tensors."""

    @staticmethod
    def forward(ctx, q, k, v, bias, scale):
        q, k, v, bias = (t.contiguous() for t in (q, k, v, bias))
        out = attention_dense(q, k, v, bias, scale) if q.device.type == "cpu" else _launch_k7(
            q, k, v, bias, scale)
        ctx.save_for_backward(q, k, v, bias)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        return (*attention_dense_bwd(*ctx.saved_tensors, g, ctx.scale), None)


class _AttentionRelWin(torch.autograd.Function):
    """K8 with a gradient: ``(qkv, rel_h, rel_w, bias_kv)`` → context grid."""

    @staticmethod
    def forward(ctx, qkv, rel_h, rel_w, bias_kv, scale, ws, num_heads):
        qkv, rel_h, rel_w, bias_kv = (t.contiguous() for t in (qkv, rel_h, rel_w, bias_kv))
        if qkv.device.type == "cpu":
            out, lse = attention_rel_win(qkv, rel_h, rel_w, bias_kv, scale, ws, num_heads), None
        else:
            out, lse = _launch_k8(qkv, rel_h, rel_w, bias_kv, scale, ws, num_heads, with_lse=True)
        ctx.save_for_backward(qkv, rel_h, rel_w, bias_kv, out, lse)
        ctx.cfg = (scale, ws, num_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        *operands, lse = ctx.saved_tensors
        return (*fused_attention_rel_win_bwd(*operands, g.contiguous(), lse, *ctx.cfg),
                None, None, None)


def fused_attention_rel(q, k, v, rel_h, rel_w, scale: float, k_hw) -> torch.Tensor:
    """K6: ``softmax(q·kᵀ·scale + rel_h⊕rel_w)·v`` on head-major operands;
    ``N`` must equal ``k_hw[0]·k_hw[1]`` and needs no alignment. A CUDA tensor
    launches K3's tensor-core instance on head-major strides (C entry in
    ``csrc/attention_rel.cu``) or raises; a CPU tensor takes
    :func:`attention_rel`. Differentiable through the backward kernels (K6b)
    when an input requires a gradient."""
    if _needs_grad(q, k, v, rel_h, rel_w):
        return _AttentionRel.apply(q, k, v, rel_h, rel_w, scale, tuple(k_hw))
    if q.device.type == "cpu":
        return attention_rel(q, k, v, rel_h, rel_w, scale, k_hw)
    return _launch_k6(*(t.contiguous() for t in (q, k, v, rel_h, rel_w)), scale, k_hw)


def attention_rel_with_padding(q, k, v, rel_h, rel_w, scale: float, k_hw) -> torch.Tensor:
    """:func:`fused_attention_rel` under the JAX package's name; no padding
    is needed on this card and none is done."""
    return fused_attention_rel(q, k, v, rel_h, rel_w, scale, k_hw)


def fused_attention(q, k, v, bias, scale: float) -> torch.Tensor:
    """K7: ``softmax(q·kᵀ·scale + bias)·v`` with a dense ``(B·H, N, N)`` bias,
    any ``N``. A CUDA tensor launches the tensor-core kernel of
    ``csrc/attention_fwd_tc.cuh`` (C entry in ``csrc/attention_routes.cu``)
    or raises; a CPU tensor takes :func:`attention_dense`. When an input
    requires a gradient the backward is the plain :func:`attention_dense_bwd`
    (no kernel, as in the JAX package), which materialises ``(B·H, N, N)``."""
    if _needs_grad(q, k, v, bias):
        return _AttentionDense.apply(q, k, v, bias, scale)
    if q.device.type == "cpu":
        return attention_dense(q, k, v, bias, scale)
    return _launch_k7(*(t.contiguous() for t in (q, k, v, bias)), scale)


def attention_with_padding(q, k, v, bias, scale: float) -> torch.Tensor:
    """:func:`fused_attention` under the JAX package's name: the TPU form pads
    ``N`` to its block and masks the pad keys; the CUDA kernel masks its ragged
    last tile itself, so nothing is padded here."""
    return fused_attention(q, k, v, bias, scale)


def fused_attention_rel_win(qkv, rel_h, rel_w, bias_kv, scale: float, ws: int,
                            num_heads: int) -> torch.Tensor:
    """K8: windowed rel-pos attention on the unpartitioned ``(B, Hg, Wg, 3·H·D)``
    qkv grid (see the module docstring). A CUDA tensor launches
    ``csrc/attention_routes.cu`` (or raises); a CPU tensor takes
    :func:`attention_rel_win`. Differentiable through the backward kernels
    (K8b) when an input requires a gradient."""
    if _needs_grad(qkv, rel_h, rel_w, bias_kv):
        return _AttentionRelWin.apply(qkv, rel_h, rel_w, bias_kv, scale, int(ws), num_heads)
    if qkv.device.type == "cpu":
        return attention_rel_win(qkv, rel_h, rel_w, bias_kv, scale, ws, num_heads)
    return _launch_k8(*(t.contiguous() for t in (qkv, rel_h, rel_w, bias_kv)), scale, ws,
                      num_heads)


fused_attention_rel_packed.launches = 0
fused_attention_rel_packed_ik.launches = 0
fused_attention_rel_packed.bf16_launches = 0
fused_attention_rel_packed_ik.bf16_launches = 0
fused_attention_rel_packed_bwd.launches = 0
fused_attention_rel_packed_ik_bwd.launches = 0
fused_attention_rel_packed_bwd.bf16_launches = 0
fused_attention_rel_packed_ik_bwd.bf16_launches = 0
fused_attention_rel.launches = 0
fused_attention_rel_bwd.launches = 0
fused_attention.launches = 0
fused_attention_rel_win.launches = 0
fused_attention_rel_win_bwd.launches = 0
