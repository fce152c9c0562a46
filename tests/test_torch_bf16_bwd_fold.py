"""A float32/bfloat16 CPU model of the tile order of the bfloat16 K3b / K6b
warpgroup kernel (``csrc/attention_bwd_wgmma.cuh``), held against the port's
plain bfloat16 VJP and against ``jax.vjp`` of the Pallas K3 run in bfloat16 in
interpret mode.

The model does what the kernel does, tile by tile: it forms
``q_aug = [bf16(q * bf16(scale)) | rel_h | rel_w | 0]`` and the one-hot
``k_aug = [k | E_h | E_w | 0]`` (96 or 128 columns at head dim 64, not
sliced), takes ``S = q_aug . k_aug^T`` as one float32 product and
``p = exp(S - lse)`` from the forward's log-sum-exp, rounds ``dS = p (dP -
delta)`` and ``P`` to bfloat16, and sums ``dq_aug = dS . k_aug`` (pass A, over
64-key tiles), ``dk = dS^T . q_aug[:, :D]`` and ``dv = P^T . G`` (pass B, over
64-query tiles) in float32, each tile's product folded into the running sum,
then rounds once: ``dq = dq_aug[:, :D] * scale``, ``drel_h``, ``drel_w`` the
next columns of ``dq_aug``. (The kernel's last tile selects p = 0 for rows
past ``n``; the model's tiles end at ``n``.)

The measure is ``test_torch_bf16_backward.py``'s: the largest distance in
bfloat16 ulps of the reference (the ulp taken at no less than 2^-6 of its max)
and the share of elements bit-equal. Against the plain VJP (the same roundings,
float32 sums in another order) the limit is one ulp for ``dqkv``, ``REL_ULPS``
for the rel gradients, and 99% bit-equal; measured: dqkv 1 ulp at 99.98-99.99%
bit-equal (0 ulps at head dim 80), drel_h and drel_w bit-equal. Against JAX
(whose kernel normalises its own maximum and sum where the port reads the
forward's log-sum-exp) the plain VJP itself reads dqkv 1-5 ulps at 99.78-99.97%
bit-equal on these larger grids, and the model reads the same: the limit is
``JAX_ULPS`` for dqkv, ``REL_ULPS`` for the rel gradients (measured 0.5-2),
99% bit-equal, and no more than the plain VJP's own distance plus one ulp.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.ops.attention import fused_attention_rel_packed as jax_k3

import torch
from test_torch_bf16_backward import REL_ULPS
from test_torch_bf16_kernels import MIN_EQUAL, _agreement, _bf16, _t

from mia_tpu_torch.ops import attention

TILE = 64  # rows of a warpgroup tile
JAX_ULPS = 8.0  # dqkv against JAX on the larger grids (measured: 1-5, as the plain VJP's)
BF = torch.bfloat16


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF).float()


def fold_operands(qkv, rel_h, rel_w, scale, k_hw, heads):
    """(q_aug, k_aug, v) as float32 (B*H, n, .) with the kernel's columns."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    d = qkv.shape[-1] // (3 * heads)
    aug = d + (32 if k_h + k_w <= 32 else 64)
    q, k, v = (t.reshape(b * heads, n, d).float() for t in
               qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    q_aug = torch.zeros(b * heads, n, aug)
    q_aug[..., :d] = _round(q * _round(torch.tensor(scale)))
    q_aug[..., d:d + k_h] = rel_h.float()
    q_aug[..., d + k_h:d + k_h + k_w] = rel_w.float()
    keys = torch.arange(n)
    k_aug = torch.zeros(b * heads, n, aug)
    k_aug[..., :d] = k
    k_aug[:, keys, d + keys // k_w] = 1.0
    k_aug[:, keys, d + k_h + keys % k_w] = 1.0
    return q_aug, k_aug, v, d


def fold_bwd(qkv, rel_h, rel_w, out, g, lse, scale, k_hw, heads):
    """The kernel's tile order on the CPU → (dqkv, drel_h, drel_w) in bfloat16."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    q_aug, k_aug, v, d = fold_operands(qkv, rel_h, rel_w, scale, k_hw, heads)
    g4 = g.reshape(b, n, heads, d).transpose(1, 2).reshape(b * heads, n, d).float()
    o4 = out.reshape(b, n, heads, d).transpose(1, 2).reshape(b * heads, n, d).float()
    delta = (g4 * o4).sum(-1)
    tiles = [(t0, min(t0 + TILE, n)) for t0 in range(0, n, TILE)]

    # pass A: one query tile, streaming key tiles into dq_aug
    dq_aug = torch.zeros_like(q_aug)
    for q0, q1 in tiles:
        acc = torch.zeros(q_aug.shape[0], q1 - q0, q_aug.shape[-1])
        for k0, k1 in tiles:
            s = q_aug[:, q0:q1] @ k_aug[:, k0:k1].transpose(1, 2)
            dp = g4[:, q0:q1] @ v[:, k0:k1].transpose(1, 2)
            p = torch.exp(s - lse[:, q0:q1, None])
            ds = _round(p * (dp - delta[:, q0:q1, None]))
            acc = acc + ds @ k_aug[:, k0:k1]
        dq_aug[:, q0:q1] = acc
    # pass B: one key tile, streaming query tiles into dk and dv
    dk = torch.zeros_like(v)
    dv = torch.zeros_like(v)
    for k0, k1 in tiles:
        acc_k = torch.zeros(v.shape[0], k1 - k0, d)
        acc_v = torch.zeros_like(acc_k)
        for q0, q1 in tiles:
            s_t = k_aug[:, k0:k1] @ q_aug[:, q0:q1].transpose(1, 2)
            dp_t = v[:, k0:k1] @ g4[:, q0:q1].transpose(1, 2)
            p_t = torch.exp(s_t - lse[:, None, q0:q1])
            ds_t = _round(p_t * (dp_t - delta[:, None, q0:q1]))
            acc_v = acc_v + _round(p_t) @ g4[:, q0:q1]
            acc_k = acc_k + ds_t @ q_aug[:, q0:q1, :d]
        dk[:, k0:k1] = acc_k
        dv[:, k0:k1] = acc_v
    heads_first = (b, heads, n, d)
    dqkv = attention._stack_dqkv((dq_aug[..., :d] * scale).to(BF).reshape(heads_first),
                                 dk.to(BF).reshape(heads_first), dv.to(BF).reshape(heads_first),
                                 qkv.shape)
    return dqkv, dq_aug[..., d:d + k_h].to(BF), dq_aug[..., d + k_h:d + k_h + k_w].to(BF)


def _holds(names, got, want, dqkv_ulps=1.0):
    """Each output within its limit of ``want``; returns the readings."""
    readings = {}
    for name, a, w in zip(names, got, want):
        w = np.asarray(w.float() if isinstance(w, torch.Tensor) else w, np.float32)
        assert a.dtype == BF and tuple(a.shape) == w.shape, name
        ulps, equal = _agreement(a, w)
        readings[name] = (ulps, equal)
        limit = dqkv_ulps if name == "dqkv" else REL_ULPS
        assert ulps <= limit and equal >= MIN_EQUAL, (name, ulps, equal)
    return readings


# (batch, heads, head dim, key grid): a 32 x 32 global grid, a 14 x 14
# window, a ragged 20 x 27 grid (odd kw: the kernel's plain rel-row loads) and
# head dim 80
CASES = [(1, 1, 64, (32, 32)), (2, 2, 64, (14, 14)), (1, 1, 64, (20, 27)), (2, 2, 80, (7, 9))]


def _case(b, heads, d, k_hw, seed):
    rng = np.random.default_rng(seed)
    n = k_hw[0] * k_hw[1]
    qkv = _bf16(rng, b, n, 3 * heads * d)
    rel_h, rel_w = _bf16(rng, b * heads, n, k_hw[0]), _bf16(rng, b * heads, n, k_hw[1])
    g = _bf16(rng, b, n, heads * d)
    return qkv, rel_h, rel_w, g


@pytest.mark.parametrize("b,heads,d,k_hw", CASES)
def test_fold_model_matches_the_plain_bf16_vjp(b, heads, d, k_hw):
    qkv, rel_h, rel_w, g = (_t(a) for a in _case(b, heads, d, k_hw, seed=sum(k_hw) + d))
    scale = d ** -0.5
    out, lse = attention.attention_rel_packed_bf16(qkv, rel_h, rel_w, scale, k_hw, heads)
    got = fold_bwd(qkv, rel_h, rel_w, out, g, lse, scale, k_hw, heads)
    want = attention.attention_rel_packed_bwd_bf16(qkv, rel_h, rel_w, out, g, lse, scale, k_hw,
                                                   heads)
    _holds(("dqkv", "drel_h", "drel_w"), got, want)


@pytest.mark.parametrize("b,heads,d,k_hw", CASES)
def test_fold_model_matches_jax_pallas_k3_in_bfloat16(b, heads, d, k_hw):
    qkv, rel_h, rel_w, g = _case(b, heads, d, k_hw, seed=sum(k_hw) + d + 7)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q, rh, rw: jax_k3(q, rh, rw, scale, k_hw, heads, None, True),
                     jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w))
    want = vjp(jnp.asarray(g))
    args = (_t(qkv), _t(rel_h), _t(rel_w))
    out, lse = attention.attention_rel_packed_bf16(*args, scale, k_hw, heads)
    got = fold_bwd(*args, out, _t(g), lse, scale, k_hw, heads)
    names = ("dqkv", "drel_h", "drel_w")
    model = _holds(names, got, want, JAX_ULPS)
    plain = attention.attention_rel_packed_bwd_bf16(*args, out, _t(g), lse, scale, k_hw, heads)
    for name, p in zip(names, plain):  # the fold adds nothing to the plain VJP's distance
        ulps, _ = _agreement(p, np.asarray(want[names.index(name)], np.float32))
        assert model[name][0] <= ulps + 1.0, (name, model[name], ulps)


def test_fold_puts_the_rel_terms_in_the_score_product():
    """S = q_aug . k_aug^T is the scaled score plus rel_h[q, y] + rel_w[q, x]
    exactly: the one-hot columns pick one bfloat16 rel value each."""
    qkv, rel_h, rel_w, _ = (_t(a) for a in _case(1, 2, 64, (6, 10), seed=3))
    q_aug, k_aug, _, d = fold_operands(qkv, rel_h, rel_w, 0.125, (6, 10), 2)
    s = q_aug @ k_aug.transpose(1, 2)
    rel = q_aug[..., d:] @ k_aug[..., d:].transpose(1, 2)
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).reshape(2, 60, 60)
    assert torch.equal(rel, bias)
    assert torch.allclose(s, q_aug[..., :d] @ k_aug[..., :d].transpose(1, 2) + bias, atol=1e-5)
    assert q_aug.shape[-1] == 96 and not k_aug[..., d + 16:].any()
