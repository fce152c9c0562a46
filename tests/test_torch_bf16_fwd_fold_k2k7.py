"""CPU models of the orders of the bfloat16 K2 and K7 forwards on the
warpgroup kernels (``csrc/attention_fwd_wgmma.cuh``), held against the port's
plain bfloat16 K2 and K7 and against the Pallas K2
(``fused_attention_rel_packed_ik``) and K7 (``fused_attention``) run on
bfloat16 inputs in interpret mode.

K2 forms its rel terms inside the kernel, as the Pallas kernel's candidate
product does: ``rel_h[r, j] = q_r . rh[y_r k_h + j]``, ``rel_w[r, j] = q_r .
rw[x_r k_w + j]`` from the UNSCALED q, each a float32 sum of the exact
products in kernel R's order (16 chunks of 4 in turn, each chunk
``(a0 b0 + a1 b1) + (a2 b2 + a3 b3)``) rounded once to bfloat16, before q is
scaled. Then it folds them into ``S = q_aug . k_aug^T`` as K3 does
(``test_torch_bf16_fwd_fold.py``). K7 forms ``S = (q . k^T) * scale + bias``
in float32, ``_attn_kernel``'s order: the scale multiplies the float32
product, q is not scaled in bfloat16.

Windows of at most 200 keys take one walk: the rows' exact maximum m, ``e =
exp(S - m)``, ``l = sum e``, ``p = bf16(e / l)``. Longer rows take the two
walks of the statistics pass (the online (m, l) over 64-key tiles, then S
again). Either way ``O += p . V`` over the same 64-key tiles in float32, and
``out = bf16(O)``, ``lse = m + log l``. A row whose maximum is still -inf
takes 0 as its reference point (K7's guard).

The measure is ``test_torch_bf16_kernels.py``'s (``_agreement``): against the
plain version at most ``PLAIN_ULPS`` and at least 99% bit-equal; against
the Pallas kernel the plain version's own distance plus one ulp, at least
99% bit-equal.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from mia_tpu.ops.attention import attention_with_padding as jax_k7
from mia_tpu.ops.attention import fused_attention_rel_packed_ik as jax_k2

import torch
from test_torch_bf16_bwd_fold import fold_operands
from test_torch_bf16_fwd_fold import PLAIN_ULPS, _packed, _round, _tiles
from test_torch_bf16_kernels import MIN_EQUAL, _agreement, _bf16, _t

from mia_tpu_torch.ops import attention

D = 64
ONE_WALK_KEYS = 200  # the window kernel's S product, m64n200k16


def k2_terms(qkv, rh_flat, rw_flat, k_hw, heads):
    """K2's rel terms as the kernel forms them → (rel_h, rel_w) head-major
    ``(B*H, n, k_h)``, ``(B*H, n, k_w)`` in bfloat16."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    q = qkv[..., : heads * D].reshape(b, n, heads, D).transpose(1, 2).float()  # (B, H, n, D)
    y, x = torch.arange(n) // k_w, torch.arange(n) % k_w
    rh = rh_flat.float().view(n // k_w, k_h, D)[y]  # (n, k_h, D): the rows each token reads
    rw = rw_flat.float().view(k_w, k_w, D)[x]
    terms = []
    for table in (rh, rw):
        prod = q[:, :, :, None, :] * table  # exact: bfloat16 times bfloat16
        chunks = (prod[..., 0::4] + prod[..., 1::4]) + (prod[..., 2::4] + prod[..., 3::4])
        acc = torch.zeros(prod.shape[:-1])
        for c in range(D // 4):  # in turn, as kernel R
            acc = acc + chunks[..., c]
        terms.append(acc.to(torch.bfloat16).reshape(b * heads, n, -1))
    return terms[0], terms[1]


def softmax_pv(s, v, one_walk):
    """From the float32 scores (B*H, n, n): P = bf16(exp(S - m) / l) by the
    one walk or the two, ``O += P . V`` over 64-key tiles → (O float32, lse)."""
    n = s.shape[-1]
    if one_walk:
        m = s.amax(-1)
        ms = torch.where(m == -torch.inf, 0.0, m)
        e = torch.exp(s - ms[..., None])
        l = e.sum(-1)
    else:
        m = torch.full(s.shape[:2], -torch.inf)
        l = torch.zeros(s.shape[:2])
        for k0, k1 in _tiles(n):
            mn = torch.maximum(m, s[..., k0:k1].amax(-1))
            ms = torch.where(mn == -torch.inf, 0.0, mn)
            l = l * torch.exp(m - ms) + torch.exp(s[..., k0:k1] - ms[..., None]).sum(-1)
            m = mn
        ms = torch.where(m == -torch.inf, 0.0, m)
        e = torch.exp(s - ms[..., None])
    p = _round(e / l[..., None])
    o = torch.zeros(*s.shape[:2], v.shape[-1])
    for k0, k1 in _tiles(n):
        o = o + p[..., k0:k1] @ v[:, k0:k1]
    return o, ms + torch.log(l)


def k2_fwd(qkv, rh_flat, rw_flat, scale, k_hw, heads):
    """K2's order → (context in bfloat16, lse (B*H, n), the rel terms)."""
    b, n, _ = qkv.shape
    rel_h, rel_w = k2_terms(qkv, rh_flat, rw_flat, k_hw, heads)
    q_aug, k_aug, v, _ = fold_operands(qkv, rel_h, rel_w, scale, k_hw, heads)
    o, lse = softmax_pv(q_aug @ k_aug.transpose(1, 2), v, n <= ONE_WALK_KEYS)
    return _packed(o, b, heads), lse, (rel_h, rel_w)


def k7_fwd(q, k, v, bias, scale, q_scaled=False):
    """K7's order → context (B*H, n, D) in bfloat16. ``q_scaled``: q * scale
    rounded to bfloat16 first, as K2, K3 and K6 scale q, in place of the
    float32 scores times the scale."""
    if q_scaled:
        s = _round(q.float() * _round(torch.tensor(scale))) @ k.float().transpose(1, 2) + bias
    else:
        s = (q.float() @ k.float().transpose(1, 2)) * scale + bias
    return softmax_pv(s, v.float(), q.shape[1] <= ONE_WALK_KEYS)[0].to(torch.bfloat16)


# K2: (windows, heads, window side); K7: (bh, n, -inf over the first 64 keys of every other row)
K2_CASES = {"windows 14x14": (2, 2, 14), "windows 9x9": (3, 2, 9)}
K7_CASES = {"windows 196": (4, 196, True), "global 256": (2, 256, True), "N=100": (3, 100, False)}


def _k2_case(name, seed):
    b, heads, ws = K2_CASES[name]
    rng = np.random.default_rng(seed)
    n = ws * ws
    qkv = _bf16(rng, b, n, 3 * heads * D)
    rh, rw = _bf16(rng, n, D, scale=0.1), _bf16(rng, n, D, scale=0.1)
    return qkv, rh, rw, heads, (ws, ws)


def _k7_case(name, seed):
    bh, n, masked = K7_CASES[name]
    rng = np.random.default_rng(seed)
    q, k, v = (_bf16(rng, bh, n, D) for _ in range(3))
    bias = rng.standard_normal((bh, n, n)).astype(np.float32)
    if masked:
        bias[:, ::2, :64] = -np.inf
    return q, k, v, bias


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_model_terms_and_forward_match_the_plain_bf16_k2(case):
    """The model's terms within one ulp of the plain ones (an einsum's
    float32 sum in another order) and at least 99% bit-equal; its context
    within ``PLAIN_ULPS`` of the plain bfloat16 K3 fed the model's own terms
    and its lse within 1e-5 of that one's."""
    qkv, rh, rw, heads, k_hw = _k2_case(case, seed=sum(K2_CASES[case]) + 1)
    args = (_t(qkv), _t(rh), _t(rw))
    out, lse, (rel_h, rel_w) = k2_fwd(*args, D ** -0.5, k_hw, heads)
    want_h, want_w = attention.window_rel_terms(args[0], args[1], args[2], k_hw, heads)
    for got_t, want_t in ((rel_h, want_h), (rel_w, want_w)):
        ulps, equal = _agreement(got_t, want_t.float().numpy())
        assert ulps <= 1.0 and equal >= MIN_EQUAL, (ulps, equal)
    want, want_lse = attention.attention_rel_packed_bf16(args[0], rel_h, rel_w, D ** -0.5, k_hw,
                                                         heads)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    ulps, equal = _agreement(out, want.float().numpy())
    assert ulps <= PLAIN_ULPS and equal >= MIN_EQUAL, (ulps, equal)
    assert (lse - want_lse).abs().max().item() <= 1e-5


@functools.cache
def _k2_against_jax(case):
    """The Pallas K2's context on the case's inputs, the inputs as torch
    tensors, and the plain bfloat16 K2's own (ulps, share bit-equal)."""
    qkv, rh, rw, heads, k_hw = _k2_case(case, seed=sum(K2_CASES[case]) + 7)
    want = np.asarray(jax_k2(jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), D ** -0.5, k_hw,
                             heads, None, True), np.float32)
    args = (_t(qkv), _t(rh), _t(rw))
    plain = _agreement(attention.attention_rel_packed_ik(*args, D ** -0.5, k_hw, heads), want)
    return want, args, heads, k_hw, plain


@pytest.mark.parametrize("case", list(K2_CASES))
def test_k2_model_matches_jax_pallas_in_bfloat16(case):
    """The in-kernel terms and the one walk within the plain version's own
    distance to the Pallas K2 plus one ulp, at least 99% bit-equal."""
    want, args, heads, k_hw, (plain_ulps, plain_equal) = _k2_against_jax(case)
    assert plain_ulps <= 2.0 and plain_equal >= MIN_EQUAL, (plain_ulps, plain_equal)
    ulps, equal = _agreement(k2_fwd(*args, D ** -0.5, k_hw, heads)[0], want)
    assert ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL, (ulps, equal, plain_ulps)


@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_model_matches_the_plain_bf16_k7(case):
    """One walk at n <= 200, two past it, the -inf keys guarded: within
    ``PLAIN_ULPS`` of the plain bfloat16 K7, at least 99% bit-equal."""
    q, k, v, bias = (torch.from_numpy(np.asarray(t, np.float32))
                     for t in _k7_case(case, seed=K7_CASES[case][1] + 1))
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    out = k7_fwd(q, k, v, bias, D ** -0.5)
    want = attention.attention_dense_bf16(q, k, v, bias, D ** -0.5)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    ulps, equal = _agreement(out, want.float().numpy())
    assert ulps <= PLAIN_ULPS and equal >= MIN_EQUAL, (ulps, equal)


@functools.cache
def _k7_against_jax(case, scale):
    """The Pallas K7's context (N padded to its 128-row blocks, the pad keys
    masked) on the case's inputs, the inputs as torch tensors, and the plain
    bfloat16 K7's own (ulps, share bit-equal)."""
    q, k, v, bias = _k7_case(case, seed=K7_CASES[case][1] + 7)
    want = np.asarray(jax_k7(*map(jnp.asarray, (q, k, v, bias)), scale), np.float32)
    args = (_t(q), _t(k), _t(v), torch.from_numpy(bias))
    plain = _agreement(attention.attention_dense_bf16(*args, scale), want)
    return want, args, plain


@pytest.mark.parametrize("case", list(K7_CASES))
def test_k7_model_matches_jax_pallas_in_bfloat16(case):
    """K7's order within the plain version's own distance to the Pallas K7
    plus one ulp, at least 99% bit-equal."""
    want, args, (plain_ulps, plain_equal) = _k7_against_jax(case, D ** -0.5)
    assert plain_ulps <= 2.0 and plain_equal >= MIN_EQUAL, (plain_ulps, plain_equal)
    ulps, equal = _agreement(k7_fwd(*args, D ** -0.5), want)
    assert ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL, (ulps, equal, plain_ulps)


def test_k7_scales_the_float32_scores_not_q():
    """Why the K7 instance applies the scale to the float32 accumulator: at
    a scale that is not a power of two (0.1) q scaled in bfloat16 misses the
    Pallas K7, which multiplies the float32 product, and the accumulator
    scale holds. (At head dim 64 the scale is 1/8 and both give the same
    bits.)"""
    want, args, (plain_ulps, plain_equal) = _k7_against_jax("windows 196", 0.1)
    assert plain_ulps <= 2.0 and plain_equal >= MIN_EQUAL, (plain_ulps, plain_equal)
    ulps, equal = _agreement(k7_fwd(*args, 0.1), want)
    assert ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL, (ulps, equal)
    ulps, equal = _agreement(k7_fwd(*args, 0.1, q_scaled=True), want)
    assert not (ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL), (ulps, equal)
    exact = _agreement(k7_fwd(*args, 0.125, q_scaled=True), k7_fwd(*args, 0.125).float().numpy())
    assert exact == (0.0, 1.0)
