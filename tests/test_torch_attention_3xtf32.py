"""Why the attention kernels K2, K3, K6, K7 and the backward K2b, K3b, K6b split
every float32 operand for the tensor cores (3xTF32) instead of taking one
TF32 pass.

The kernels of ``mia_tpu_torch/csrc/attention_fwd_tc.cuh`` and
``attention_bwd_tc.cuh`` run the products of the attention forward and
backward on ``mma.sync`` in TF32: each float32 operand x becomes big = x
rounded to TF32 (round to nearest, ties away from zero, on the low 13
mantissa bits) and small = x - big, which the tensor core reads truncated to
TF32; each product is small.big + big.small + big.big with a float32
accumulator. These tests emulate that arithmetic in plain torch on the CPU
(TF32 values multiply exactly in float32) and hold the K3 backward (also on
K6b's head-major operands), the K2/K3 forward (also on K6's head-major
operands) and the K7 forward with its dense bias, computed that way, against
float64: every backward output
within ``BWD_TOL`` of max |float64|, the forward within ``KERNEL_TOL``, as
``chip_smoke.py`` holds the kernels, and one TF32 pass at least 10x further
away. K7's bias may mask keys with -inf; the emulation shows why its online
softmax needs FlashAttention-2's guard. K8's windowed forward and K8b's
backward are in ``test_torch_attention_3xtf32_grid.py``.
"""

import numpy as np
import pytest
import torch

from mia_tpu_torch.ops import attention

BWD_TOL = 1e-4  # chip_smoke.py's tolerance for the backward kernels, per output
KERNEL_TOL = 1e-5  # and for the forward kernels
LSE_TOL = 1e-5  # the forward's log-sum-exp, absolute (tests/test_torch_cuda.py)
KEY_TILE = 64  # keys a streamed tile of the forward kernel
LOW_BITS = 0x1FFF  # the 13 mantissa bits a TF32 value leaves out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 → TF32, round to nearest with ties away from zero (``cvt.rna``)."""
    return ((x.view(torch.int32) + 0x1000) & ~LOW_BITS).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """What the tensor core reads of a float32 register: the top 19 bits."""
    return (x.view(torch.int32) & ~LOW_BITS).view(torch.float32)


def split(x):
    big = tf32_round(x)
    return big, tf32_truncate(x - big)


def mm_3xtf32(a, b):
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_tf32(a, b):
    return tf32_round(a) @ tf32_round(b)


def k3_backward(mm, qkv, rel_h, rel_w, out, g, lse, scale, k_hw, heads):
    """The K3 backward in the kernels' order: S and dP recomputed, p from the
    forward's log-sum-exp, ds = p (dp - delta), then dv, dk, dq; every product
    through ``mm``, the rest in float32."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    g4 = g.reshape(b, n, heads, -1).transpose(1, 2)
    o4 = out.reshape(b, n, heads, -1).transpose(1, 2)
    bias = (rel_h.reshape(b, heads, n, k_h, 1) + rel_w.reshape(b, heads, n, 1, k_w)).reshape(
        b, heads, n, n)
    s = mm(q, k.transpose(-2, -1))
    dp = mm(g4, v.transpose(-2, -1))
    p = torch.exp(s * scale + bias - lse.reshape(b, heads, n, 1))
    delta = (g4 * o4).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dv = mm(p.transpose(-2, -1), g4)
    dk = mm(ds.transpose(-2, -1), q) * scale
    dq = mm(ds, k) * scale
    dqkv = torch.stack([dq, dk, dv], 0).permute(1, 3, 0, 2, 4).reshape(qkv.shape)
    ds5 = ds.reshape(b * heads, n, k_h, k_w)
    return dqkv, ds5.sum(-1), ds5.sum(-2)


def inputs(batch, heads, k_hw, d, seed=0):
    rng = np.random.default_rng(seed)
    n = k_hw[0] * k_hw[1]
    qkv = torch.from_numpy(rng.standard_normal((batch, n, 3 * heads * d), dtype=np.float32))
    rel_h = torch.from_numpy(rng.standard_normal((batch * heads, n, k_hw[0]), dtype=np.float32))
    rel_w = torch.from_numpy(rng.standard_normal((batch * heads, n, k_hw[1]), dtype=np.float32))
    g = torch.from_numpy(rng.standard_normal((batch, n, heads * d), dtype=np.float32))
    return qkv, rel_h, rel_w, g


@pytest.mark.parametrize("batch,heads,k_hw,d", [(2, 2, (16, 16), 64), (2, 2, (16, 16), 80),
                                                (1, 3, (12, 20), 64)])
def test_3xtf32_backward_keeps_float32_accuracy_where_one_pass_does_not(batch, heads, k_hw, d):
    qkv, rel_h, rel_w, g = inputs(batch, heads, k_hw, d)
    scale = d ** -0.5
    b, n, _ = qkv.shape
    # the float32 forward the kernels read: its output and per-row log-sum-exp
    out = attention.attention_rel_packed(qkv, rel_h, rel_w, scale, k_hw, heads)
    q, k, _ = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias = rel_h.reshape(b, heads, n, k_hw[0], 1) + rel_w.reshape(b, heads, n, 1, k_hw[1])
    lse = torch.logsumexp((q * scale) @ k.transpose(-2, -1) + bias.reshape(b, heads, n, n), -1)
    args = (scale, k_hw, heads)
    want = attention.attention_rel_packed_bwd(qkv.double(), rel_h.double(), rel_w.double(),
                                              attention.attention_rel_packed(
                                                  qkv.double(), rel_h.double(), rel_w.double(),
                                                  *args),
                                              g.double(), *args)
    split3 = k3_backward(mm_3xtf32, qkv, rel_h, rel_w, out, g, lse, *args)
    one_pass = k3_backward(mm_tf32, qkv, rel_h, rel_w, out, g, lse, *args)
    for name, w, x3, x1 in zip(("dqkv", "drel_h", "drel_w"), want, split3, one_pass):
        ref = w.abs().max().item()
        err3 = (x3.double() - w).abs().max().item() / ref
        err1 = (x1.double() - w).abs().max().item() / ref
        assert err3 <= BWD_TOL, f"{name}: 3xTF32 off by {err3:.3g} of max |float64|"
        assert err1 >= 10 * err3, f"{name}: one TF32 pass {err1:.3g} against 3xTF32 {err3:.3g}"


def k6_backward(mm, q, k, v, rel_h, rel_w, out, g, lse, scale, k_hw):
    """K6b: K3b's arithmetic on head-major operands (B·H, N, D), the packed
    layout with one head; returns dq, dk, dv, drel_h, drel_w."""
    dqkv, drel_h, drel_w = k3_backward(mm, torch.cat([q, k, v], -1), rel_h, rel_w, out, g, lse,
                                       scale, k_hw, 1)
    return (*dqkv.chunk(3, -1), drel_h, drel_w)


@pytest.mark.parametrize("bh,k_hw", [(3, (14, 14)), (4, (10, 12))])
def test_3xtf32_k6_backward_keeps_float32_accuracy_where_one_pass_does_not(bh, k_hw):
    rng = np.random.default_rng(5)
    d = 64
    n = k_hw[0] * k_hw[1]
    q, k, v, g = (torch.from_numpy(rng.standard_normal((bh, n, d), dtype=np.float32))
                  for _ in range(4))
    rel_h, rel_w = (torch.from_numpy(rng.standard_normal((bh, n, w), dtype=np.float32))
                    for w in k_hw)
    scale = d ** -0.5
    out = attention.attention_rel(q, k, v, rel_h, rel_w, scale, k_hw)
    bias = (rel_h.reshape(bh, n, k_hw[0], 1) + rel_w.reshape(bh, n, 1, k_hw[1])).reshape(bh, n, n)
    lse = torch.logsumexp((q * scale) @ k.transpose(-2, -1) + bias, -1)
    fwd64 = [t.double() for t in (q, k, v, rel_h, rel_w)]
    want = attention.attention_rel_bwd(*fwd64, attention.attention_rel(*fwd64, scale, k_hw),
                                       g.double(), scale, k_hw)
    args = (q, k, v, rel_h, rel_w, out, g, lse, scale, k_hw)
    split3, one_pass = k6_backward(mm_3xtf32, *args), k6_backward(mm_tf32, *args)
    for name, w, x3, x1 in zip(("dq", "dk", "dv", "drel_h", "drel_w"), want, split3, one_pass):
        ref = w.abs().max().item()
        err3 = (x3.double() - w).abs().max().item() / ref
        err1 = (x1.double() - w).abs().max().item() / ref
        assert err3 <= BWD_TOL, f"{name}: 3xTF32 off by {err3:.3g} of max |float64|"
        assert err1 >= 10 * err3, f"{name}: one TF32 pass {err1:.3g} against 3xTF32 {err3:.3g}"


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("magnitude", [1e-3, 1.0, 1e4])
def test_split_is_tf32_and_rebuilds_float32(seed, magnitude):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(4096, dtype=np.float32))
    x = x * magnitude
    big, small = split(x)
    assert not (big.view(torch.int32) & LOW_BITS).any()
    assert not (small.view(torch.int32) & LOW_BITS).any()
    # big is the nearest TF32 value, within half its last place
    assert ((x - big).abs() <= x.abs() * 2.0 ** -11).all()
    # the two parts keep float32 to ~2^-21, one TF32 value to ~2^-11
    rebuilt = (big.double() + small.double() - x.double()).abs()
    assert (rebuilt <= x.abs().double() * 2.0 ** -20).all()


def rz_float32(x64: torch.Tensor) -> torch.Tensor:
    """float64 → float32 rounded toward zero: what the tensor core keeps of a
    sum in its float32 accumulator."""
    x32 = x64.float()
    away = x32.double().abs() > x64.abs()
    return torch.where(away, torch.nextafter(x32, torch.zeros_like(x32)), x32)


def mma_chain(c, a, b, passes):
    """``c + a·b`` as a chain of m16n8k8 MMAs: k in steps of 8, each step's
    product sum exact (TF32 operands) and truncated into the accumulator."""
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in passes:
            c = rz_float32(c.double() + x[..., ks].double() @ y[..., ks, :].double())
    return c


def mma_3xtf32(c, a, b):
    """Three MMAs a step: small·big, big·small, big·big."""
    (a_big, a_small), (b_big, b_small) = split(a), split(b)
    return mma_chain(c, a, b, ((a_small, b_big), (a_big, b_small), (a_big, b_big)))


def mma_tf32(c, a, b):
    return mma_chain(c, a, b, ((tf32_round(a), tf32_round(b)),))


def forward_tiles(mma, q, k, v, bias, scale, chained=False, guard=True, tile=KEY_TILE):
    """The forward kernels' order on head-major q, k, v (..., N, D) and a
    dense bias (..., N, N), K7's operands (K2's and K3's rel bias expanded
    by ``packed_case``): scale·q, then per ``tile`` keys S = Q·Kᵀ through
    ``mma`` from zero, the bias, the online softmax (running max, rescaled
    sum) and the tile's P·V through ``mma`` from zero, folded in as
    O = c·O + P·V (``chained``: P·V added inside the MMA chain to the
    rescaled O); the rest in float32. ``guard``: while a row's running max is
    -inf the update rescales by 0 and subtracts 0 (K7's kernel), instead of
    forming exp(-inf - -inf). Returns the output (..., N, D) and the
    log-sum-exp (..., N)."""
    q = q * scale
    n = q.shape[-2]
    m = torch.full((*q.shape[:-1], 1), -torch.inf)
    l = torch.zeros((*q.shape[:-1], 1))
    o = torch.zeros_like(q)
    for k0 in range(0, n, tile):
        keys = slice(k0, k0 + tile)
        s = mma(torch.zeros(*q.shape[:-1], min(tile, n - k0)), q,
                k[..., keys, :].transpose(-2, -1)) + bias[..., keys]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        ref = torch.where(m_new == -torch.inf, 0.0, m_new) if guard else m_new
        corr = torch.exp(m - ref)
        p = torch.exp(s - ref)
        l = l * corr + p.sum(-1, keepdim=True)
        if chained:
            o = mma(o * corr, p, v[..., keys, :])
        else:
            o = torch.addcmul(mma(torch.zeros_like(o), p, v[..., keys, :]), o, corr)
        m = m_new
    return o / l, (m + torch.log(l))[..., 0]


def packed_case(qkv, rel_h, rel_w, k_hw, heads):
    """K2's and K3's packed operands as K7's: q, k, v (B, H, N, D) and the
    dense rel bias (B, H, N, N)."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    bias = rel_h.reshape(b, heads, n, k_hw[0], 1) + rel_w.reshape(b, heads, n, 1, k_hw[1])
    return q, k, v, bias.reshape(b, heads, n, n)


def head_major_case(bh, k_hw, seed):
    """K6's operands: q, k, v (B·H, N, 64) and the rel terms (B·H, N, k_h),
    (B·H, N, k_w), expanded to the dense bias (B·H, N, N) the kernel adds
    score by score."""
    rng = np.random.default_rng(seed)
    n = k_hw[0] * k_hw[1]
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, 64), dtype=np.float32))
               for _ in range(3))
    rel_h, rel_w = (torch.from_numpy(rng.standard_normal((bh, n, w), dtype=np.float32))
                    for w in k_hw)
    bias = rel_h.reshape(bh, n, k_hw[0], 1) + rel_w.reshape(bh, n, 1, k_hw[1])
    return q, k, v, bias.reshape(bh, n, n)


def dense_case(bh, n, seed, mask_first_tile=False):
    """K7's operands: q, k, v (B·H, N, 64) and a dense bias (B·H, N, N);
    ``mask_first_tile``: every other row's first key tile is -inf."""
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, n, 64), dtype=np.float32))
               for _ in range(3))
    bias = torch.from_numpy(rng.standard_normal((bh, n, n), dtype=np.float32))
    if mask_first_tile:
        bias[:, ::2, :KEY_TILE] = -torch.inf
    return q, k, v, bias


FORWARD_CASES = {  # K2, K3: (batch, heads, k_hw, d); K6, K7: head_major_case's, dense_case's
    "K3 global 32x32": (1, 3, (32, 32), 64),
    "K2 windows 14x14": (4, 3, (14, 14), 64),
    "K3 ragged 20x27": (1, 2, (20, 27), 64),
    "K3 head dim 80": (1, 2, (32, 32), 80),
    "K6 global 32x32": (3, (32, 32), 12),
    "K6 N=35 (5x7)": (4, (5, 7), 13),
    "K7 global 32x32": (3, 1024, 6),
    "K7 windows 14x14": (12, 196, 7),
    "K7 odd N=35": (4, 35, 8),
    "K7 -inf over the first key tile of every other row": (3, 196, 9, True),
}


def forward_case(case):
    """Head-major operands of one forward case (q, k, v, dense bias, scale)
    and the float64 output and log-sum-exp."""
    if case.startswith("K7"):
        q, k, v, bias = dense_case(*FORWARD_CASES[case])
    elif case.startswith("K6"):
        q, k, v, bias = head_major_case(*FORWARD_CASES[case])
    else:
        batch, heads, k_hw, d = FORWARD_CASES[case]
        qkv, rel_h, rel_w, _ = inputs(batch, heads, k_hw, d, seed=3)
        if case.startswith("K2"):  # the rel terms from the two tables, as kernel R computes them
            rng = np.random.default_rng(4)
            n = k_hw[0] * k_hw[1]
            rh, rw = (torch.from_numpy(0.2 * rng.standard_normal((n, d), dtype=np.float32))
                      for _ in range(2))
            rel_h, rel_w = attention.window_rel_terms(qkv, rh, rw, k_hw, heads)
        q, k, v, bias = packed_case(qkv, rel_h, rel_w, k_hw, heads)
    scale = q.shape[-1] ** -0.5
    q64, k64, v64, bias64 = (t.double() for t in (q, k, v, bias))
    want = attention.attention_dense(q64, k64, v64, bias64, scale)
    want_lse = torch.logsumexp((q64 * scale) @ k64.transpose(-2, -1) + bias64, -1)
    return (q, k, v, bias, scale), want, want_lse


def out_err(got, want):
    return (got.double() - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("case", list(FORWARD_CASES))
def test_3xtf32_forward_keeps_float32_accuracy_where_one_pass_does_not(case):
    args, want, want_lse = forward_case(case)
    out3, lse3 = forward_tiles(mma_3xtf32, *args)
    out1, lse1 = forward_tiles(mma_tf32, *args)
    err3, err1 = out_err(out3, want), out_err(out1, want)
    assert err3 <= KERNEL_TOL, f"3xTF32 output off by {err3:.3g} of max |float64|"
    assert err1 >= 10 * err3, f"one TF32 pass {err1:.3g} against 3xTF32 {err3:.3g}"
    lse_err3 = (lse3.double() - want_lse).abs().max().item()
    lse_err1 = (lse1.double() - want_lse).abs().max().item()
    assert lse_err3 <= LSE_TOL, f"3xTF32 log-sum-exp off by {lse_err3:.3g}"
    assert lse_err1 >= 10 * lse_err3, f"one TF32 pass {lse_err1:.3g} against 3xTF32 {lse_err3:.3g}"


def test_forward_folds_each_tiles_product_into_the_output_outside_the_mma_chain():
    """With the tensor core's truncating accumulator, O carried through the
    MMAs of all 16 key tiles of a 1024-token row loses float32 accuracy
    (~1e-5 of max |out|, as measured on the card); each tile's P·V from zero,
    folded in with one rounded multiply-add, keeps it."""
    args, want, _ = forward_case("K3 global 32x32")
    per_tile = out_err(forward_tiles(mma_3xtf32, *args)[0], want)
    chained = out_err(forward_tiles(mma_3xtf32, *args, chained=True)[0], want)
    assert per_tile <= KERNEL_TOL / 4, f"per-tile P·V off by {per_tile:.3g}"
    assert chained >= 4 * per_tile, f"chained {chained:.3g} against per-tile {per_tile:.3g}"


def test_k7_guard_keeps_rows_whose_first_key_tile_is_masked():
    """A row whose whole first key tile is -inf: the plain online-softmax
    update forms exp(-inf - -inf) = NaN and the row stays NaN; with the
    guard (rescale by 0, subtract 0 while the running max is -inf) it
    matches float64."""
    args, want, _ = forward_case("K7 -inf over the first key tile of every other row")
    masked = torch.zeros(want.shape[-2], dtype=torch.bool)
    masked[::2] = True
    guarded, _ = forward_tiles(mma_3xtf32, *args)
    unguarded, _ = forward_tiles(mma_3xtf32, *args, guard=False)
    assert torch.isnan(unguarded[:, masked]).all()
    assert torch.equal(unguarded[:, ~masked], guarded[:, ~masked])
    assert out_err(guarded, want) <= KERNEL_TOL
