"""Why the attention kernels K2, K3 and their backward K2b, K3b split every
float32 operand for the tensor cores (3xTF32) instead of taking one TF32 pass.

The kernels of ``mia_tpu_torch/csrc/attention_fwd_tc.cuh`` and
``attention_bwd_tc.cuh`` run the products of the attention forward and
backward on ``mma.sync`` in TF32: each float32 operand x becomes big = x
rounded to TF32 (round to nearest, ties away from zero, on the low 13
mantissa bits) and small = x - big, which the tensor core reads truncated to
TF32; each product is small.big + big.small + big.big with a float32
accumulator. These tests emulate that arithmetic in plain torch on the CPU
(TF32 values multiply exactly in float32) and hold the K3 backward and the
K2/K3 forward, computed that way, against float64: every backward output
within ``BWD_TOL`` of max |float64|, the forward within ``KERNEL_TOL``, as
``chip_smoke.py`` holds the kernels, and one TF32 pass at least 10x further
away.
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


def forward_tiles(mma, qkv, rel_h, rel_w, scale, k_hw, heads, chained=False):
    """The K2/K3 forward in the kernel's order: scale·q, then per 64-key tile
    S = Q·Kᵀ through ``mma`` from zero, the rel bias, the online softmax
    (running max, rescaled sum) and the tile's P·V through ``mma`` from zero,
    folded in as O = c·O + P·V (``chained``: P·V added inside the MMA chain
    to the rescaled O); the rest in
    float32. Returns the output (B, N, H·D) and the log-sum-exp (B·H, N)."""
    b, n, _ = qkv.shape
    k_h, k_w = k_hw
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    q = q * scale
    bias = (rel_h.reshape(b, heads, n, k_h, 1) + rel_w.reshape(b, heads, n, 1, k_w)).reshape(
        b, heads, n, n)
    m = torch.full((b, heads, n, 1), -torch.inf)
    l = torch.zeros((b, heads, n, 1))
    o = torch.zeros_like(q)
    for k0 in range(0, n, KEY_TILE):
        keys = slice(k0, k0 + KEY_TILE)
        s = mma(torch.zeros(b, heads, n, min(KEY_TILE, n - k0)), q,
                k[:, :, keys].transpose(-2, -1)) + bias[..., keys]
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        if chained:
            o = mma(o * corr, p, v[:, :, keys])
        else:
            o = torch.addcmul(mma(torch.zeros_like(o), p, v[:, :, keys]), o, corr)
        m = m_new
    out = (o / l).transpose(1, 2).reshape(b, n, -1)
    return out, (m + torch.log(l)).reshape(b * heads, n)


def forward_case(case):
    """Inputs of one forward case and the float64 output and log-sum-exp."""
    batch, heads, k_hw, d = {"K3 global 32x32": (1, 3, (32, 32), 64),
                             "K2 windows 14x14": (4, 3, (14, 14), 64),
                             "K3 ragged 20x27": (1, 2, (20, 27), 64),
                             "K3 head dim 80": (1, 2, (32, 32), 80)}[case]
    qkv, rel_h, rel_w, _ = inputs(batch, heads, k_hw, d, seed=3)
    if case.startswith("K2"):  # the rel terms from the two tables, as kernel R computes them
        rng = np.random.default_rng(4)
        n = k_hw[0] * k_hw[1]
        rh, rw = (torch.from_numpy(0.2 * rng.standard_normal((n, d), dtype=np.float32))
                  for _ in range(2))
        rel_h, rel_w = attention.window_rel_terms(qkv, rh, rw, k_hw, heads)
    args = (d ** -0.5, k_hw, heads)
    want = attention.attention_rel_packed(qkv.double(), rel_h.double(), rel_w.double(), *args)
    b, n, _ = qkv.shape
    q, k, _ = qkv.double().reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias = rel_h.double().reshape(b, heads, n, k_hw[0], 1) + rel_w.double().reshape(
        b, heads, n, 1, k_hw[1])
    want_lse = torch.logsumexp((q * args[0]) @ k.transpose(-2, -1) + bias.reshape(b, heads, n, n),
                               -1).reshape(b * heads, n)
    return (qkv, rel_h, rel_w, *args), want, want_lse


def out_err(got, want):
    return (got.double() - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("case", ["K3 global 32x32", "K2 windows 14x14", "K3 ragged 20x27",
                                  "K3 head dim 80"])
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
