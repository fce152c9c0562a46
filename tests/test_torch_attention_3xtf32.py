"""Why the K2b/K3b backward kernels split every float32 operand for the
tensor cores (3xTF32) instead of taking one TF32 pass.

The kernels of ``mia_tpu_torch/csrc/attention_bwd_tc.cuh`` run the five
products of the attention backward on ``mma.sync`` in TF32: each float32
operand x becomes big = x rounded to TF32 (round to nearest, ties away from
zero, on the low 13 mantissa bits) and small = x - big, which the tensor
core reads truncated to TF32; each product is small.big + big.small +
big.big with a float32 accumulator. These tests emulate that arithmetic in
plain torch on the CPU (TF32 values multiply exactly in float32) and hold
the K3 backward computed that way against the float64 VJP: every output
within ``BWD_TOL`` of max |float64|, as ``chip_smoke.py`` holds the kernels,
and one TF32 pass at least 10x further away.
"""

import numpy as np
import pytest
import torch

from mia_tpu_torch.ops import attention

BWD_TOL = 1e-4  # chip_smoke.py's tolerance for the backward kernels, per output
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
