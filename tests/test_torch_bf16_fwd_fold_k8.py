"""A CPU model of the order of the bfloat16 K8 forward on the warpgroup window
kernel (``attention_fwd_wgmma_window_kernel<3>`` of
``csrc/attention_fwd_wgmma.cuh``), held against the port's plain bfloat16 K8
(``attention_rel_win_bf16``) and against the Pallas K8
(``fused_attention_rel_win``) run on bfloat16 inputs in interpret mode.

The kernel carves each ws x ws window from the unpartitioned ``(B, Hg, Wg,
3*H*D)`` grid by the slot map: slot ``(i, j)`` of window ``(wy, wx)`` is
token ``(wy ws + i, wx ws + j)``, or a pad slot past the grid's edge. A slot
with a token takes that token's q, k, v and rel rows. A pad slot is a real
key whose k and v are ``bias_kv``'s rows, with zero q and rel rows (it is no
query). Then, per (window, head), K3's fold at depth 96: ``q_aug =
[bf16(q * bf16(scale)) | rel_h | rel_w | 0]`` against ``k_aug = [k | E_h |
E_w | 0]``, the one-hot columns by slot position for every slot, pad slots
included; one S product over 200 keys, keys past ``ws * ws`` at -inf (and v's
rows past it zero); the rows' exact maximum m, ``e = exp(S - m)``, ``l = sum
e``, ``p = bf16(e / l)``; ``O += p . V`` over 64-key tiles in float32. The
context ``bf16(O)`` and ``lse = m + log l`` go to the grid by token; a pad
query slot writes nothing.

The measure is ``test_torch_bf16_kernels.py``'s (``_agreement``): against the
plain version at most ``K8_PLAIN_ULPS`` and at least 99% bit-equal, the lse
within 1e-5; against the Pallas kernel the plain version's own distance plus
one ulp, at least 99% bit-equal. A model that fills the pad keys with zeros
misses the Pallas kernel: the test that says so holds the pad rule.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from mia_tpu.ops.attention import fused_attention_rel_win as jax_k8

import torch
from test_torch_bf16_bwd_fold import fold_operands
from test_torch_bf16_fwd_fold_k2k7 import ONE_WALK_KEYS, softmax_pv
from test_torch_bf16_kernels import MIN_EQUAL, _agreement, _bf16, _t

from mia_tpu_torch.ops import attention

D = 64
WS = 14
V_ROWS = 208  # rows of v in the window kernel: 13 k16 steps of P . V
# the model against the plain bfloat16 K8 (float32 sums in another order): a probability on a
# bfloat16 rounding boundary may round the other way and move its row's outputs by that ulp of
# p times v. Measured: 1 ulp on 32x32 and 20x27; 2 on 28x28, where one p of 0.0221 in a row of
# 196 rounds the other way against a v of -2.61 (K3's and K2's cases read 1: PLAIN_ULPS)
K8_PLAIN_ULPS = 2.0
# (batch, grid, heads): pad windows on two edges; pads both ways at odd widths; no pad slot
CASES = {"32x32": (1, (32, 32), 2), "20x27": (1, (20, 27), 2), "28x28": (1, (28, 28), 2)}


def slot_tokens(hg, wg, ws):
    """(windows, ws * ws): the token of each slot of each window, windows
    row-major, -1 for a pad slot."""
    nwy, nwx = -(-hg // ws), -(-wg // ws)
    wins, slots = torch.arange(nwy * nwx)[:, None], torch.arange(ws * ws)
    gy = (wins // nwx) * ws + slots // ws
    gx = (wins % nwx) * ws + slots % ws
    return torch.where((gy < hg) & (gx < wg), gy * wg + gx, -1)


def k8_fwd(qkv, rel_h, rel_w, bias_kv, scale, ws, heads, pad_keys=True):
    """K8's order → (context (B, Hg, Wg, H*D) in bfloat16, lse (B*H, Hg*Wg)).
    ``pad_keys=False``: the pad slots' k and v are zeros instead of
    ``bias_kv``'s rows."""
    b, hg, wg, three_hd = qkv.shape
    hd = three_hd // 3
    tok = slot_tokens(hg, wg, ws)
    n_win, n = tok.shape
    real, idx = tok >= 0, tok.clamp(min=0)
    pad = torch.cat([torch.zeros(hd, dtype=qkv.dtype), bias_kv[1], bias_kv[2]])
    if not pad_keys:
        pad = torch.zeros_like(pad)
    windows = torch.where(real[None, :, :, None], qkv.reshape(b, hg * wg, three_hd)[:, idx], pad)

    def rel_slots(rel):  # (B*H, Hg, Wg, ws) → (B*nW*H, n, ws), zeros at the pad slots
        r = rel.reshape(b, heads, hg * wg, ws)[:, :, idx]
        r = torch.where(real[None, None, :, :, None], r, torch.zeros((), dtype=rel.dtype))
        return r.permute(0, 2, 1, 3, 4).reshape(b * n_win * heads, n, ws)

    q_aug, k_aug, v, _ = fold_operands(windows.reshape(b * n_win, n, three_hd), rel_slots(rel_h),
                                       rel_slots(rel_w), scale, (ws, ws), heads)
    s = q_aug @ k_aug.transpose(1, 2)  # the window's one S product
    s = torch.nn.functional.pad(s, (0, ONE_WALK_KEYS - n), value=-torch.inf)
    v = torch.nn.functional.pad(v, (0, 0, 0, V_ROWS - n))
    o, lse = softmax_pv(s, v, one_walk=True)
    # by token: the real slots' rows, window by window
    o = o.to(torch.bfloat16).reshape(b, n_win, heads, n, D).permute(0, 1, 3, 2, 4)
    out = torch.zeros(b, hg * wg, heads * D, dtype=torch.bfloat16)
    out[:, tok[real]] = o.reshape(b, n_win, n, heads * D)[:, real]
    lse = lse.reshape(b, n_win, heads, n).permute(0, 2, 1, 3)
    lse_tok = torch.full((b, heads, hg * wg), torch.nan)
    lse_tok[:, :, tok[real]] = lse[:, :, real]
    return out.reshape(b, hg, wg, heads * D), lse_tok.reshape(b * heads, hg * wg)


def _case(name, seed):
    b, hw, heads = CASES[name]
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng, b, *hw, 3 * heads * D)
    rel_h, rel_w = (_bf16(rng, b * heads, *hw, WS, scale=0.5) for _ in range(2))
    bias_kv = _bf16(rng, 3, heads * D, scale=0.5)  # non-zero: pad slots are real keys
    return (qkv, rel_h, rel_w, bias_kv), heads


def test_slot_tokens_cover_the_grid_once():
    """Every token of a 20 x 27 grid stands in exactly one slot; the pad slots
    are those past the last row (6 of 14 rows) or column (13 of 14)."""
    tok = slot_tokens(20, 27, WS)
    assert tok.shape == (4, WS * WS)
    assert torch.equal(tok[tok >= 0].sort().values, torch.arange(20 * 27))
    pads = (tok < 0).reshape(2, 2, WS, WS)
    assert not pads[0, 0].any() and pads[0, 1][:, 13].all() and not pads[0, 1][:, :13].any()
    assert pads[1, 0][6:].all() and not pads[1, 0][:6].any()


@pytest.mark.parametrize("case", list(CASES))
def test_k8_model_matches_the_plain_bf16_k8(case):
    """Within ``K8_PLAIN_ULPS`` of the plain bfloat16 K8, at least 99%
    bit-equal, its lse within 1e-5 of the plain one at every token."""
    args, heads = _case(case, seed=sum(CASES[case][1]) + 1)
    args = [_t(a) for a in args]
    out, lse = k8_fwd(*args, D ** -0.5, WS, heads)
    want, want_lse = attention.attention_rel_win_bf16(*args, D ** -0.5, WS, heads)
    assert out.dtype == torch.bfloat16 and out.shape == want.shape
    ulps, equal = _agreement(out, want.float().numpy())
    assert ulps <= K8_PLAIN_ULPS and equal >= MIN_EQUAL, (ulps, equal)
    assert lse.shape == want_lse.shape and (lse - want_lse).abs().max().item() <= 1e-5


@functools.cache
def _against_jax(case):
    """The Pallas K8's context on the case's inputs, the inputs as torch
    tensors, and the plain bfloat16 K8's own (ulps, share bit-equal)."""
    args, heads = _case(case, seed=sum(CASES[case][1]) + 7)
    want = np.asarray(jax_k8(*map(jnp.asarray, args), D ** -0.5, WS, heads, True), np.float32)
    args = [_t(a) for a in args]
    plain = _agreement(attention.attention_rel_win_bf16(*args, D ** -0.5, WS, heads)[0], want)
    return want, args, heads, plain


@pytest.mark.parametrize("case", list(CASES))
def test_k8_model_matches_jax_pallas_in_bfloat16(case):
    """The slot-mapped one walk within the plain version's own distance to the
    Pallas K8 plus one ulp, at least 99% bit-equal."""
    want, args, heads, (plain_ulps, plain_equal) = _against_jax(case)
    assert plain_ulps <= 2.0 and plain_equal >= MIN_EQUAL, (plain_ulps, plain_equal)
    ulps, equal = _agreement(k8_fwd(*args, D ** -0.5, WS, heads)[0], want)
    assert ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL, (ulps, equal, plain_ulps)


@pytest.mark.parametrize("case", ["32x32", "20x27"])
def test_zero_pad_keys_miss_jax_pallas(case):
    """Why the kernel writes ``bias_kv``'s rows over the pad slots' zeros:
    the same model with zero pad keys misses the Pallas K8 on a grid whose
    windows have pad slots."""
    want, args, heads, (plain_ulps, _) = _against_jax(case)
    ulps, equal = _agreement(k8_fwd(*args, D ** -0.5, WS, heads, pad_keys=False)[0], want)
    assert not (ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL), (ulps, equal)
