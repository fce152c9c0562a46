"""K8's and K8b's arithmetic on the CPU: the windowed instances of the 3xTF32
forward and backward templates (``mia_tpu_torch/csrc/attention_fwd_tc.cuh``,
``kRelWindow``; ``attention_bwd_tc.cuh``, ``kWindow``) emulated in plain
torch and held against float64.

The forward copies the same windows by the slot map (the layout both share,
``csrc/attention_window.cuh``) and runs the forward template's order on them
(``test_torch_attention_3xtf32.forward_tiles``: per key tile of 32 or 64
slots, S from zero, the online softmax, the tile's P·V from zero folded into
the output by one multiply-add); pad queries are computed with zero q and
zero rel rows and dropped, and out and the log-sum-exp are written by token.
Its output is held within ``KERNEL_TOL`` of max |float64| and its
log-sum-exp within ``LSE_TOL``, one TF32 pass at least 10x further away.

The kernel carves each ``ws x ws`` window from the unpartitioned
``(B, Hg, Wg, 3·H·D)`` qkv grid through a slot -> token map: a slot outside
the grid is a pad slot, a real key whose k and v are ``bias_kv`` rows; it is
no query, so its q and g rows and its rel rows are zero and its lse is +inf,
which makes its probabilities exactly 0. The products run in 3xTF32
(``test_torch_attention_3xtf32.py`` emulates the split). The pad keys' dk and
dv are summed into one partial row per (window, 64-key tile), and the partials
are reduced in the reduce kernel's order into rows 1 and 2 of ``dbias_kv``.
Every output is held within ``BWD_TOL`` of max |float64| (the plain VJP of
``mia_tpu_torch.ops.attention`` in float64), and one TF32 pass lands at least
10x further away.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_attention_3xtf32 import (BWD_TOL, KERNEL_TOL, LSE_TOL, forward_tiles, mm_3xtf32,
                                         mm_tf32, mma_3xtf32, mma_tf32)

from mia_tpu_torch.ops import attention

HEADS, D = 2, 64
KEY_TILE = 64  # slots a block of the template owns (kTcTile)
GRIDS = {  # (batch, (Hg, Wg), ws)
    "32x32 ws 14 (pad at the bottom and the right)": (1, (32, 32), 14),
    "20x27 ws 14 (ragged both ways)": (1, (20, 27), 14),
    "28x28 ws 14 (whole windows)": (1, (28, 28), 14),
    "9x11 ws 4": (2, (9, 11), 4),
}


def slot_tokens(hg, wg, ws):
    """(windows, ws²): the grid token of every slot of every window (the
    kernel's slot_token), -1 for a pad slot."""
    nwy, nwx = -(-hg // ws), -(-wg // ws)
    i, j = np.divmod(np.arange(ws * ws), ws)
    wy, wx = np.divmod(np.arange(nwy * nwx), nwx)
    gy, gx = wy[:, None] * ws + i, wx[:, None] * ws + j
    return torch.from_numpy(np.where((gy < hg) & (gx < wg), gy * wg + gx, -1))


def window_operands(qkv, rel_h, rel_w, bias_kv, ws, heads):
    """The windows as the kernel copies them by the slot map, (B, nW, H, n, ·):
    q with pad rows zero, k and v with pad rows from ``bias_kv``, the rel rows
    with pad rows zero, and the query mask (nW, n)."""
    b, hg, wg, three_hd = qkv.shape
    d = three_hd // (3 * heads)
    tok = slot_tokens(hg, wg, ws)
    real = tok >= 0
    rows = qkv.reshape(b, hg * wg, 3, heads, d)[:, tok.clamp(min=0)]  # (B, nW, n, 3, H, d)
    rows = torch.where(real[None, :, :, None, None, None], rows, bias_kv.reshape(3, heads, d))
    q, k, v = rows.permute(3, 0, 1, 4, 2, 5)
    q = torch.where(real[None, :, None, :, None], q, 0.0)

    def rel_rows(rel):  # (B·H, Hg, Wg, ws) → (B, nW, H, n, ws)
        r = rel.reshape(b, heads, hg * wg, ws)[:, :, tok.clamp(min=0)].permute(0, 2, 1, 3, 4)
        return torch.where(real[None, :, None, :, None], r, 0.0)

    return q, k, v, rel_rows(rel_h), rel_rows(rel_w), real, tok


def by_slot(x, tok, real, heads, fill=0.0):
    """Rows by token ``(B, Hg·Wg, H·d)`` or values ``(B·H, Hg·Wg)`` → by slot
    ``(B, nW, H, n, d)`` / ``(B, nW, H, n)``, ``fill`` for the pad slots."""
    if x.dim() == 2:
        y = x.reshape(-1, heads, x.shape[-1])[:, :, tok.clamp(min=0)].permute(0, 2, 1, 3)
        return torch.where(real[None, :, None, :], y, fill)
    y = x.reshape(x.shape[0], -1, heads, x.shape[-1] // heads)[:, tok.clamp(min=0)]
    return torch.where(real[None, :, :, None, None], y, fill).permute(0, 1, 3, 2, 4)


def window_bias(rel_h_w, rel_w_w):
    """The factored rel bias of every (query slot, key slot) pair of a window."""
    ws = rel_h_w.shape[-1]
    return (rel_h_w[..., :, None] + rel_w_w[..., None, :]).reshape(*rel_h_w.shape[:-1], ws * ws)


def forward_lse(qkv, rel_h, rel_w, bias_kv, scale, ws, heads):
    """The forward's log-sum-exp of every real query by token, (B·H, Hg·Wg),
    as K8 writes it (in the inputs' type)."""
    q, k, _, rh, rw, real, tok = window_operands(qkv, rel_h, rel_w, bias_kv, ws, heads)
    lse_w = torch.logsumexp((q * scale) @ k.transpose(-2, -1) + window_bias(rh, rw), -1)
    b, hg, wg, _ = qkv.shape
    lse = torch.zeros(b, heads, hg * wg, dtype=lse_w.dtype)
    lse[:, :, tok[real]] = lse_w.permute(0, 2, 1, 3)[:, :, real]
    return lse.reshape(b * heads, hg * wg)


def k8_forward(mma, qkv, rel_h, rel_w, bias_kv, scale, ws, heads, tile):
    """K8 in the window instance's order: the windows copied by the slot map,
    ``forward_tiles`` over key tiles of ``tile`` slots, the real queries'
    rows scattered to their tokens → out (B, Hg, Wg, H·d) and the
    log-sum-exp by token (B·H, Hg·Wg)."""
    b, hg, wg, three_hd = qkv.shape
    q, k, v, rh, rw, real, tok = window_operands(qkv, rel_h, rel_w, bias_kv, ws, heads)
    out_w, lse_w = forward_tiles(mma, q, k, v, window_bias(rh, rw), scale, guard=False, tile=tile)
    out = torch.zeros(b, hg * wg, heads, three_hd // (3 * heads))
    out[:, tok[real]] = out_w.permute(0, 1, 3, 2, 4)[:, real]
    lse = torch.zeros(b, heads, hg * wg)
    lse[:, :, tok[real]] = lse_w.permute(0, 2, 1, 3)[:, :, real]
    return out.reshape(b, hg, wg, -1), lse.reshape(b * heads, hg * wg)


@pytest.mark.parametrize("tile", [32, 64])
@pytest.mark.parametrize("case", list(GRIDS))
def test_3xtf32_k8_forward_keeps_float32_accuracy_where_one_pass_does_not(case, tile):
    batch, hw, ws = GRIDS[case]
    qkv, rel_h, rel_w, bias_kv, _ = grid_inputs(batch, hw, ws, seed=hw[0] * hw[1] + ws)
    args = (D ** -0.5, ws, HEADS)
    fwd64 = [t.double() for t in (qkv, rel_h, rel_w, bias_kv)]
    want = attention.attention_rel_win(*fwd64, *args)
    want_lse = forward_lse(*fwd64, *args)
    out3, lse3 = k8_forward(mma_3xtf32, qkv, rel_h, rel_w, bias_kv, *args, tile)
    out1, lse1 = k8_forward(mma_tf32, qkv, rel_h, rel_w, bias_kv, *args, tile)
    ref = want.abs().max().item()
    err3 = (out3.double() - want).abs().max().item() / ref
    err1 = (out1.double() - want).abs().max().item() / ref
    assert err3 <= KERNEL_TOL, f"3xTF32 output off by {err3:.3g} of max |float64|"
    assert err1 >= 10 * err3, f"one TF32 pass {err1:.3g} against 3xTF32 {err3:.3g}"
    lse_err3 = (lse3.double() - want_lse).abs().max().item()
    lse_err1 = (lse1.double() - want_lse).abs().max().item()
    assert lse_err3 <= LSE_TOL, f"3xTF32 log-sum-exp off by {lse_err3:.3g}"
    assert lse_err1 >= 10 * lse_err3, f"one TF32 pass {lse_err1:.3g} against 3xTF32 {lse_err3:.3g}"


def k8_backward(mm, qkv, rel_h, rel_w, bias_kv, out, g, lse, scale, ws, heads):
    """K8b in the windowed instance's order: per window S and dP recomputed,
    p = exp(s·scale + bias − lse) with lse = +inf for a slot that is no query,
    ds = p (dp − delta), then dv, dk, dq, every product through ``mm``; the
    real slots' gradients scattered to their tokens, the pad keys' dk and dv
    summed per (window, key tile) and the partials reduced as the reduce
    kernel does (rows r ≡ y mod 8 in order, then the 8 sums in order).
    Returns dqkv, drel_h, drel_w, dbias_kv and the probabilities."""
    b, hg, wg, three_hd = qkv.shape
    hd = three_hd // 3
    n = ws * ws
    q, k, v, rh, rw, real, tok = window_operands(qkv, rel_h, rel_w, bias_kv, ws, heads)
    g_w, o_w = by_slot(g, tok, real, heads), by_slot(out, tok, real, heads)
    lse_w = by_slot(lse, tok, real, heads, fill=torch.inf)
    s = mm(q, k.transpose(-2, -1))
    dp = mm(g_w, v.transpose(-2, -1))
    p = torch.exp(s * scale + window_bias(rh, rw) - lse_w[..., None])
    delta = (g_w * o_w).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    dv = mm(p.transpose(-2, -1), g_w)
    dk = mm(ds.transpose(-2, -1), q) * scale
    dq = mm(ds, k) * scale
    ds5 = ds.reshape(*ds.shape[:-1], ws, ws)
    drel = (ds5.sum(-1), ds5.sum(-2))

    dqkv = torch.zeros(b, hg * wg, 3, heads, hd // heads)
    for i, grad in enumerate((dq, dk, dv)):  # (B, nW, H, n, d) at the real slots' tokens
        dqkv[:, tok[real], i] = grad.permute(0, 1, 3, 2, 4)[:, real]
    drel_grid = []
    for r in drel:
        grid = torch.zeros(b, heads, hg * wg, ws)
        grid[:, :, tok[real]] = r.permute(0, 2, 1, 3, 4)[:, :, real]
        drel_grid.append(grid.reshape(b * heads, hg, wg, ws))

    parts = []  # one row per (image, window, key tile): the tile's pad keys' dk | dv
    for bi in range(b):
        for w in range(tok.shape[0]):
            for k0 in range(0, n, KEY_TILE):
                pad = ~real[w, k0:k0 + KEY_TILE]
                parts.append(torch.stack([x[bi, w, :, k0:k0 + KEY_TILE][:, pad].sum(1).reshape(hd)
                                          for x in (dk, dv)]))
    sums = []
    for y in range(8):
        acc = torch.zeros(2, hd)
        for row in parts[y::8]:
            acc = acc + row
        sums.append(acc)
    total = torch.zeros(2, hd)
    for acc in sums:
        total = total + acc
    dbias_kv = torch.cat([torch.zeros(1, hd), total])
    return (dqkv.reshape(qkv.shape), *drel_grid, dbias_kv), p


def grid_inputs(batch, hw, ws, seed):
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32))

    return (randn(batch, *hw, 3 * HEADS * D), randn(batch * HEADS, *hw, ws),
            randn(batch * HEADS, *hw, ws), randn(3, HEADS * D, scale=0.5),
            randn(batch, *hw, HEADS * D))


@pytest.mark.parametrize("case", list(GRIDS))
def test_3xtf32_k8_backward_keeps_float32_accuracy_where_one_pass_does_not(case):
    batch, hw, ws = GRIDS[case]
    qkv, rel_h, rel_w, bias_kv, g = grid_inputs(batch, hw, ws, seed=hw[0] * hw[1] + ws)
    scale = D ** -0.5
    args = (scale, ws, HEADS)
    # the float32 forward the kernel reads: its output and lse by token
    out = attention.attention_rel_win(qkv, rel_h, rel_w, bias_kv, *args)
    lse = forward_lse(qkv, rel_h, rel_w, bias_kv, *args)
    fwd64 = [t.double() for t in (qkv, rel_h, rel_w, bias_kv)]
    want = attention.attention_rel_win_bwd(*fwd64, attention.attention_rel_win(*fwd64, *args),
                                           g.double(), *args)
    split3, p = k8_backward(mm_3xtf32, qkv, rel_h, rel_w, bias_kv, out, g, lse, *args)
    one_pass, _ = k8_backward(mm_tf32, qkv, rel_h, rel_w, bias_kv, out, g, lse, *args)
    # a slot that is no query: lse = +inf and zero rows give p = 0 exactly, no NaN
    real = slot_tokens(*hw, ws) >= 0
    assert torch.isfinite(p).all() and not p.masked_fill(real[None, :, None, :, None], 0.0).any()
    for name, w, x3, x1 in zip(("dqkv", "drel_h", "drel_w", "dbias_kv"), want, split3, one_pass):
        ref = w.abs().max().item()
        if ref == 0.0:  # whole windows: no pad slot, dbias_kv exactly zero in both
            assert name == "dbias_kv" and real.all()
            assert not x3.any() and not x1.any()
            continue
        err3 = (x3.double() - w).abs().max().item() / ref
        err1 = (x1.double() - w).abs().max().item() / ref
        assert err3 <= BWD_TOL, f"{name}: 3xTF32 off by {err3:.3g} of max |float64|"
        assert err1 >= 10 * err3, f"{name}: one TF32 pass {err1:.3g} against 3xTF32 {err3:.3g}"
    assert not split3[3][0].any()


def test_k8b_partial_rows_follow_the_templates_tile():
    """The wrapper allocates one dpad row per (window, key tile) of the
    template's kTcTile slots, the rows the reduce kernel sums."""
    src = Path(attention.__file__).resolve().parents[1] / "csrc" / "tf32_mma.cuh"
    tile = int(re.search(r"constexpr int kTcTile = (\d+);", src.read_text()).group(1))
    assert attention._BWD_TILE == tile == KEY_TILE
