"""A CPU model of the order of the bfloat16 K8b on the warpgroup backward's
window instance (``attention_bwd_wgmma_win_{dq,dkv}_kernel`` of
``csrc/attention_bwd_wgmma.cuh``, then ``attention_bwd_pad_reduce_kernel``),
held against the port's plain bfloat16 VJP (``attention_rel_win_bwd_bf16``)
and against ``jax.vjp`` of the Pallas K8 (``fused_attention_rel_win``) run on
bfloat16 inputs in interpret mode.

The kernel carves each ws x ws window from the unpartitioned ``(B, Hg, Wg,
3*H*D)`` grid by the slot map, as the forward does
(``test_torch_bf16_fwd_fold_k8.py``): a slot with a token takes that token's
q, k, v, g, rel rows, lse and delta; a pad slot is a real key whose k and v
are ``bias_kv``'s rows, with zero q, g and rel rows, and is no query (its dS
is 0 by selection). Then K6b's fold at depth 96 (``test_torch_bf16_bwd_fold.py``):
``q_aug = [bf16(q * bf16(scale)) | rel_h | rel_w | 0]`` against ``k_aug = [k |
E_h | E_w | 0]``, the one-hot columns by slot position (pad slots included);
pass A, a 64-slot query tile against the window's 64-slot key tiles, sums
``dq_aug = dS . k_aug``; pass B, a 64-slot key tile against the window's
query tiles, sums ``dk = dS^T . q_aug[:, :D]`` and ``dv = P^T . G``, each
tile's product folded into the float32 sum, then one rounding: dq, dk, dv by
token into dqkv, drel_h and drel_w by token. Each pass-B block (window
``win * B + image``, key tile) leaves the float32 sums of its pad keys' dk |
dv as one dpad row (its four warps' 16 keys in order); the reduce adds the
rows as ``attention_bwd_pad_reduce_kernel`` does (8 lanes, each every 8th
row, then the lanes in order) and rounds once into dbias_kv rows 1 and 2;
row 0 is zero.

The measure is ``test_torch_bf16_bwd_fold.py``'s: against the plain VJP dqkv
within one ulp, the rel gradients within ``REL_ULPS``, dbias_kv one ulp, at
least 99% bit-equal; against JAX ``JAX_ULPS`` for dqkv and dbias_kv,
``REL_ULPS`` for the rel gradients, 99% bit-equal, and no more than the
plain VJP's own distance plus one ulp. Measured against the plain VJP: dqkv
1 ulp at 99.995-99.996% bit-equal, the rel gradients and dbias_kv bit for
bit; against JAX: dqkv 2-3 ulps at 99.83-99.95%, the rel gradients 1-2 ulps,
dbias_kv 0.125 ulps (20 x 27), each the plain VJP's own reading.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.ops.attention import fused_attention_rel_win as jax_k8

import torch
from test_torch_bf16_backward import REL_ULPS
from test_torch_bf16_bwd_fold import JAX_ULPS, fold_operands
from test_torch_bf16_fwd_fold_k8 import slot_tokens
from test_torch_bf16_kernels import MIN_EQUAL, _agreement, _bf16, _t

from mia_tpu_torch.ops import attention

BF = torch.bfloat16
D = 64
WS = 14
TILE = 64  # slots of a warpgroup tile
# (batch, grid, heads): pads on the bottom and right windows; pads both ways at odd widths;
# no pad slot (dbias_kv zero)
CASES = {"32x32": (1, (32, 32), 2), "20x27": (1, (20, 27), 2), "28x28": (1, (28, 28), 2)}
NAMES = ("dqkv", "drel_h", "drel_w", "dbias_kv")


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF).float()


def by_slot(t, tok, fill=0.0):
    """``t (..., Hg*Wg, C)`` → ``(..., windows, slots, C)`` by the slot map,
    ``fill`` at the pad slots."""
    real, idx = tok >= 0, tok.clamp(min=0)
    out = t[..., idx, :]
    return torch.where(real[..., None], out, torch.as_tensor(fill, dtype=out.dtype))


def k8b_bwd(qkv, rel_h, rel_w, bias_kv, out, g, lse, scale, ws, heads):
    """The window instance's order → (dqkv, drel_h, drel_w, dbias_kv) in bfloat16."""
    b, hg, wg, three_hd = qkv.shape
    hd = three_hd // 3
    tok = slot_tokens(hg, wg, ws)
    n_win, n = tok.shape
    real = tok >= 0
    pad_kv = torch.cat([torch.zeros(hd, dtype=qkv.dtype), bias_kv[1], bias_kv[2]])
    windows = torch.where(real[None, :, :, None],
                          by_slot(qkv.reshape(b, hg * wg, three_hd), tok), pad_kv)
    def rel_slots(rel):  # (B*H, Hg, Wg, ws) → (B*nW*H, n, ws)
        r = by_slot(rel.reshape(b, heads, hg * wg, ws), tok)
        return r.permute(0, 2, 1, 3, 4).reshape(b * n_win * heads, n, ws)

    q_aug, k_aug, v, _ = fold_operands(windows.reshape(b * n_win, n, three_hd), rel_slots(rel_h),
                                       rel_slots(rel_w), scale, (ws, ws), heads)

    def heads_first(t):  # (B, Hg, Wg, H*D) → (B*nW*H, n, D) by slot, zeros at the pad slots
        t = by_slot(t.reshape(b, hg * wg, hd), tok).reshape(b, n_win, n, heads, D)
        return t.permute(0, 1, 3, 2, 4).reshape(b * n_win * heads, n, D).float()

    g4, o4 = heads_first(g), heads_first(out)
    query = real[None, :, None, :].expand(b, n_win, heads, n).reshape(-1, n)
    lse_s = by_slot(lse.reshape(b, heads, hg * wg, 1), tok).permute(0, 2, 1, 3, 4)
    lse_s = lse_s.reshape(b * n_win * heads, n)
    delta = (g4 * o4).sum(-1)
    tiles = [(t0, min(t0 + TILE, n)) for t0 in range(0, n, TILE)]

    def ds_p(s, dp, rows, cols, transposed):
        """dS (rounded) and p by selection: slots that are no query give 0."""
        q_ok = query[:, cols][:, None, :] if transposed else query[:, rows][:, :, None]
        lse_b = lse_s[:, cols][:, None, :] if transposed else lse_s[:, rows][:, :, None]
        dl_b = delta[:, cols][:, None, :] if transposed else delta[:, rows][:, :, None]
        p = torch.where(q_ok, torch.exp(s - torch.where(q_ok, lse_b, 0.0)), 0.0)
        return _round(torch.where(q_ok, p * (dp - dl_b), 0.0)), p

    dq_aug = torch.zeros_like(q_aug)  # pass A
    for q0, q1 in tiles:
        acc = torch.zeros(q_aug.shape[0], q1 - q0, q_aug.shape[-1])
        for k0, k1 in tiles:
            s = q_aug[:, q0:q1] @ k_aug[:, k0:k1].transpose(1, 2)
            dp = g4[:, q0:q1] @ v[:, k0:k1].transpose(1, 2)
            ds, _ = ds_p(s, dp, slice(q0, q1), slice(k0, k1), False)
            acc = acc + ds @ k_aug[:, k0:k1]
        dq_aug[:, q0:q1] = acc
    dk = torch.zeros_like(v)  # pass B
    dv = torch.zeros_like(v)
    for k0, k1 in tiles:
        acc_k = torch.zeros(v.shape[0], k1 - k0, D)
        acc_v = torch.zeros_like(acc_k)
        for q0, q1 in tiles:
            s_t = k_aug[:, k0:k1] @ q_aug[:, q0:q1].transpose(1, 2)
            dp_t = v[:, k0:k1] @ g4[:, q0:q1].transpose(1, 2)
            ds_t, p_t = ds_p(s_t, dp_t, slice(k0, k1), slice(q0, q1), True)
            acc_v = acc_v + _round(p_t) @ g4[:, q0:q1]
            acc_k = acc_k + ds_t @ q_aug[:, q0:q1, :D]
        dk[:, k0:k1] = acc_k
        dv[:, k0:k1] = acc_v

    # by token: the real slots' rows
    def to_grid(t, cols):  # (B*nW*H, n, cols) → (B, Hg*Wg, H, cols) at the real slots
        t = t.reshape(b, n_win, heads, n, cols).permute(0, 1, 3, 2, 4)
        grid = torch.zeros(b, hg * wg, heads, cols, dtype=t.dtype)
        grid[:, tok[real]] = t[:, real]
        return grid

    dqkv = torch.cat([to_grid((dq_aug[..., :D] * scale).to(BF), D).reshape(b, hg * wg, hd),
                      to_grid(dk.to(BF), D).reshape(b, hg * wg, hd),
                      to_grid(dv.to(BF), D).reshape(b, hg * wg, hd)], -1)

    def rel_grid(cols):
        r = to_grid(dq_aug[..., cols].to(BF), ws).permute(0, 2, 1, 3)
        return r.reshape(b * heads, hg, wg, ws)

    # dpad: one row a (block z = window * B + image, key tile), the tile's pad keys
    pad = ~real  # (nW, n)
    rows = []
    dkv = torch.stack([dk, dv], 1).reshape(b, n_win, heads, 2, n, D)
    for win in range(n_win):
        for img in range(b):
            for k0, k1 in tiles:
                part = torch.zeros(2, heads, D)
                for w0 in range(k0, k1, 16):  # the four warps' 16 keys, in order
                    keys = [s for s in range(w0, min(w0 + 16, k1)) if pad[win, s]]
                    if keys:
                        part = part + dkv[img, win, :, :, keys].sum(-2).transpose(0, 1)
                rows.append(part.reshape(2, hd))
    dpad = torch.stack(rows)
    lanes = [dpad[y::8].sum(0) for y in range(8)]
    total = lanes[0]
    for s in lanes[1:]:
        total = total + s
    dbias_kv = torch.cat([torch.zeros(1, hd), total]).to(BF)
    return (dqkv.reshape(qkv.shape), rel_grid(slice(D, D + ws)),
            rel_grid(slice(D + ws, D + 2 * ws)), dbias_kv)


def _case(name, seed):
    b, hw, heads = CASES[name]
    rng = np.random.default_rng(seed)
    qkv = _bf16(rng, b, *hw, 3 * heads * D)
    rel_h, rel_w = (_bf16(rng, b * heads, *hw, WS, scale=0.5) for _ in range(2))
    bias_kv = _bf16(rng, 3, heads * D, scale=0.5)  # non-zero: pad slots are real keys
    g = _bf16(rng, b, *hw, heads * D)
    return (qkv, rel_h, rel_w, bias_kv), g, heads


def _holds(got, want, dqkv_ulps, pad):
    """Each output within its limit of ``want``; returns the readings."""
    readings = {}
    for name, a, w in zip(NAMES, got, want):
        w = np.asarray(w.float() if isinstance(w, torch.Tensor) else w, np.float32)
        assert a.dtype == BF and tuple(a.shape) == w.shape, name
        if name == "dbias_kv" and not pad:  # no pad slot: exactly zero
            assert not a.float().any() and not w.any(), name
            continue
        rows = slice(1, None) if name == "dbias_kv" else slice(None)
        ulps, equal = _agreement(a[rows], w[rows])
        readings[name] = (ulps, equal)
        limit = REL_ULPS if name.startswith("drel") else dqkv_ulps
        assert ulps <= limit and equal >= MIN_EQUAL, (name, ulps, equal)
    assert not got[3][0].float().any()  # q's row: pad slots are no queries
    return readings


def test_slot_map_carves_windows_with_pad_keys_and_no_pad_queries():
    """32 x 32 in 14 x 14 windows: the bottom and right windows have pad
    slots; 28 x 28 has none."""
    tok = slot_tokens(32, 32, WS)
    assert tok.shape == (9, WS * WS)
    pads = (tok < 0).reshape(3, 3, WS, WS)
    assert not pads[0, 0].any() and pads[0, 2][:, 4:].all() and pads[2, 0][4:].all()
    assert not (slot_tokens(28, 28, WS) < 0).any()


@pytest.mark.parametrize("case", list(CASES))
def test_k8b_model_matches_the_plain_bf16_vjp(case):
    args, g, heads = _case(case, seed=sum(CASES[case][1]) + 11)
    args, g = [_t(a) for a in args], _t(g)
    scale = D ** -0.5
    out, lse = attention.attention_rel_win_bf16(*args, scale, WS, heads)
    got = k8b_bwd(*args, out, g, lse, scale, WS, heads)
    want = attention.attention_rel_win_bwd_bf16(*args, out, g, lse, scale, WS, heads)
    pad = bool(CASES[case][1][0] % WS or CASES[case][1][1] % WS)
    _holds(got, want, 1.0, pad)


@functools.cache
def _against_jax(case):
    """JAX's bfloat16 VJP of the Pallas K8 on the case, the inputs as torch
    tensors, the cotangent and the plain bfloat16 VJP's own readings."""
    args, g, heads = _case(case, seed=sum(CASES[case][1]) + 13)
    scale = D ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_k8(*a, scale, WS, heads, True), *map(jnp.asarray, args))
    want = [np.asarray(jnp.asarray(w, jnp.float32)) for w in vjp(jnp.asarray(g))]
    targs, tg = [_t(a) for a in args], _t(g)
    out, lse = attention.attention_rel_win_bf16(*targs, scale, WS, heads)
    plain = attention.attention_rel_win_bwd_bf16(*targs, out, tg, lse, scale, WS, heads)
    return want, targs, tg, out, lse, plain, heads


@pytest.mark.parametrize("case", list(CASES))
def test_k8b_model_matches_jax_pallas_in_bfloat16(case):
    want, args, g, out, lse, plain, heads = _against_jax(case)
    pad = bool(CASES[case][1][0] % WS or CASES[case][1][1] % WS)
    got = k8b_bwd(*args, out, g, lse, D ** -0.5, WS, heads)
    model = _holds(got, want, JAX_ULPS, pad)
    for name, p in zip(NAMES, plain):  # the window fold adds nothing to the plain VJP's distance
        if name not in model:
            continue
        w = want[NAMES.index(name)]
        rows = slice(1, None) if name == "dbias_kv" else slice(None)
        ulps, _ = _agreement(p[rows], w[rows])
        assert model[name][0] <= ulps + 1.0, (name, model[name], ulps)
