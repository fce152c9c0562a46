"""The encoder's other routes in bfloat16: the plain bfloat16 versions of K6,
K7, K8 and K9 against the Pallas kernels run with bfloat16 inputs in
interpret mode, the launchers' C entry by dtype, and a narrow encoder of each
route against the JAX encoder of the same option with ``dtype=bfloat16``.

Inputs are made from a seed with numpy, rounded to bfloat16 and handed to
both. The Pallas kernels round where their bfloat16 fast path rounds (q·scale
in bfloat16 with the scale rounded first, K7's float32 score times the
scale, the normalised probabilities before P·V, the output; K9's residual sum
before its LayerNorm statistics); the plain versions round at the same
places. The kernels' measure is ``test_torch_bf16_kernels.py``'s: every
element within one bfloat16 ulp of JAX's (the ulp taken at no less than 2^-6
of max |JAX|) and at least 99% bit-equal, and beside it the relative
Frobenius distance ``‖port − JAX bf16‖ / ‖JAX float32‖`` within ``FN_TOL``,
which is asserted below JAX's own bfloat16-vs-float32 gap on the same inputs
(the same kernel run on the float32 values). The port's float32 path on the
same inputs, rounded to bfloat16 at the end, misses both. K9's ``x_new`` is
a float32 add rounded once, in both: bit for bit.

The encoders (img 40, patch 4, embed 32, depth 3, 2 heads, window 4: 9
windows with pad slots; block 2 global) are built from one seeded float32
parameter set (``jax.eval_shape`` and numpy; every table non-zero) and carried
over by ``sam_state_dict_from_flax``. JAX runs each route's path on the CPU
(the Pallas kernels in interpret mode; head-major: its einsum path, the same
function, since the JAX encoder reaches K6 only where the packed tiling is
illegal on a TPU), compiled to round op by op (``jax_bf16.py``). The
embedding is held within ``ENC_TOL`` of JAX's bfloat16 encoder, asserted
below JAX's bfloat16-vs-float32 gap; the port's float32 encoder misses it.
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam import ImageEncoderViT as JaxEncoder
from mia_tpu.ops.attention import attention_rel_with_padding as jax_k6
from mia_tpu.ops.attention import attention_with_padding as jax_k7
from mia_tpu.ops.attention import fused_attention_rel_win as jax_k8
from mia_tpu.ops.unpartition_residual import unpartition_add_ln as jax_k9

import torch
from jax_bf16 import jit_op_by_op
from test_torch_bf16_kernels import MIN_EQUAL, _agreement, _bf16, _t

from mia_tpu_torch.models.sam import ImageEncoderViT
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.ops import attention, unpartition_residual

# the kernels' relative Frobenius distance to JAX's bfloat16 kernel: measured 0 - 7e-10 (every
# element within one ulp, 99.99-100% bit-equal) against gaps of 2.26e-3 - 2.60e-3; the float32
# path rounded at the end lies 2.49e-3 - 2.92e-3 away (5.5-24 ulps, 58-70% bit-equal)
FN_TOL = 1e-4
BF = torch.bfloat16


def _rel(a, b, ref) -> float:
    a, b, ref = (np.asarray(t.float() if isinstance(t, torch.Tensor) else t, np.float32).ravel()
                 for t in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def _check(port, port_f32, want16, want32, ulps_limit=1.0):
    """The bfloat16 port within one ulp (99% bit-equal) and ``FN_TOL`` of
    JAX's bfloat16 kernel, ``FN_TOL`` under JAX's own bfloat16-vs-float32
    gap; the float32 path, rounded at the end, misses both."""
    want16 = np.asarray(want16, np.float32)
    assert port.dtype == BF and tuple(port.shape) == want16.shape
    ulps, equal = _agreement(port, want16)
    assert ulps <= ulps_limit and equal >= MIN_EQUAL, (ulps, equal)
    gap = _rel(want16, want32, want32)
    err = _rel(port, want16, want32)
    assert err <= FN_TOL < gap, (err, FN_TOL, gap)
    f32 = port_f32.to(BF)
    ulps32, equal32 = _agreement(f32, want16)
    assert ulps32 > ulps_limit or equal32 < MIN_EQUAL, (ulps32, equal32)
    assert _rel(f32, want16, want32) > FN_TOL


def _both(fn, *arrays, f32_also=()):
    """``fn`` on the bfloat16 arrays and on their float32 values; arrays whose
    index is in ``f32_also`` stay float32 in both calls."""
    b16 = [jnp.asarray(a) if i not in f32_also else jnp.asarray(a, jnp.float32)
           for i, a in enumerate(arrays)]
    b32 = [jnp.asarray(a, jnp.float32) for a in arrays]
    return fn(*b16), fn(*b32)


# (k_h, k_w, head dim): N = 120 (the JAX wrapper's blocks overhang it), a 5x7
# grid, a head dim whose scale 24**-0.5 is not a power of two
K6_CASES = [(10, 12, 16), (5, 7, 16), (4, 6, 24)]


@pytest.mark.parametrize("k_h,k_w,d", K6_CASES)
def test_k6_bfloat16_matches_jax(k_h, k_w, d):
    rng = np.random.default_rng(k_h * 10 + d + 3)
    bh, n = 4, k_h * k_w
    q, k, v = (_bf16(rng, bh, n, d) for _ in range(3))
    rel_h, rel_w = _bf16(rng, bh, n, k_h), _bf16(rng, bh, n, k_w)
    scale = d ** -0.5
    want16, want32 = _both(lambda *a: jax_k6(*a, scale, (k_h, k_w)), q, k, v, rel_h, rel_w)
    assert want16.dtype == jnp.bfloat16
    args = [_t(a) for a in (q, k, v, rel_h, rel_w)]
    got = attention.fused_attention_rel(*args, scale, (k_h, k_w))
    f32 = attention.attention_rel(*(a.float() for a in args), scale, (k_h, k_w))
    _check(got, f32, want16, want32)
    out, lse = attention.attention_rel_bf16(*args, scale, (k_h, k_w))
    assert torch.equal(out, got) and lse.dtype == torch.float32 and lse.shape == (bh, n)


# (bh, n, head dim): N no tile divides, with -inf over the first 8 keys of every
# other row (the JAX wrapper pads N to 128 and masks the pad keys with -1e30)
K7_CASES = [(4, 35, 16), (3, 20, 24)]


@pytest.mark.parametrize("bh,n,d", K7_CASES)
def test_k7_bfloat16_matches_jax(bh, n, d):
    rng = np.random.default_rng(bh * 100 + n)
    q, k, v = (_bf16(rng, bh, n, d) for _ in range(3))
    bias = rng.standard_normal((bh, n, n)).astype(np.float32)
    bias[:, ::2, :8] = -np.inf
    scale = d ** -0.5
    want16, want32 = _both(lambda *a: jax_k7(*a, scale), q, k, v, bias, f32_also=(3,))
    assert want16.dtype == jnp.bfloat16
    args = [_t(a) for a in (q, k, v)]
    got = attention.fused_attention(*args, torch.from_numpy(bias), scale)
    f32 = attention.attention_dense(*(a.float() for a in args), torch.from_numpy(bias), scale)
    _check(got, f32, want16, want32)


# (grid, window, head dim): pad windows both ways, whole windows, head dim 24
K8_CASES = [((9, 11), 4, 16), ((8, 8), 4, 16), ((9, 11), 4, 24)]


@pytest.mark.parametrize("hw,ws,d", K8_CASES)
def test_k8_bfloat16_matches_jax(hw, ws, d):
    rng = np.random.default_rng(hw[0] * 7 + d)
    b, heads = 2, 2
    qkv = _bf16(rng, b, *hw, 3 * heads * d)
    rel_h, rel_w = (_bf16(rng, b * heads, *hw, ws, scale=0.5) for _ in range(2))
    bias_kv = _bf16(rng, 3, heads * d, scale=0.5)  # non-zero: pad slots are real keys
    scale = d ** -0.5
    want16, want32 = _both(lambda *a: jax_k8(*a, scale, ws, heads, True),
                           qkv, rel_h, rel_w, bias_kv)
    assert want16.dtype == jnp.bfloat16
    args = [_t(a) for a in (qkv, rel_h, rel_w, bias_kv)]
    got = attention.fused_attention_rel_win(*args, scale, ws, heads)
    f32 = attention.attention_rel_win(*(a.float() for a in args), scale, ws, heads)
    _check(got, f32, want16, want32)
    out, lse = attention.attention_rel_win_bf16(*args, scale, ws, heads)
    assert torch.equal(out, got) and lse.shape == (b * heads, hw[0] * hw[1])


@pytest.mark.parametrize("shape,ws", [((2, 9, 11, 32), 4), ((1, 9, 14, 48), 7)])
def test_k9_bfloat16_matches_jax(shape, ws):
    rng = np.random.default_rng(shape[2])
    b, h, w, c = shape
    n_win = b * -(-h // ws) * -(-w // ws)
    windows = _bf16(rng, n_win, ws, ws, c)  # pad slots hold values that must be ignored
    shortcut = _bf16(rng, *shape, scale=2.0)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    (x16, y16), (_, y32) = _both(lambda *a: jax_k9(*a, ws, interpret=True), windows, shortcut,
                                 scale, bias, f32_also=(2, 3))
    assert x16.dtype == y16.dtype == jnp.bfloat16
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    got_x, got_y = unpartition_residual.unpartition_add_ln(_t(windows), _t(shortcut), sc, bi, ws)
    np.testing.assert_array_equal(got_x.float().numpy(), np.asarray(x16, np.float32))
    f32 = unpartition_residual.unpartition_add_ln_plain(_t(windows).float(), _t(shortcut).float(),
                                                        sc, bi, ws)[1]
    _check(got_y, f32, y16, y32)


# --- the launchers' C entry by dtype ------------------------------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Record the C entry each launcher calls, on CPU tensors: the CUDA
    checks, device and stream are stubbed; the counters are restored."""
    calls = []
    monkeypatch.setattr(attention, "_launch_on_stream",
                        lambda label, symbol, device, *args: calls.append(symbol))
    monkeypatch.setattr(attention, "_check_operand", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(unpartition_residual, "_k9_function",
                        lambda name: lambda *args: calls.append(name) or 0)
    for wrapper in (attention.fused_attention_rel, attention.fused_attention_rel_bwd,
                    attention.fused_attention, attention.fused_attention_rel_win,
                    attention.fused_attention_rel_win_bwd, unpartition_residual.unpartition_add_ln,
                    unpartition_residual.unpartition_add_ln_fused_bwd):
        for name in ("launches", "bf16_launches"):
            monkeypatch.setattr(wrapper, name, 0)
    return calls


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"), (BF, "bf16")])
def test_route_launchers_call_the_entry_of_the_operands_dtype(monkeypatch, fake_card, dtype,
                                                              suffix):
    """K6-K9 and K6b, K8b, K9b launch the C entry of their operands' dtype,
    write outputs in it (statistics and log-sum-exp in float32, K8b's
    dbias_kv in bias_kv's dtype) and count a bfloat16 launch in
    ``bf16_launches``, a float32 one in ``launches``."""
    monkeypatch.setattr(attention, "_check_head_major", lambda label, q, k, v: tuple(q.shape))
    monkeypatch.setattr(attention, "_check_k8", lambda label, qkv, rh, rw, bkv, ws, heads: (
        *qkv.shape[:3], qkv.shape[-1] // (3 * heads), ws, 4))
    monkeypatch.setattr(unpartition_residual, "_check_k9", lambda label, grid, ws, **ops: (
        *grid.shape, ws, 4))
    q = torch.zeros(4, 16, 64, dtype=dtype)
    rel = torch.zeros(4, 16, 4, dtype=dtype)
    lse = torch.zeros(4, 16)
    out, lse6 = attention._launch_k6(q, q, q, rel, rel, 0.125, (4, 4), with_lse=True)
    grads6 = attention._launch_k6_bwd(q, q, q, rel, rel, out, q, lse, 0.125, (4, 4))
    out7 = attention._launch_k7(q, q, q, torch.zeros(4, 16, 16), 0.125)
    qkv = torch.zeros(1, 5, 6, 3 * 2 * 64, dtype=dtype)
    grid_rel = torch.zeros(2, 5, 6, 4, dtype=dtype)
    bias_kv = torch.zeros(3, 128, dtype=dtype)
    out8, lse8 = attention._launch_k8(qkv, grid_rel, grid_rel, bias_kv, 0.125, 4, 2, with_lse=True)
    grads8 = attention._launch_k8_bwd(qkv, grid_rel, grid_rel, bias_kv, out8, out8, lse8, 0.125,
                                      4, 2)
    windows, shortcut = torch.zeros(4, 4, 4, 64, dtype=dtype), torch.zeros(1, 5, 6, 64, dtype=dtype)
    x_new, y, mu, rstd = unpartition_residual._launch_k9(
        windows, shortcut, torch.ones(64), torch.zeros(64), 4, with_stats=True)
    grads9 = unpartition_residual._launch_k9_bwd(x_new, x_new, y, mu, rstd, torch.ones(64), 4)
    assert fake_card == [f"mia_attention_rel_{suffix}", f"mia_attention_rel_bwd_{suffix}",
                         f"mia_attention_dense_{suffix}", f"mia_attention_rel_win_{suffix}",
                         f"mia_attention_rel_win_bwd_{suffix}", f"mia_unpartition_add_ln_{suffix}",
                         f"mia_unpartition_add_ln_bwd_{suffix}"]
    assert all(t.dtype == dtype for t in (out, out7, out8, x_new, y, *grads6, *grads8, *grads9[:2]))
    assert all(t.dtype == torch.float32 for t in (lse6, lse8, mu, rstd, *grads9[2:]))
    bf16 = dtype == BF
    for wrapper in (attention.fused_attention_rel, attention.fused_attention_rel_bwd,
                    attention.fused_attention, attention.fused_attention_rel_win,
                    attention.fused_attention_rel_win_bwd, unpartition_residual.unpartition_add_ln,
                    unpartition_residual.unpartition_add_ln_fused_bwd):
        assert (wrapper.launches, wrapper.bf16_launches) == (int(not bf16), int(bf16))


# --- a narrow encoder of each route against the JAX encoder ----------------------------

ENC_KW = dict(img_size=40, patch_size=4, embed_dim=32, depth=3, num_heads=2, window_size=4,
              global_attn_indexes=(2,))
# route → (the port's options, the JAX encoder's options reaching the same kernel on the CPU)
ROUTES = {
    "K9": (dict(fuse_unpart_residual="always"),
           dict(use_rel_pos=True, fused="always", fuse_ln_window="always",
                fuse_unpart_residual="always")),
    "K8": (dict(fuse_ln_window="never", attn_route="grid_native"),
           dict(use_rel_pos=True, fused="always")),
    "K6": (dict(attn_route="head_major"), dict(use_rel_pos=True, fused="never")),
    "K7": (dict(use_rel_pos=False), dict(use_rel_pos=False, fused="always")),
}
# the embedding's relative Frobenius distance to JAX's bfloat16 encoder: measured 8.0e-5 (K7)
# and 3.12e-4 (K6, K8, K9) against gaps of 3.27e-3 - 3.28e-3; the port's float32 encoder lies
# 3.27e-3 - 3.28e-3 away
ENC_TOL = 5e-4


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def encoder_params():
    """Seeded float32 parameters of the narrow encoder (LoRA rank 2, every leaf
    drawn, the LoRA B matrices and the tables non-zero) and an input."""
    rng = np.random.default_rng(21)
    x = _f32(rng, 2, 40, 40, 3)
    enc = JaxEncoder(use_rel_pos=True, fused="never", lora_rank=2, **ENC_KW)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda s: _f32(rng, *s.shape, scale=0.1)
                          + (1.0 if len(s.shape) == 1 and s.shape[0] in (32, 256) else 0.0), shapes)
    return x, params


def without_rel_pos(params):
    return {k: without_rel_pos(v) if isinstance(v, dict) else v
            for k, v in params.items() if k not in ("rel_pos_h", "rel_pos_w")}


def route_params(params, route):
    return without_rel_pos(params) if route == "K7" else params


def jax_encoder(route, dtype):
    return JaxEncoder(**ENC_KW, lora_rank=2, dtype=dtype, **ROUTES[route][1])


def port_encoder(params, route, dtype):
    sd = sam_state_dict_from_flax({"params": {"image_encoder": params}})
    port = ImageEncoderViT(**ENC_KW, lora_rank=2, compute_dtype=dtype, **ROUTES[route][0])
    port.load_state_dict({k.removeprefix("image_encoder."): v for k, v in sd.items()}, strict=True)
    return port


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encoder_route_embedding_matches_jax_bfloat16(encoder_params, route):
    """Each route's bfloat16 encoder, loaded with JAX's float32 parameters
    unchanged (float32 parameters, a bfloat16 embedding), within ``ENC_TOL``
    of JAX's bfloat16 encoder of the same option, under JAX's own
    bfloat16-vs-float32 gap; the port's float32 encoder misses it."""
    x, params = encoder_params
    params = route_params(params, route)
    want = {}
    for key, dtype in (("16", jnp.bfloat16), ("32", jnp.float32)):
        mdl = jax_encoder(route, dtype)
        want[key] = np.asarray(jit_op_by_op(lambda p, x: mdl.apply({"params": p}, x))(
            params, jnp.asarray(x)), np.float32)
    port = {}
    for key, dtype in (("16", BF), ("32", torch.float32)):
        enc = port_encoder(params, route, dtype)
        assert all(p.dtype == torch.float32 for p in enc.parameters())
        with torch.no_grad():
            port[key] = enc(torch.from_numpy(x))
    assert port["16"].dtype == BF and port["16"].shape == (2, 10, 10, 256)
    gap = _rel(want["16"], want["32"], want["32"])
    err = _rel(port["16"], want["16"], want["32"])
    assert err <= ENC_TOL < gap, (route, err, gap)
    assert _rel(port["32"], want["16"], want["32"]) > ENC_TOL, route


def test_encoder_options_no_longer_refuse_bfloat16(monkeypatch):
    """Every route builds in bfloat16 and the windowed-attention switch takes
    a bfloat16 encoder without K4 to K8; contradictory options still raise."""
    from mia_tpu_torch.models.sam import image_encoder as enc_module

    kw = dict(ENC_KW, compute_dtype=BF)
    for options, _ in ROUTES.values():
        ImageEncoderViT(**kw, **options)
    for options in (dict(fuse_unpart_residual="always", fuse_ln_window="never"),
                    dict(attn_route="grid_native")):
        with pytest.raises(ValueError, match="fuse_ln_window"):
            ImageEncoderViT(**kw, **options)
    calls = []
    k8 = enc_module.fused_attention_rel_win
    monkeypatch.setattr(enc_module, "fused_attention_rel_win",
                        lambda *a: (calls.append(a[0].dtype), k8(*a))[1])
    monkeypatch.setenv("MIA_WINDOWED_ATTN", "1")
    enc = ImageEncoderViT(**kw, fuse_ln_window="never")
    with torch.inference_mode():
        assert enc(torch.zeros(1, 40, 40, 3)).dtype == BF
    assert calls == [BF, BF]  # the two windowed blocks
