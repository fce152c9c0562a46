"""K6, K7, K8, K9 and the encoder routes that reach them: the port's plain
versions against ``mia_tpu``'s Pallas kernels run in interpret mode, and a
narrow ``ImageEncoderViT`` of each route against the JAX encoder built with
the same option (weights through ``sam_state_dict_from_flax``), on seeded
numpy inputs.

Tolerance: rtol 1e-4, atol 1e-5 (float32, another order of sums). On the
CPU every wrapper takes its plain version, so each test also checks that no
launch was counted.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam import ImageEncoderViT as JaxEncoder
from mia_tpu.ops.attention import attention_rel_with_padding as jax_k6_unpadded
from mia_tpu.ops.attention import attention_with_padding as jax_k7_padded
from mia_tpu.ops.attention import fused_attention_rel as jax_k6
from mia_tpu.ops.attention import fused_attention_rel_win as jax_k8
from mia_tpu.ops.unpartition_residual import unpartition_add_ln as jax_k9

import torch

from mia_tpu_torch.models.sam import ImageEncoderViT
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.ops import attention, ln_window, unpartition_residual

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _counters():
    return (attention.fused_attention_rel_packed, attention.fused_attention_rel_packed_ik,
            attention.fused_attention_rel, attention.fused_attention,
            attention.fused_attention_rel_win, ln_window.ln_window_partition_fused,
            unpartition_residual.unpartition_add_ln)


@pytest.fixture(autouse=True)
def _no_launches():
    before = [c.launches for c in _counters()]
    yield
    assert [c.launches for c in _counters()] == before


# --- function against function ---------------------------------------------


@pytest.mark.parametrize("k_hw", [(10, 12), (14, 14)])
def test_k6_plain_matches_interpret_kernel(rng, k_hw):
    bh, d = 4, 8
    k_h, k_w = k_hw
    n = k_h * k_w
    q, k, v = (_f32(rng, bh, n, d) for _ in range(3))
    rel_h, rel_w = _f32(rng, bh, n, k_h, scale=0.2), _f32(rng, bh, n, k_w, scale=0.2)
    want = np.asarray(jax_k6(*map(jnp.asarray, (q, k, v, rel_h, rel_w)), 0.25, k_hw, None, True))
    got = attention.fused_attention_rel(*map(_t, (q, k, v, rel_h, rel_w)), 0.25, k_hw)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    same = attention.attention_rel_with_padding(*map(_t, (q, k, v, rel_h, rel_w)), 0.25, k_hw)
    assert torch.equal(same, got)
    unpadded = jax_k6_unpadded(*map(jnp.asarray, (q, k, v, rel_h, rel_w)), 0.25, k_hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(unpadded), rtol=RTOL, atol=ATOL)


def test_k7_plain_matches_interpret_kernel(rng):
    bh, n, d = 4, 120, 8  # N not a multiple of the TPU block: the JAX form pads and masks
    q, k, v = (_f32(rng, bh, n, d) for _ in range(3))
    bias = _f32(rng, bh, n, n)
    want = np.asarray(jax_k7_padded(*map(jnp.asarray, (q, k, v, bias)), 0.3))
    got = attention.fused_attention(*map(_t, (q, k, v, bias)), 0.3)
    assert got.shape == (bh, n, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(attention.attention_with_padding(*map(_t, (q, k, v, bias)), 0.3), got)


@pytest.mark.parametrize("bh,n,d", [(3, 35, 64)])
def test_k7_plain_matches_interpret_kernel_at_odd_n_with_masked_keys(rng, bh, n, d):
    """The yardstick the card holds K7 against, at an N no tile divides, with
    keys masked by -1e30 as the JAX wrapper masks its pad keys: every row
    keeps some keys, one row's first 16 keys are all masked."""
    q, k, v = (_f32(rng, bh, n, d) for _ in range(3))
    bias = _f32(rng, bh, n, n)
    bias[:, :, rng.random(n) < 0.3] = -1e30
    bias[:, 0, :16] = -1e30
    bias[:, :, n - 1] = 0.0
    want = np.asarray(jax_k7_padded(*map(jnp.asarray, (q, k, v, bias)), d ** -0.5))
    got = attention.attention_dense(*map(_t, (q, k, v, bias)), d ** -0.5)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    assert torch.equal(attention.fused_attention(*map(_t, (q, k, v, bias)), d ** -0.5), got)


@pytest.mark.parametrize("hw,heads,d", [((10, 9), 2, 8), ((8, 8), 2, 8), ((12, 12), 3, 8)])
def test_k8_plain_matches_interpret_kernel(rng, hw, heads, d):
    b, ws = 2, 4
    h, w = hw
    qkv = _f32(rng, b, h, w, 3 * heads * d)
    rel_h, rel_w = (_f32(rng, b * heads, h, w, ws, scale=0.3) for _ in range(2))
    bias_kv = _f32(rng, 3, heads * d, scale=0.5)  # non-zero: pad slots are real keys
    want = np.asarray(jax_k8(*map(jnp.asarray, (qkv, rel_h, rel_w, bias_kv)), 0.35, ws, heads,
                             True))
    got = attention.fused_attention_rel_win(*map(_t, (qkv, rel_h, rel_w, bias_kv)), 0.35, ws, heads)
    assert got.shape == (b, h, w, heads * d)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    if h % ws or w % ws:  # the pad slots' k and v reach the real tokens
        other = attention.fused_attention_rel_win(
            _t(qkv), _t(rel_h), _t(rel_w), _t(bias_kv) + 1.0, 0.35, ws, heads)
        assert (other - got).abs().max() > 1e-3


@pytest.mark.parametrize("shape,ws", [((2, 10, 9, 16), 4), ((1, 8, 8, 24), 4)])
def test_k9_plain_matches_interpret_kernel(rng, shape, ws):
    b, h, w, c = shape
    n_win = b * -(-h // ws) * -(-w // ws)
    windows = _f32(rng, n_win, ws, ws, c)  # pad slots hold values that must be ignored
    shortcut = _f32(rng, *shape)
    scale, bias = _f32(rng, c, scale=0.2) + 1.0, _f32(rng, c, scale=0.1)
    want_x, want_y = jax_k9(*map(jnp.asarray, (windows, shortcut, scale, bias)), ws,
                            interpret=True)
    got_x, got_y = unpartition_residual.unpartition_add_ln(
        *map(_t, (windows, shortcut, scale, bias)), ws)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=RTOL, atol=ATOL)


def test_plain_versions_are_differentiable_on_the_cpu(rng):
    q = _t(_f32(rng, 2, 16, 8)).requires_grad_()
    rel = _t(_f32(rng, 2, 16, 4)).requires_grad_()
    out = attention.fused_attention_rel(q, q, q, rel, rel, 0.3, (4, 4)).sum()
    out = out + attention.fused_attention(q, q, q, torch.zeros(2, 16, 16), 0.3).sum()
    qkv = _t(_f32(rng, 1, 5, 6, 48)).requires_grad_()
    bias_kv = _t(_f32(rng, 3, 16)).requires_grad_()
    rel_g = _t(_f32(rng, 2, 5, 6, 4))
    out = out + attention.fused_attention_rel_win(qkv, rel_g, rel_g, bias_kv, 0.3, 4, 2).sum()
    windows = _t(_f32(rng, 4, 4, 4, 16)).requires_grad_()
    x_new, y = unpartition_residual.unpartition_add_ln(
        windows, _t(_f32(rng, 1, 5, 6, 16)), torch.ones(16), torch.zeros(16), 4)
    (out + x_new.sum() + y.square().sum()).backward()
    for t in (q, rel, qkv, bias_kv, windows):
        assert t.grad is not None and torch.isfinite(t.grad).all()
    assert bias_kv.grad[0].abs().max() == 0 and bias_kv.grad[1:].abs().max() > 0  # pad q unused


# --- encoder routes -----------------------------------------------------------

ENC_KW = dict(img_size=40, patch_size=4, embed_dim=32, depth=3, num_heads=2, window_size=4,
              global_attn_indexes=(2,))  # 10x10 tokens, window 4: 9 windows with pad slots

# route → (the port's options, the JAX encoder's options that reach the same
# kernel on the CPU). K6 is never reached through the JAX encoder off the
# TPU (its packed predicate is true in interpret mode), so the head-major
# port is held against the JAX encoder's einsum path, the same function.
ROUTES = {
    "default": (dict(), dict(use_rel_pos=True, fused="always", fuse_ln_window="always")),
    "K9": (dict(fuse_unpart_residual="always"),
           dict(use_rel_pos=True, fused="always", fuse_ln_window="always",
                fuse_unpart_residual="always")),
    "K8": (dict(fuse_ln_window="never", attn_route="grid_native"),
           dict(use_rel_pos=True, fused="always")),
    "K6": (dict(attn_route="head_major"), dict(use_rel_pos=True, fused="never")),
    "K7": (dict(use_rel_pos=False), dict(use_rel_pos=False, fused="always")),
}


def _randomized(params, rng):
    """Every leaf redrawn from the seed (zero-initialised tables included)."""
    return jax.tree.map(lambda a: _f32(rng, *a.shape, scale=0.1)
                        + (1.0 if a.ndim == 1 and a.shape[0] in (32, 256) else 0.0), params)


@pytest.fixture(scope="module")
def encoder_case():
    rng = np.random.default_rng(11)
    x = _f32(rng, 2, 40, 40, 3)
    enc = JaxEncoder(use_rel_pos=True, fused="never", **ENC_KW)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _randomized(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes), rng)
    return x, params


def _without_rel_pos(params):
    return {k: _without_rel_pos(v) if isinstance(v, dict) else v
            for k, v in params.items() if k not in ("rel_pos_h", "rel_pos_w")}


def _port_encoder(params, **options):
    sd = sam_state_dict_from_flax({"params": {"image_encoder": params}})
    port = ImageEncoderViT(**ENC_KW, **options)
    port.load_state_dict({k.removeprefix("image_encoder."): v for k, v in sd.items()}, strict=True)
    return port.eval()


def _run(port, x):
    with torch.no_grad():
        return port(torch.from_numpy(x)).numpy()


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encoder_route_matches_jax_encoder_of_the_same_option(encoder_case, route):
    x, params = encoder_case
    port_options, jax_options = ROUTES[route]
    if not jax_options["use_rel_pos"]:
        params = _without_rel_pos(params)
    want = np.asarray(JaxEncoder(**ENC_KW, **jax_options).apply({"params": params},
                                                               jnp.asarray(x)))
    got = _run(_port_encoder(params, **port_options), x)
    assert got.shape == want.shape == (2, 10, 10, 256)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("route", ["K9", "K8", "K6", "never"])
def test_encoder_route_matches_the_ports_default(encoder_case, route):
    x, params = encoder_case
    options = dict(fuse_ln_window="never") if route == "never" else ROUTES[route][0]
    want = _run(_port_encoder(params), x)
    got = _run(_port_encoder(params, **options), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_encoder_without_rel_pos_matches_zeroed_tables(encoder_case):
    x, params = encoder_case
    zeroed = jax.tree_util.tree_map_with_path(
        lambda path, a: np.zeros_like(a) if "rel_pos" in jax.tree_util.keystr(path) else a, params)
    port = _port_encoder(_without_rel_pos(params), use_rel_pos=False)
    assert not [n for n, _ in port.named_parameters() if "rel_pos" in n]
    np.testing.assert_allclose(_run(port, x), _run(_port_encoder(zeroed), x), rtol=RTOL, atol=ATOL)


def test_windowed_attn_switch_selects_the_grid_native_route_only_without_k4(
        encoder_case, monkeypatch):
    """``MIA_WINDOWED_ATTN=1`` is read when the block is called and takes a
    windowed block to K8 only if it was built with ``fuse_ln_window="never"``;
    while K4 feeds the block the switch does nothing."""
    from mia_tpu_torch.models.sam import image_encoder as enc_module

    x, params = encoder_case
    calls = []
    k8 = enc_module.fused_attention_rel_win
    monkeypatch.setattr(enc_module, "fused_attention_rel_win",
                        lambda *a: (calls.append(1), k8(*a))[1])
    never, auto = _port_encoder(params, fuse_ln_window="never"), _port_encoder(params)
    want = _run(auto, x)
    _run(never, x)
    assert calls == []  # the switch is off
    monkeypatch.setenv("MIA_WINDOWED_ATTN", "1")
    got = _run(never, x)
    assert len(calls) == 2  # the two windowed blocks
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _run(auto, x)
    assert len(calls) == 2  # K4 feeds the block: nothing changes
    monkeypatch.setenv("MIA_WINDOWED_ATTN", "0")
    _run(never, x)
    assert len(calls) == 2


def test_grid_smaller_than_a_window_partitions_instead_of_k8(rng):
    kw = dict(img_size=12, patch_size=4, embed_dim=16, depth=1, num_heads=2, window_size=4)
    torch.manual_seed(0)
    base = ImageEncoderViT(**kw)
    native = ImageEncoderViT(**kw, fuse_ln_window="never", attn_route="grid_native")
    native.load_state_dict(base.state_dict())
    x = _t(_f32(rng, 1, 12, 12, 3))
    with torch.no_grad():
        np.testing.assert_allclose(native(x).numpy(), base(x).numpy(), rtol=RTOL, atol=ATOL)
