"""Gradients through the encoder's other routes: the plain VJPs behind K6b,
K8b, K9b and K7's tensor-code backward against ``jax.vjp`` of ``mia_tpu``'s
Pallas kernels run in interpret mode (their ``custom_vjp`` backward
kernels), and a narrow ``ImageEncoderViT`` of each route, with every
parameter trainable, against the JAX encoder of the same option (weights
through ``sam_state_dict_from_flax``) and against the port's default route.

Tolerances (float32, another order of sums):

- a VJP output: max |port − JAX| ≤ 1e-5 · max |JAX| (exactly zero where the
  JAX output is zero: ``dbias_kv`` of a grid of whole windows);
- the plain VJP against ``torch.autograd.grad`` of the plain forward: the
  same; ``torch.autograd.gradcheck`` in float64 at a tiny size;
- the encoder's loss Σ weight·embedding, a cancelling sum of 51,200 terms:
  1e-7 · Σ |weight·embedding|; its parameter gradients: max |port − JAX| ≤
  1e-4 · the largest gradient of the model, as the CPC-SAM parity tests
  hold the LoRA gradients.

On the CPU every wrapper takes its plain version: no launch is counted.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam import ImageEncoderViT as JaxEncoder
from mia_tpu.ops.attention import attention_with_padding as jax_k7_padded
from mia_tpu.ops.attention import fused_attention as jax_k7
from mia_tpu.ops.attention import fused_attention_rel as jax_k6
from mia_tpu.ops.attention import fused_attention_rel_win as jax_k8
from mia_tpu.ops.unpartition_residual import unpartition_add_ln as jax_k9

import torch

from mia_tpu_torch.models.sam import ImageEncoderViT
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.ops import attention, ln_window
from mia_tpu_torch.ops import unpartition_residual as upr

TOL = 1e-5
LOSS_TOL = 1e-7  # of the sum of the loss's absolute terms


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _f32(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _counters():
    return (attention.fused_attention_rel, attention.fused_attention_rel_bwd,
            attention.fused_attention, attention.fused_attention_rel_win,
            attention.fused_attention_rel_win_bwd, upr.unpartition_add_ln,
            upr.unpartition_add_ln_fused_bwd, attention.fused_attention_rel_packed,
            attention.fused_attention_rel_packed_ik, ln_window.ln_window_partition_fused)


@pytest.fixture(autouse=True)
def _no_launches():
    before = [c.launches for c in _counters()]
    yield
    assert [c.launches for c in _counters()] == before


def _autograd(fn, inputs, cotangents):
    """Gradients of the tensors ``inputs`` through ``fn`` (None → zeros)."""
    leaves = [t.clone().requires_grad_() for t in inputs]
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    grads = torch.autograd.grad(outs, leaves, cotangents, allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]


# --- K6b ---------------------------------------------------------------------


@pytest.mark.parametrize("bh,d,k_hw", [(4, 16, (10, 12)), (3, 32, (7, 7))])
def test_k6_vjp_matches_interpret_kernel(rng, bh, d, k_hw):
    k_h, k_w = k_hw
    n = k_h * k_w  # 120 and 49: no block of the TPU kernel divides them
    q, k, v, g = (_f32(rng, bh, n, d) for _ in range(4))
    rel_h, rel_w = _f32(rng, bh, n, k_h, scale=0.3), _f32(rng, bh, n, k_w, scale=0.3)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_k6(*a, scale, k_hw, None, True),
                     *map(jnp.asarray, (q, k, v, rel_h, rel_w)))
    want = vjp(jnp.asarray(g))
    ins = tuple(map(_t, (q, k, v, rel_h, rel_w)))
    out = attention.attention_rel(*ins, scale, k_hw)
    got = attention.attention_rel_bwd(*ins, out, _t(g), scale, k_hw)
    assert len(got) == len(want) == 5
    for x, y in zip(got, want):
        _close(x, y)
    for fn in (attention.attention_rel, attention.fused_attention_rel,
               attention.attention_rel_with_padding):  # plain forward, Function, its alias
        for x, y in zip(_autograd(lambda *a: fn(*a, scale, k_hw), ins, _t(g)), got):
            _close(x, y)


# --- K7's backward -----------------------------------------------------------


def test_k7_vjp_matches_the_jax_backward(rng):
    bh, n, d = 3, 128, 16  # one whole block of the TPU kernel
    q, k, v, g = (_f32(rng, bh, n, d) for _ in range(4))
    bias = _f32(rng, bh, n, n)
    _, vjp = jax.vjp(lambda *a: jax_k7(*a, 0.3, 128, True), *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    ins = tuple(map(_t, (q, k, v, bias)))
    got = attention.attention_dense_bwd(*ins, _t(g), 0.3)
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        _close(x, y)
    for fn in (attention.attention_dense, attention.fused_attention):
        for x, y in zip(_autograd(lambda *a: fn(*a, 0.3), ins, _t(g)), got):
            _close(x, y)


def test_k7_vjp_matches_the_padded_jax_form_on_a_ragged_token_count(rng):
    bh, n, d = 2, 120, 8  # the JAX form pads to 128 and masks the pad keys
    q, k, v, g = (_f32(rng, bh, n, d) for _ in range(4))
    bias = _f32(rng, bh, n, n)
    _, vjp = jax.vjp(lambda *a: jax_k7_padded(*a, 0.3), *map(jnp.asarray, (q, k, v, bias)))
    want = vjp(jnp.asarray(g))
    ins = tuple(map(_t, (q, k, v, bias)))
    for x, y in zip(_autograd(lambda *a: attention.attention_with_padding(*a, 0.3), ins, _t(g)),
                    want):
        _close(x, y)


# --- K8b ---------------------------------------------------------------------


@pytest.mark.parametrize("hw,heads,d,ws", [
    ((10, 9), 2, 16, 4),   # pad rows and pad columns
    ((20, 27), 2, 16, 14),  # the ragged grid of the kernel phase, window 14
    ((8, 8), 2, 16, 4),    # whole windows: dbias_kv is zero
    ((9, 8), 3, 8, 4),     # pad rows only
])
def test_k8_vjp_matches_interpret_kernel(rng, hw, heads, d, ws):
    b = 2
    h, w = hw
    qkv = _f32(rng, b, h, w, 3 * heads * d)
    rel_h, rel_w = (_f32(rng, b * heads, h, w, ws, scale=0.3) for _ in range(2))
    bias_kv = _f32(rng, 3, heads * d, scale=0.5)
    g = _f32(rng, b, h, w, heads * d)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda *a: jax_k8(*a, scale, ws, heads, True),
                     *map(jnp.asarray, (qkv, rel_h, rel_w, bias_kv)))
    want = vjp(jnp.asarray(g))
    ins = tuple(map(_t, (qkv, rel_h, rel_w, bias_kv)))
    out = attention.attention_rel_win(*ins, scale, ws, heads)
    got = attention.attention_rel_win_bwd(*ins, out, _t(g), scale, ws, heads)
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        _close(x, y)
    dbias = got[3]
    assert not dbias[0].any()  # pad queries are never computed
    assert bool(dbias[1:].any()) == bool(h % ws or w % ws)
    for fn in (attention.attention_rel_win, attention.fused_attention_rel_win):
        for x, y in zip(_autograd(lambda *a: fn(*a, scale, ws, heads), ins, _t(g)), got):
            _close(x, y)


# --- K9b ---------------------------------------------------------------------


@pytest.mark.parametrize("shape,ws", [((2, 10, 9, 32), 4), ((1, 20, 27, 16), 14), ((2, 8, 8, 24), 4)])
def test_k9_vjp_matches_interpret_kernel(rng, shape, ws):
    b, h, w, c = shape
    n_win = b * -(-h // ws) * -(-w // ws)
    windows, shortcut = _f32(rng, n_win, ws, ws, c), _f32(rng, *shape, scale=1.5, shift=0.3)
    scale, bias = _f32(rng, c, scale=0.2, shift=1.0), _f32(rng, c, scale=0.1, shift=0.5)
    dx_new, dy = _f32(rng, *shape), _f32(rng, *shape)
    _, vjp = jax.vjp(lambda *a: jax_k9(*a, ws, interpret=True),
                     *map(jnp.asarray, (windows, shortcut, scale, bias)))
    want = vjp((jnp.asarray(dx_new), jnp.asarray(dy)))
    ins = tuple(map(_t, (windows, shortcut, scale, bias)))
    x_new, _ = upr.unpartition_add_ln_plain(*ins, ws)
    mu, rstd = (s[..., 0] for s in ln_window.layer_norm_stats(x_new, 1e-6))
    got = upr.unpartition_add_ln_bwd(x_new, _t(dx_new), _t(dy), mu, rstd, ins[2], ws)
    assert len(got) == len(want) == 4
    for x, y in zip(got, want):
        _close(x, y)
    pad = ln_window.window_partition(torch.ones(b, h, w, 1), ws)[0] == 0
    assert not got[0][pad.expand_as(got[0])].any()  # the pad slots' cotangent is exactly zero
    no_params = upr.unpartition_add_ln_bwd(x_new, _t(dx_new), _t(dy), mu, rstd, ins[2], ws,
                                           params=False)
    assert no_params[2] is None and no_params[3] is None
    assert torch.equal(no_params[0], got[0]) and torch.equal(no_params[1], got[1])
    for fn in (upr.unpartition_add_ln_plain, upr.unpartition_add_ln):
        for x, y in zip(_autograd(lambda *a: fn(*a, ws), ins, (_t(dx_new), _t(dy))), got):
            _close(x, y)


# --- float64 gradcheck of the Functions at a tiny size ------------------------


def _f64(rng, *shape, scale=1.0):
    return torch.from_numpy(rng.standard_normal(shape) * scale).requires_grad_()


@pytest.mark.parametrize("kernel", ["K6", "K7", "K8", "K9"])
def test_route_functions_pass_gradcheck_in_float64(rng, kernel):
    if kernel == "K6":
        ins = (*(_f64(rng, 2, 6, 4) for _ in range(3)), _f64(rng, 2, 6, 2), _f64(rng, 2, 6, 3))
        fn = lambda *a: attention.fused_attention_rel(*a, 0.5, (2, 3))  # noqa: E731
    elif kernel == "K7":
        ins = (*(_f64(rng, 2, 5, 4) for _ in range(3)), _f64(rng, 2, 5, 5))
        fn = lambda *a: attention.fused_attention(*a, 0.5)  # noqa: E731
    elif kernel == "K8":
        ins = (_f64(rng, 1, 3, 4, 3 * 2 * 2), _f64(rng, 2, 3, 4, 2), _f64(rng, 2, 3, 4, 2),
               _f64(rng, 3, 4))
        fn = lambda *a: attention.fused_attention_rel_win(*a, 0.5, 2, 2)  # noqa: E731
    else:
        ins = (_f64(rng, 4, 2, 2, 6), _f64(rng, 1, 3, 4, 6), _f64(rng, 6), _f64(rng, 6))
        fn = lambda *a: upr.unpartition_add_ln(*a, 2)  # noqa: E731
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-6, rtol=1e-5)


# --- the encoder of each route, every parameter trainable ----------------------

ENC_KW = dict(img_size=40, patch_size=4, embed_dim=32, depth=3, num_heads=2, window_size=4,
              global_attn_indexes=(2,))  # 10x10 tokens, window 4: 9 windows with pad slots
ROUTES = {  # route → (the port's options, the JAX encoder's options), as test_torch_attn_routes.py
    "default": (dict(), dict(use_rel_pos=True, fused="always", fuse_ln_window="always")),
    "K9": (dict(fuse_unpart_residual="always"),
           dict(use_rel_pos=True, fused="always", fuse_ln_window="always",
                fuse_unpart_residual="always")),
    "K8": (dict(fuse_ln_window="never", attn_route="grid_native"),
           dict(use_rel_pos=True, fused="always")),
    "K6": (dict(attn_route="head_major"), dict(use_rel_pos=True, fused="never")),
    "K7": (dict(use_rel_pos=False), dict(use_rel_pos=False, fused="always")),
}


@pytest.fixture(scope="module")
def encoder_case():
    rng = np.random.default_rng(12)
    x = _f32(rng, 2, 40, 40, 3)
    weight = _f32(rng, 2, 10, 10, 256)  # the loss: sum(weight · embedding)
    enc = JaxEncoder(use_rel_pos=True, fused="never", **ENC_KW)
    shapes = jax.eval_shape(enc.init, jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda s: _f32(rng, *s.shape, scale=0.1)
                          + (1.0 if len(s.shape) == 1 and s.shape[0] in (32, 256) else 0.0), shapes)
    return x, weight, params


def _without_rel_pos(params):
    return {k: _without_rel_pos(v) if isinstance(v, dict) else v
            for k, v in params.items() if k not in ("rel_pos_h", "rel_pos_w")}


def _port_loss_and_grads(params, x, weight, **options):
    sd = sam_state_dict_from_flax({"params": {"image_encoder": params}})
    port = ImageEncoderViT(**ENC_KW, **options)
    port.load_state_dict({k.removeprefix("image_encoder."): v for k, v in sd.items()}, strict=True)
    terms = port(torch.from_numpy(x)) * torch.from_numpy(weight)
    loss = terms.sum()
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, list(port.parameters()))
    return (loss.item(), LOSS_TOL * terms.abs().sum().item()), dict(zip(names, grads))


def _assert_grads_close(got, want, names=None):
    names = list(want) if names is None else names
    scale = max(float(want[n].abs().max()) for n in names)
    for n in names:
        assert got[n].shape == want[n].shape, n
        assert float((got[n] - want[n]).abs().max()) <= 1e-4 * scale, n


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_encoder_route_gradients_match_jax_encoder(encoder_case, route):
    x, weight, params = encoder_case
    port_options, jax_options = ROUTES[route]
    if not jax_options["use_rel_pos"]:
        params = _without_rel_pos(params)
    enc = JaxEncoder(**ENC_KW, **jax_options)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jnp.sum(enc.apply({"params": p}, jnp.asarray(x)) * jnp.asarray(weight)))(params)
    want = {k.removeprefix("image_encoder."): v for k, v in sam_state_dict_from_flax(
        {"params": {"image_encoder": jax.device_get(want_grads)}}).items()}
    (loss, tol), got = _port_loss_and_grads(params, x, weight, **port_options)
    assert abs(loss - float(want_loss)) <= tol
    assert set(got) == set(want)
    _assert_grads_close(got, want)
    if route == "K8":  # the pad slots' dk and dv reach the qkv bias through bias_kv
        assert all(float(got[f"blocks.{i}.attn.qkv.bias"][32:].abs().max()) > 0 for i in (0, 1))


@pytest.mark.parametrize("route", ["K9", "K8", "K6"])
def test_encoder_route_gradients_match_the_ports_default(encoder_case, route):
    x, weight, params = encoder_case
    (want_loss, tol), want = _port_loss_and_grads(params, x, weight)
    (loss, _), got = _port_loss_and_grads(params, x, weight, **ROUTES[route][0])
    assert abs(loss - want_loss) <= tol
    _assert_grads_close(got, want)


def test_windowed_attn_switch_trains_through_the_grid_native_route(encoder_case, monkeypatch):
    x, weight, params = encoder_case
    (want_loss, tol), want = _port_loss_and_grads(params, x, weight)
    monkeypatch.setenv("MIA_WINDOWED_ATTN", "1")
    (loss, _), got = _port_loss_and_grads(params, x, weight, fuse_ln_window="never")
    assert abs(loss - want_loss) <= tol
    _assert_grads_close(got, want)


def test_lora_encoder_trains_through_every_route(rng):
    """LoRA-2 encoders of every route from one state dict: the loss and the
    adapters' gradients agree with the default route's (the no-rel-pos one
    with the default's tables zeroed), the frozen rest gets none."""
    torch.manual_seed(3)
    base = ImageEncoderViT(**ENC_KW, lora_rank=2)
    with torch.no_grad():
        for n, p in base.named_parameters():
            if "rel_pos" in n or "lora_b" in n:
                p.copy_(0.1 * torch.randn(p.shape))
    x, weight = _t(_f32(rng, 2, 40, 40, 3)), _t(_f32(rng, 2, 10, 10, 256))

    def run(state, **options):
        enc = ImageEncoderViT(**ENC_KW, lora_rank=2, **options)
        enc.load_state_dict({k: v for k, v in state.items()
                             if options.get("use_rel_pos", True) or "rel_pos" not in k})
        lora = {n: p for n, p in enc.named_parameters() if "lora_" in n}
        for n, p in enc.named_parameters():
            p.requires_grad_(n in lora)
        terms = enc(x) * weight
        loss = terms.sum()
        return ((loss.item(), LOSS_TOL * terms.abs().sum().item()),
                dict(zip(lora, torch.autograd.grad(loss, list(lora.values())))))

    state = base.state_dict()
    zeroed = {k: torch.zeros_like(v) if "rel_pos" in k else v for k, v in state.items()}
    for options in (dict(fuse_unpart_residual="always"), dict(attn_route="head_major"),
                    dict(fuse_ln_window="never", attn_route="grid_native"),
                    dict(use_rel_pos=False)):
        (want_loss, tol), want = run(state if options.get("use_rel_pos", True) else zeroed)
        (loss, _), got = run(state, **options)
        assert abs(loss - want_loss) <= tol, options
        assert len(got) == 12
        _assert_grads_close(got, want)
