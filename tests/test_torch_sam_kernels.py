"""K2, K3, K4: the port's plain versions against ``mia_tpu``'s Pallas kernels
run in interpret mode, and the ops around them against their JAX
counterparts, on seeded numpy inputs.

Tolerance for the kernels: 1e-5 absolute at unit-scale inputs (float32,
different summation order). On the CPU every wrapper takes its plain
version, so each test also checks that no launch was counted.
"""

import numpy as np
import pytest

import flax.linen as nn
import jax.numpy as jnp

from mia_tpu.models.sam import common as jax_common
from mia_tpu.models.sam import image_encoder as jax_enc
from mia_tpu.ops import resize as jax_resize  # the function
from mia_tpu.ops.attention import fused_attention_rel_packed as jax_k3
from mia_tpu.ops.attention import fused_attention_rel_packed_ik as jax_k2
from mia_tpu.ops.ln_window import ln_window_partition as jax_k4

import torch

from mia_tpu_torch.models.sam import LayerNorm2d, image_encoder
from mia_tpu_torch.ops import attention, ln_window
from mia_tpu_torch.ops.resize import resize

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.fixture(autouse=True)
def _no_launches():
    counters = (attention.fused_attention_rel_packed, attention.fused_attention_rel_packed_ik,
                ln_window.ln_window_partition_fused)
    before = [c.launches for c in counters]
    yield
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("b,heads,d,ws", [(4, 2, 16, 7), (3, 3, 8, 5)])
def test_k2_plain_matches_interpret_kernel(rng, b, heads, d, ws):
    n = ws * ws
    qkv = rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
    rh = (rng.standard_normal((ws * ws, d)) * 0.2).astype(np.float32)
    rw = (rng.standard_normal((ws * ws, d)) * 0.2).astype(np.float32)
    scale = d ** -0.5
    want = np.asarray(jax_k2(jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale,
                             (ws, ws), heads, None, True))
    got = attention.fused_attention_rel_packed_ik(_t(qkv), _t(rh), _t(rw), scale, (ws, ws), heads)
    assert got.shape == (b, n, heads * d)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("b,heads,d,k_hw", [(2, 2, 16, (8, 8)), (1, 3, 8, (6, 10))])
def test_k3_plain_matches_interpret_kernel(rng, b, heads, d, k_hw):
    k_h, k_w = k_hw
    n = k_h * k_w
    qkv = rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
    rel_h = rng.standard_normal((b * heads, n, k_h)).astype(np.float32)
    rel_w = rng.standard_normal((b * heads, n, k_w)).astype(np.float32)
    scale = d ** -0.5
    want = np.asarray(jax_k3(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w), scale,
                             k_hw, heads, None, True))
    got = attention.fused_attention_rel_packed(_t(qkv), _t(rel_h), _t(rel_w), scale, k_hw, heads)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape,ws", [((2, 20, 27, 32), 7), ((1, 14, 14, 48), 14)])
def test_k4_plain_matches_interpret_kernel(rng, shape, ws):
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1 + 0.5).astype(np.float32)  # pad slots must stay 0
    want = np.asarray(jax_k4(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), ws,
                             interpret=True))
    got = ln_window.ln_window_partition_fused(_t(x), _t(scale), _t(bias), ws).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    assert (got[want == 0.0] == 0.0).all()


def test_layer_norms_match_flax(rng):
    x = (rng.standard_normal((3, 5, 40)) * 2.0 + 1.5).astype(np.float32)
    w = (rng.standard_normal(40) * 0.2 + 1.0).astype(np.float32)
    b = (rng.standard_normal(40) * 0.1).astype(np.float32)
    want = nn.LayerNorm(epsilon=1e-5).apply({"params": {"scale": w, "bias": b}}, jnp.asarray(x))
    got = ln_window.layer_norm(_t(x), _t(w), _t(b), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    want2d = jax_common.LayerNorm2d().apply({"params": {"weight": w, "bias": b}}, jnp.asarray(x))
    ln2d = LayerNorm2d(40)
    ln2d.load_state_dict({"weight": _t(w), "bias": _t(b)})
    with torch.no_grad():
        np.testing.assert_allclose(ln2d(_t(x)).numpy(), np.asarray(want2d), rtol=0, atol=TOL)


def test_window_partition_roundtrip_and_rel_terms(rng):
    x = rng.standard_normal((2, 10, 9, 6)).astype(np.float32)
    want, pad_want = jax_enc.window_partition(jnp.asarray(x), 4)
    got, pad_got = image_encoder.window_partition(_t(x), 4)
    assert pad_got == pad_want
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = image_encoder.window_unpartition(got, 4, pad_got, (10, 9))
    np.testing.assert_array_equal(back.numpy(), x)

    # rel terms of a global block, with a rel-pos table that must be resized
    b, hh, ww, heads, d = 2, 6, 5, 2, 8
    q4 = rng.standard_normal((b, hh * ww, heads, d)).astype(np.float32)
    rph = rng.standard_normal((7, d)).astype(np.float32)  # resized to 2*6-1
    rpw = rng.standard_normal((9, d)).astype(np.float32)
    want_h, want_w = jax_enc.decomposed_rel_terms_packed(
        jnp.asarray(q4), jnp.asarray(rph), jnp.asarray(rpw), (hh, ww), (hh, ww))
    got_h, got_w = image_encoder.decomposed_rel_terms_packed(
        _t(q4), _t(rph), _t(rpw), (hh, ww), (hh, ww))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=0, atol=TOL)


@pytest.mark.parametrize("method,antialias", [("bilinear", True), ("bilinear", False),
                                              ("nearest", False)])
def test_resize_matches_jax(rng, method, antialias):
    x = (rng.random((2, 19, 23, 3)) * 255).astype(np.float32)
    for size in ((32, 40), (7, 11)):
        want = np.asarray(jax_resize(jnp.asarray(x), size, method, antialias))
        got = resize(_t(x), size, method, antialias).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
