"""The backward kernels of K2, K3, K4 and the connected-components kernel K5:
the port's plain versions against ``mia_tpu``'s, on seeded numpy inputs.

- Plain VJPs against ``jax.vjp`` of the Pallas kernels run in interpret
  mode (their ``custom_vjp`` backward kernels): max |port − JAX| ≤ 1e-5 ·
  max |JAX| for each output (float32, another summation order).
- The same VJPs against ``torch.autograd.grad`` of the plain forwards, and
  the autograd Functions of the wrappers against both.
- K5's plain version against ``connected_components(mask, 2, 16)`` and
  ``connected_components_pallas(..., interpret=True)``: bit for bit,
  including masks that have not converged after 16 sweeps.
- ``component_sizes_and_largest`` and the batched EDT of prompt generation
  against the JAX package's (exact: integer sizes, integer squared
  distances).

On the CPU every wrapper takes its plain version: no launch is counted.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam.prompt_generation import _distance_to_zero as jax_distance_to_zero
from mia_tpu.ops import morphology as jax_morph
from mia_tpu.ops.attention import fused_attention_rel_packed as jax_k3
from mia_tpu.ops.attention import fused_attention_rel_packed_ik as jax_k2
from mia_tpu.ops.ln_window import ln_window_partition as jax_k4

import torch

from mia_tpu_torch.models.sam.prompt_generation import distance_to_zero
from mia_tpu_torch.ops import attention, ln_window, morphology

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(autouse=True)
def _no_launches():
    counters = (attention.fused_attention_rel_packed, attention.fused_attention_rel_packed_ik,
                attention.fused_attention_rel_packed_bwd, attention.fused_attention_rel_packed_ik_bwd,
                ln_window.ln_window_partition_fused, ln_window.ln_window_partition_fused_bwd,
                morphology.connected_components_fused)
    before = [c.launches for c in counters]
    yield
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("b,heads,d,ws", [(3, 2, 16, 7), (2, 3, 8, 5)])
def test_k2_vjp_matches_interpret_kernel(rng, b, heads, d, ws):
    n = ws * ws
    qkv = rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
    rh = (rng.standard_normal((n, d)) * 0.2).astype(np.float32)
    rw = (rng.standard_normal((n, d)) * 0.2).astype(np.float32)
    g = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    scale = d ** -0.5
    out, vjp = jax.vjp(lambda q, a, c: jax_k2(q, a, c, scale, (ws, ws), heads, None, True),
                       jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw))
    want = vjp(jnp.asarray(g))
    port_out = attention.attention_rel_packed_ik(_t(qkv), _t(rh), _t(rw), scale, (ws, ws), heads)
    got = attention.attention_rel_packed_ik_bwd(_t(qkv), _t(rh), _t(rw), port_out, _t(g), scale,
                                                (ws, ws), heads)
    for x, y in zip(got, want):
        _close(x, y)
    dqkv, drh, drw = attention.attention_rel_packed_ik_bwd(
        _t(qkv), _t(rh), _t(rw), port_out, _t(g), scale, (ws, ws), heads, tables=False)
    assert drh is None and drw is None
    _close(dqkv, want[0])


@pytest.mark.parametrize("b,heads,d,k_hw", [(2, 2, 16, (8, 8)), (1, 3, 8, (6, 10))])
def test_k3_vjp_matches_interpret_kernel(rng, b, heads, d, k_hw):
    k_h, k_w = k_hw
    n = k_h * k_w
    qkv = rng.standard_normal((b, n, 3 * heads * d)).astype(np.float32)
    rel_h = rng.standard_normal((b * heads, n, k_h)).astype(np.float32)
    rel_w = rng.standard_normal((b * heads, n, k_w)).astype(np.float32)
    g = rng.standard_normal((b, n, heads * d)).astype(np.float32)
    scale = d ** -0.5
    _, vjp = jax.vjp(lambda q, a, c: jax_k3(q, a, c, scale, k_hw, heads, None, True),
                     jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w))
    want = vjp(jnp.asarray(g))
    out = attention.attention_rel_packed(_t(qkv), _t(rel_h), _t(rel_w), scale, k_hw, heads)
    got = attention.attention_rel_packed_bwd(_t(qkv), _t(rel_h), _t(rel_w), out, _t(g), scale,
                                             k_hw, heads)
    for x, y in zip(got, want):
        _close(x, y)


@pytest.mark.parametrize("shape,ws", [((2, 20, 27, 32), 7), ((1, 14, 14, 48), 14)])
def test_k4_vjp_matches_interpret_kernel(rng, shape, ws):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 1.5 + 0.3).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1 + 0.5).astype(np.float32)
    out, vjp = jax.vjp(lambda a, s, o: jax_k4(a, s, o, ws, interpret=True),
                       jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    dy = rng.standard_normal(out.shape).astype(np.float32)
    want = vjp(jnp.asarray(dy))
    mu, rstd = (t[..., 0] for t in ln_window.layer_norm_stats(_t(x), 1e-6))
    got = ln_window.ln_window_partition_bwd(_t(x), _t(dy), mu, rstd, _t(scale), ws)
    for a, b in zip(got, want):
        _close(a, b)
    dx, dscale, dbias = ln_window.ln_window_partition_bwd(_t(x), _t(dy), mu, rstd, _t(scale), ws,
                                                          params=False)
    assert dscale is None and dbias is None
    _close(dx, want[0])


def _leaves(*ts):
    return [t.detach().clone().requires_grad_(True) for t in ts]


@pytest.mark.parametrize("kernel", ["K2", "K3", "K4"])
def test_vjps_and_functions_match_autograd_of_the_plain_forward(rng, kernel):
    """The plain VJP and the wrapper's autograd Function (CPU path) against
    ``torch.autograd.grad`` of the plain forward."""
    if kernel == "K4":
        shape, ws = (2, 9, 11, 24), 4
        x, s, o = _t(rng.standard_normal(shape)), _t(1 + 0.2 * rng.standard_normal(24)), \
            _t(0.1 * rng.standard_normal(24))
        plain = lambda a, b, c: ln_window.ln_window_partition(a, b, c, ws)  # noqa: E731
        fused = lambda a, b, c: ln_window.ln_window_partition_fused(a, b, c, ws)  # noqa: E731
        inputs = (x, s, o)
        dy = _t(rng.standard_normal(plain(*inputs).shape))
        mu, rstd = (t[..., 0] for t in ln_window.layer_norm_stats(x, 1e-6))
        vjp = ln_window.ln_window_partition_bwd(x, dy, mu, rstd, s, ws)
    else:
        b, heads, d, k_hw = 3, 2, 8, (5, 5)
        n = 25
        qkv = _t(rng.standard_normal((b, n, 3 * heads * d)))
        if kernel == "K2":
            rel = (_t(0.2 * rng.standard_normal((n, d))), _t(0.2 * rng.standard_normal((n, d))))
            plain, fused = attention.attention_rel_packed_ik, attention.fused_attention_rel_packed_ik
            bwd = attention.attention_rel_packed_ik_bwd
        else:
            rel = (_t(rng.standard_normal((b * heads, n, 5))),
                   _t(rng.standard_normal((b * heads, n, 5))))
            plain, fused = attention.attention_rel_packed, attention.fused_attention_rel_packed
            bwd = attention.attention_rel_packed_bwd
        inputs = (qkv, *rel)
        args = (d ** -0.5, k_hw, heads)
        plain = (lambda f: lambda q, a, c: f(q, a, c, *args))(plain)
        fused = (lambda f: lambda q, a, c: f(q, a, c, *args))(fused)
        dy = _t(rng.standard_normal((b, n, heads * d)))
        vjp = bwd(*inputs, plain(*inputs), dy, *args)
    leaves = _leaves(*inputs)
    want = torch.autograd.grad(plain(*leaves), leaves, dy)
    leaves = _leaves(*inputs)
    via_function = torch.autograd.grad(fused(*leaves), leaves, dy)
    for got_vjp, got_fn, w in zip(vjp, via_function, want):
        _close(got_vjp, w.numpy())
        _close(got_fn, w.numpy())


def _cc_cases(rng, size=24):
    """Square (size, size) masks: random, blob, speckled, spiral, a
    diagonal staircase that 16 sweeps do not converge, empty and full."""
    yy, xx = np.mgrid[0:size, 0:size]
    blob = np.zeros((size, size), np.int32)
    for cy, cx, r in ((5, 6, 4), (15, 17, 5), (20, 4, 3)):
        blob |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.int32)
    spiral = np.zeros((size, size), np.int32)  # one long winding component
    for k in range(0, size // 2, 2):
        spiral[k, k:size - k] = spiral[size - 1 - k, k:size - k] = 1
        spiral[k:size - k, size - 1 - k] = 1
        spiral[k + 2:size - k, k] = 1
    return {
        "random": (rng.random((size, size)) < 0.5).astype(np.int32),
        "blob": blob,
        "speckle": (rng.random((size, size)) < 0.62).astype(np.int32),
        "spiral": spiral,
        "staircase": np.eye(size, dtype=np.int32)[::-1] | np.eye(size, k=2, dtype=np.int32),
        "empty": np.zeros((size, size), np.int32),
        "full": np.ones((size, size), np.int32),
    }


def test_k5_plain_is_bit_exact_against_jax(rng):
    cases = _cc_cases(rng)
    stack = jnp.asarray(np.stack(list(cases.values())))
    want = np.asarray(jax.vmap(lambda m: jax_morph.connected_components(m, 2, 16))(stack))
    want_pallas = np.asarray(jax.vmap(
        lambda m: jax_morph.connected_components_pallas(m, 2, 16, interpret=True))(stack))
    converged = np.asarray(jax.vmap(lambda m: jax_morph.connected_components(m, 2, None))(stack))
    got = morphology.connected_components_fused(torch.from_numpy(np.array(stack))).numpy()
    assert got.dtype == np.int32
    for i, name in enumerate(cases):
        np.testing.assert_array_equal(got[i], want[i], err_msg=name)
        np.testing.assert_array_equal(got[i], want_pallas[i], err_msg=name)
    # diagonal-only links advance one pixel a sweep: the staircase is cut off
    k = list(cases).index("staircase")
    assert not (converged[k] == want[k]).all()
    # a non-square mask, two leading axes, 4-connectivity
    rect = (rng.random((2, 3, 16, 25)) < 0.55).astype(np.int32)
    got = morphology.connected_components(torch.from_numpy(rect), 1, 5).numpy()
    want = np.asarray(jax.vmap(jax.vmap(lambda m: jax_morph.connected_components(m, 1, 5)))(
        jnp.asarray(rect)))
    np.testing.assert_array_equal(got, want)


def test_component_sizes_and_largest_match_jax(rng):
    cases = _cc_cases(rng)
    stack = np.stack([cases[k] for k in ("random", "blob", "staircase", "empty", "full")])
    lab, size_map, largest = morphology.component_sizes_and_largest(torch.from_numpy(stack))
    want = jax.vmap(lambda m: jax_morph.component_sizes_and_largest(m, max_iters=16))(
        jnp.asarray(stack))
    for got_t, want_t in zip((lab, size_map, largest), want):
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))


def test_batched_edt_matches_jax_vmapped_distance(rng):
    cases = _cc_cases(rng)
    stack = np.stack([cases[k] for k in ("random", "blob", "spiral", "empty", "full")])
    want = np.asarray(jax.vmap(jax_distance_to_zero)(jnp.asarray(stack)))
    got = distance_to_zero(torch.from_numpy(stack[None]))[0].numpy()
    np.testing.assert_array_equal(got, want)
