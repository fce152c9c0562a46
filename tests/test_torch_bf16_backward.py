"""The plain bfloat16 VJPs of K2b, K3b and K4b against ``jax.vjp`` of the
Pallas kernels run with bfloat16 inputs in interpret mode, and the backward
wrappers' dispatch by dtype.

Inputs come from numpy seeds, rounded to bfloat16 and handed to both. The
Pallas backward kernels round where their bfloat16 fast path rounds (p and ds
to bfloat16 before the products that read them, dq once, the rel cotangents
and K2's tables' gradient to bfloat16; float32 sums, dk and dv summed in
float32 over the query blocks and rounded once); the port's plain versions
round at the same places, but take p from the forward's log-sum-exp where the
Pallas kernels normalise their own maximum and sum. The port's VJP reads the
port's own forward (its output and log-sum-exp), as the trainer does. The
measure is ``test_torch_bf16_kernels.py``'s: every element within one
bfloat16 ulp of JAX's (the ulp taken at no less than 2^-6 of max |JAX|) and
at least 99% bit-equal. dqkv
holds it on every case (bit-equal on four of six). The rel-term cotangents
and K2's table gradients are sums of the rounded ds over a key row or
column, which cancel: where a last-bit difference of p flips one ds_lo, the
sum moves by that ds's ulp, more than its own. Measured on these inputs:
3 ulps at 99.77% bit-equal (drel_w of the 6x6 grid), every other case
within one ulp; their limit is ``REL_ULPS`` ulps at 99% bit-equal. The
float32 VJP of the same inputs, rounded to bfloat16 at the end, misses each
output's limit (7-83 ulps, 32-68% bit-equal). K4b's dx is float32 arithmetic
rounded once, in both; its dscale and dbias are float32 sums of the same
products in another order (1e-5 of max).
"""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.ops.attention import fused_attention_rel_packed as jax_k3
from mia_tpu.ops.attention import fused_attention_rel_packed_ik as jax_k2
from mia_tpu.ops.ln_window import ln_window_partition as jax_k4

import torch
from test_torch_bf16_kernels import (K3_CASES, MIN_EQUAL, _agreement, _bf16, _holds,
                                     _padded_windows, _t, _window_case)

from mia_tpu_torch.ops import attention, ln_window

PARAM_TOL = 1e-5  # K4b's float32 dscale, dbias: max |port - JAX| over max |JAX|
REL_ULPS = 4.0  # the rel-term cotangents and table gradients (sums that cancel): ulps of JAX's


def _check_outputs(names, port, port_f32, want):
    """Every output of the bfloat16 port within its limit of JAX's (dqkv one
    ulp, the rel gradients ``REL_ULPS``; 99% bit-equal); the float32 path
    rounded at the end misses each limit."""
    for name, got, f32, w in zip(names, port, port_f32, want):
        w = np.asarray(w, np.float32)
        limit = 1.0 if name == "dqkv" else REL_ULPS
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == w.shape, name
        ulps, equal = _agreement(got, w)
        assert ulps <= limit and equal >= MIN_EQUAL, (name, ulps, equal)
        ulps, equal = _agreement(f32.to(torch.bfloat16), w)
        assert ulps > limit or equal < MIN_EQUAL, (name, ulps, equal)


def _jax_vjp(fn, args, g):
    out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in args))
    assert out.dtype == jnp.bfloat16
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize("k_h,k_w,heads,d", K3_CASES)
def test_k3b_bfloat16_matches_jax(k_h, k_w, heads, d):
    rng = np.random.default_rng(k_h * 10 + d + 1)
    b, n = 2, k_h * k_w
    qkv = _bf16(rng, b, n, 3 * heads * d)
    rel_h, rel_w = _bf16(rng, b * heads, n, k_h), _bf16(rng, b * heads, n, k_w)
    g = _bf16(rng, b, n, heads * d)
    scale = d ** -0.5
    want = _jax_vjp(lambda q, rh, rw: jax_k3(q, rh, rw, scale, (k_h, k_w), heads, None, True),
                    (qkv, rel_h, rel_w), g)
    args = (_t(qkv), _t(rel_h), _t(rel_w))
    out, lse = attention.attention_rel_packed_bf16(*args, scale, (k_h, k_w), heads)
    got = attention.attention_rel_packed_bwd_bf16(*args, out, _t(g), lse, scale, (k_h, k_w), heads)
    f32 = attention.attention_rel_packed_bwd(*(a.float() for a in args), out.float(), _t(g).float(),
                                             scale, (k_h, k_w), heads)
    _check_outputs(("dqkv", "drel_h", "drel_w"), got, f32, want)


@pytest.mark.parametrize("case", ["padded windows", "grid 5x7", "head dim 24"])
def test_k2b_bfloat16_matches_jax(case):
    rng = np.random.default_rng(len(case) + 1)
    qkv, (k_h, k_w), heads, d = {
        "padded windows": lambda: _padded_windows(rng),
        "grid 5x7": lambda: _window_case(rng, 5, 7, 2, 16),
        "head dim 24": lambda: _window_case(rng, 6, 6, 2, 24),
    }[case]()
    q_h = qkv.shape[1] // k_w
    rh, rw = _bf16(rng, q_h * k_h, d, scale=0.3), _bf16(rng, k_w * k_w, d, scale=0.3)
    g = _bf16(rng, qkv.shape[0], qkv.shape[1], heads * d)
    scale = d ** -0.5
    want = _jax_vjp(lambda q, a, b: jax_k2(q, a, b, scale, (k_h, k_w), heads, None, True),
                    (qkv, rh, rw), g)
    args = (_t(qkv), _t(rh), _t(rw))
    out, lse = attention.attention_rel_packed_bf16(
        args[0], *attention.window_rel_terms(*args, (k_h, k_w), heads), scale, (k_h, k_w), heads)
    got = attention.attention_rel_packed_ik_bwd_bf16(*args, out, _t(g), lse, scale, (k_h, k_w),
                                                     heads)
    f32 = attention.attention_rel_packed_ik_bwd(*(a.float() for a in args), out.float(),
                                                _t(g).float(), scale, (k_h, k_w), heads)
    _check_outputs(("dqkv", "drh", "drw"), got, f32, want)
    without = attention.attention_rel_packed_ik_bwd_bf16(*args, out, _t(g), lse, scale,
                                                         (k_h, k_w), heads, tables=False)
    assert torch.equal(without[0], got[0]) and without[1:] == (None, None)


@pytest.mark.parametrize("shape,ws", [((2, 20, 27, 32), 7), ((1, 9, 14, 48), 14)])
def test_k4b_bfloat16_matches_jax(shape, ws):
    rng = np.random.default_rng(shape[1] + 1)
    c = shape[-1]
    x = _bf16(rng, *shape, scale=2.0)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    xt = _t(x).requires_grad_()
    y = ln_window.ln_window_partition_fused(xt, sc.requires_grad_(), bi.requires_grad_(), ws)
    dy = _bf16(rng, *y.shape)
    want = _jax_vjp(lambda a, s, b: jax_k4(a, s, b, ws, 1e-6, interpret=True), (x, scale, bias), dy)
    dx, dscale, dbias = torch.autograd.grad(y, (xt, sc, bi), _t(dy))
    f32 = ln_window.ln_window_partition_bwd(
        xt.detach().float(), _t(dy).float(),
        *(t[..., 0] for t in ln_window.layer_norm_stats(xt.detach().float(), 1e-6)),
        sc.detach(), ws)
    want_dx = np.asarray(want[0], np.float32)
    ulps, equal = _agreement(dx, want_dx)
    assert dx.dtype == torch.bfloat16 and ulps <= 1.0 and equal >= MIN_EQUAL, (ulps, equal)
    assert not _holds(f32[0], want_dx)  # the float32 dx, not rounded: a bfloat16 test
    for got, w in ((dscale, want[1]), (dbias, want[2])):
        w = np.asarray(w)
        assert got.dtype == torch.float32 and w.dtype == np.float32
        assert np.abs(got.numpy() - w).max() <= PARAM_TOL * np.abs(w).max()


def _grads_through_wrapper(wrapper, args, g):
    leaves = [a.clone().requires_grad_() for a in args[:3]]
    out = wrapper(*leaves, *args[3:])
    return out, torch.autograd.grad(out, leaves, g)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_bfloat16_wrapper_gradients_are_the_plain_bfloat16_vjp(kernel):
    """On CPU tensors the differentiable wrappers keep the plain bfloat16
    forward's log-sum-exp and run the plain bfloat16 VJP on it; no launch
    counter moves."""
    rng = np.random.default_rng(7)
    heads, d, k_hw = 2, 16, (4, 6)
    n = k_hw[0] * k_hw[1]
    qkv = _t(_bf16(rng, 3, n, 3 * heads * d))
    g = _t(_bf16(rng, 3, n, heads * d))
    counters = (attention.fused_attention_rel_packed_bwd, attention.fused_attention_rel_packed_ik_bwd)
    before = [(c.launches, c.bf16_launches) for c in counters]
    if kernel == "K2":
        tabs = (_t(_bf16(rng, k_hw[0] * k_hw[0], d, scale=0.3)),
                _t(_bf16(rng, k_hw[1] * k_hw[1], d, scale=0.3)))
        args = (qkv, *tabs, 0.25, k_hw, heads)
        out, grads = _grads_through_wrapper(attention.fused_attention_rel_packed_ik, args, g)
        _, lse = attention.attention_rel_packed_bf16(
            qkv, *attention.window_rel_terms(qkv, *tabs, k_hw, heads), 0.25, k_hw, heads)
        want = attention.attention_rel_packed_ik_bwd_bf16(qkv, *tabs, out, g, lse, 0.25, k_hw, heads)
    else:
        rels = (_t(_bf16(rng, 3 * heads, n, k_hw[0])), _t(_bf16(rng, 3 * heads, n, k_hw[1])))
        args = (qkv, *rels, 0.25, k_hw, heads)
        out, grads = _grads_through_wrapper(attention.fused_attention_rel_packed, args, g)
        _, lse = attention.attention_rel_packed_bf16(*args)
        want = attention.attention_rel_packed_bwd_bf16(qkv, *rels, out, g, lse, 0.25, k_hw, heads)
    assert out.dtype == torch.bfloat16
    assert all(a.dtype == torch.bfloat16 and torch.equal(a, b) for a, b in zip(grads, want))
    assert [(c.launches, c.bf16_launches) for c in counters] == before


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
@pytest.mark.parametrize("kernel", ["K2b", "K3b"])
def test_backward_launcher_calls_the_entry_of_the_operands_dtype(monkeypatch, kernel, dtype,
                                                                  suffix):
    """K2b's and K3b's launcher picks the C entry by the operands' dtype: the
    gradients and the rel scratch take it, lse and delta are float32; the
    bfloat16 K2b entry also takes a float32 dq scratch. The bfloat16
    launches are counted apart. Nothing widens bfloat16 to float32."""
    calls = []
    monkeypatch.setattr(attention, "_geometry", lambda label, qkv, k_hw, heads, dt:
                        (qkv.shape[0], qkv.shape[1], qkv.shape[2] // (3 * heads)))
    monkeypatch.setattr(attention, "_check_operand", lambda *a, **k: None)
    monkeypatch.setattr(attention, "_call", lambda label, symbol, qkv, tensors, *a:
                        calls.append((symbol, [None if t is None else t.dtype for t in tensors])))
    wrapper = (attention.fused_attention_rel_packed_ik_bwd if kernel == "K2b"
               else attention.fused_attention_rel_packed_bwd)
    for name in ("launches", "bf16_launches"):  # restored after the test
        monkeypatch.setattr(wrapper, name, getattr(wrapper, name))
    counts = wrapper.launches, wrapper.bf16_launches
    qkv = torch.zeros(2, 16, 3 * 2 * 64, dtype=dtype)
    out = g = torch.zeros(2, 16, 2 * 64, dtype=dtype)
    lse = torch.zeros(4, 16)
    bf16, f32 = dtype == torch.bfloat16, torch.float32
    if kernel == "K2b":
        tab = torch.zeros(16, 64, dtype=dtype)
        dqkv, drh, drw = attention._launch_k2_bwd(qkv, tab, tab, out, g, lse, 0.125, (4, 4), 2)
        # qkv, rh, rw, out, g, lse, dqkv, delta, rel, drel[, dq32], dthw
        want = [dtype] * 5 + [f32, dtype, f32, dtype, dtype] + ([f32] if bf16 else []) + [dtype]
        grads = (dqkv, drh, drw)
    else:
        rel = torch.zeros(4, 16, 4, dtype=dtype)
        grads = attention._launch_k3_bwd(qkv, rel, rel, out, g, lse, 0.125, (4, 4), 2)
        # qkv, rel_h, rel_w, out, g, lse, dqkv, delta, drel_h, drel_w
        want = [dtype] * 5 + [f32, dtype, f32, dtype, dtype]
    assert calls == [(f"mia_attention_rel_packed{'_ik' if kernel == 'K2b' else ''}_bwd_{suffix}",
                      want)]
    assert all(t.dtype == dtype for t in grads)
    assert (wrapper.launches, wrapper.bf16_launches) == (counts[0] + (not bf16), counts[1] + bf16)


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
def test_k4b_launcher_calls_the_entry_of_the_operands_dtype(monkeypatch, dtype, suffix):
    """K4b's launcher takes x and the cotangent in one dtype, the statistics
    and scale in float32, and writes dx in x's dtype, dscale and dbias in
    float32; a cotangent of the other dtype raises."""
    calls = []

    def fake(name):
        def call(x, dy, mu, rstd, scale, dx, dscale, dbias, part, *rest):
            calls.append(name)
            return 0
        return call

    monkeypatch.setattr(ln_window, "_k4_function", fake)
    monkeypatch.setattr(ln_window, "_check_k4", lambda label, x, ws, dtypes, **p: (
        *x.shape, ws, x.shape[0] * 4) if x.dtype in dtypes else pytest.fail(str(x.dtype)))
    x = torch.zeros(1, 8, 8, 16, dtype=dtype)
    dy = torch.zeros(4, 4, 4, 16, dtype=dtype)
    stats = torch.zeros(1, 8, 8)
    wrapper = ln_window.ln_window_partition_fused_bwd
    for name in ("launches", "bf16_launches"):
        monkeypatch.setattr(wrapper, name, getattr(wrapper, name))
    counts = wrapper.launches, wrapper.bf16_launches
    with monkeypatch.context() as mp:
        mp.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
        mp.setattr(torch.cuda, "current_stream", lambda device: type("S", (), {"cuda_stream": 0}))
        dx, dscale, dbias = ln_window._launch_k4_bwd(x, dy, stats, stats, torch.ones(16), 4)
        with pytest.raises(ValueError, match="cotangent"):
            ln_window._launch_k4_bwd(x, dy.to(torch.bfloat16 if dtype == torch.float32
                                              else torch.float32), stats, stats, torch.ones(16), 4)
    assert calls == [f"mia_ln_window_partition_bwd_{suffix}"]
    assert dx.dtype == dtype and dscale.dtype == dbias.dtype == torch.float32
    bf16 = dtype == torch.bfloat16
    assert (wrapper.launches, wrapper.bf16_launches) == (counts[0] + (not bf16), counts[1] + bf16)


def test_bfloat16_backward_on_a_cuda_tensor_never_widens(monkeypatch):
    """A bfloat16 backward on a CUDA tensor goes to the bfloat16 launcher, and
    a launcher that fails raises: no float32 kernel, no plain version."""
    seen = []
    monkeypatch.setattr(attention, "attention_rel_packed_bwd_bf16",
                        lambda *a: pytest.fail("the plain version ran"))
    monkeypatch.setattr(attention, "attention_rel_packed_bwd",
                        lambda *a: pytest.fail("the float32 plain version ran"))

    def launch(qkv, *rest):
        seen.append(qkv.dtype)
        raise RuntimeError("K3 backward launch failed: cudaError 1")

    monkeypatch.setattr(attention, "_launch_k3_bwd", launch)
    fake = type("T", (), {"device": torch.device("cuda", 0), "dtype": torch.bfloat16})()
    with pytest.raises(RuntimeError, match="launch failed"):
        attention.fused_attention_rel_packed_bwd(fake, None, None, None, None, None, 0.25, (4, 4), 2)
    assert seen == [torch.bfloat16]
