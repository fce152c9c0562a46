"""The plain bfloat16 versions of K2, K3 and K4 against the Pallas kernels run
with bfloat16 inputs in interpret mode.

Inputs are made from a seed with numpy, rounded to bfloat16 and handed to
both. The JAX kernels round where their bfloat16 fast path rounds (q·scale
in bfloat16, K2's rel terms once, the normalised probabilities before P·V,
the output; float32 sums and softmax); the port's plain versions round at the
same places. Tolerance: every element within one bfloat16 ulp of JAX's and at
least 99% bit-equal. float32 sums taken in another order may round an
intermediate (a rel term, a probability) the other way; that moves a whole
row by about one ulp of its large elements, so the ulp of an element is taken
at no less than 2^-6 of max |JAX| (a row of the padded-window case lies 2
ulps off at an element of 0.0146 against a max of 3.05, where its rel terms
are the correctly rounded ones). K2's and K3's float32 path, rounded to
bfloat16 at the end, fails that check on the same inputs: the test tells
bfloat16 compute from float32 compute. K4's bfloat16 arithmetic is float32
rounded once at the end, so there it is the float32 output that fails.
"""

import ml_dtypes
import numpy as np
import pytest

import jax.numpy as jnp

from mia_tpu.ops.attention import fused_attention_rel_packed as jax_k3
from mia_tpu.ops.attention import fused_attention_rel_packed_ik as jax_k2
from mia_tpu.ops.ln_window import ln_window_partition as jax_k4

import torch

from mia_tpu_torch.ops import attention, ln_window

BF16 = ml_dtypes.bfloat16
MIN_EQUAL = 0.99  # share of elements bit-equal to JAX's
ULP_FLOOR = 2.0 ** -6  # an element's ulp is taken at no less than this share of max |JAX|


def _bf16(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32).astype(BF16)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)


def _agreement(got: torch.Tensor, want) -> tuple[float, float]:
    """(largest distance in bfloat16 ulps of ``want``, share bit-equal)."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    floor = max(float(np.abs(want).max()) * ULP_FLOOR, 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), floor))) - 7)
    diff = np.abs(got - want)
    return float((diff / ulp).max()), float((diff == 0).mean())


def _holds(got, want) -> bool:
    ulps, equal = _agreement(got, want)
    return ulps <= 1.0 and equal >= MIN_EQUAL


def _check(port, port_f32, want):
    """The bfloat16 port within tolerance of JAX, its float32 path not."""
    assert port.dtype == torch.bfloat16
    assert port.shape == tuple(want.shape)
    ulps, equal = _agreement(port, want)
    assert ulps <= 1.0 and equal >= MIN_EQUAL, (ulps, equal)
    assert not _holds(port_f32, want), _agreement(port_f32, want)


# (k_h, k_w, heads, head dim): a square grid, a 5x7 grid, a head dim whose
# scale 24**-0.5 is not a power of two (q·scale then rounds)
K3_CASES = [(6, 6, 2, 16), (5, 7, 2, 16), (4, 6, 2, 24)]


@pytest.mark.parametrize("k_h,k_w,heads,d", K3_CASES)
def test_k3_bfloat16_matches_jax(k_h, k_w, heads, d):
    rng = np.random.default_rng(k_h * 10 + d)
    b, n = 2, k_h * k_w
    qkv = _bf16(rng, b, n, 3 * heads * d)
    rel_h, rel_w = _bf16(rng, b * heads, n, k_h), _bf16(rng, b * heads, n, k_w)
    scale = d ** -0.5
    want = jax_k3(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w), scale, (k_h, k_w),
                  heads, None, True)
    assert want.dtype == jnp.bfloat16
    args = (_t(qkv), _t(rel_h), _t(rel_w))
    got = attention.fused_attention_rel_packed(*args, scale, (k_h, k_w), heads)
    f32 = attention.attention_rel_packed(*(a.float() for a in args), scale, (k_h, k_w), heads)
    _check(got, f32.to(torch.bfloat16), want)


def _padded_windows(rng, grid=(1, 20, 27), ws=7, heads=2, d=16):
    """qkv of the windows K4 makes from a grid that is no whole number of
    windows: the pad tokens are zero rows, so their q, k, v are the qkv
    Linear's bias (real keys, as in the reference)."""
    c = heads * d
    x = _t(_bf16(rng, *grid, c))
    windows = ln_window.ln_window_partition(x, torch.ones(c), torch.zeros(c), ws)
    w, bias = _t(_bf16(rng, c, 3 * c, scale=c ** -0.5)), _t(_bf16(rng, 3 * c, scale=0.5))
    qkv = windows.reshape(windows.shape[0], ws * ws, c) @ w + bias
    assert (qkv == bias).all(-1).any()  # pad tokens present
    return np.asarray(qkv.float().numpy(), np.float32).astype(BF16), (ws, ws), heads, d


def _window_case(rng, k_h, k_w, heads, d, windows=3):
    return _bf16(rng, windows, k_h * k_w, 3 * heads * d), (k_h, k_w), heads, d


@pytest.mark.parametrize("case", ["padded windows", "grid 5x7", "head dim 24"])
def test_k2_bfloat16_matches_jax(case):
    rng = np.random.default_rng(len(case))
    qkv, (k_h, k_w), heads, d = {
        "padded windows": lambda: _padded_windows(rng),
        "grid 5x7": lambda: _window_case(rng, 5, 7, 2, 16),
        "head dim 24": lambda: _window_case(rng, 6, 6, 2, 24),
    }[case]()
    q_h = qkv.shape[1] // k_w
    rh, rw = _bf16(rng, q_h * k_h, d, scale=0.3), _bf16(rng, k_w * k_w, d, scale=0.3)
    scale = d ** -0.5
    want = jax_k2(jnp.asarray(qkv), jnp.asarray(rh), jnp.asarray(rw), scale, (k_h, k_w), heads,
                  None, True)
    assert want.dtype == jnp.bfloat16
    args = (_t(qkv), _t(rh), _t(rw))
    got = attention.fused_attention_rel_packed_ik(*args, scale, (k_h, k_w), heads)
    f32 = attention.attention_rel_packed_ik(*(a.float() for a in args), scale, (k_h, k_w), heads)
    _check(got, f32.to(torch.bfloat16), want)


@pytest.mark.parametrize("shape,ws", [((2, 20, 27, 32), 7), ((1, 9, 14, 48), 14)])
def test_k4_bfloat16_matches_jax(shape, ws):
    rng = np.random.default_rng(shape[1])
    c = shape[-1]
    x = _bf16(rng, *shape, scale=2.0)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    want = jax_k4(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), ws, 1e-6, interpret=True)
    assert want.dtype == jnp.bfloat16
    sc, bi = torch.from_numpy(scale), torch.from_numpy(bias)
    got = ln_window.ln_window_partition_fused(_t(x), sc, bi, ws)
    f32 = ln_window.ln_window_partition(_t(x).float(), sc, bi, ws)
    _check(got, f32, want)
    assert not got[np.asarray(want, np.float32) == 0].any()  # pad slots exactly zero


@pytest.mark.parametrize("dtype,suffix", [(torch.float32, "f32"), (torch.bfloat16, "bf16")])
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wrapper_launches_the_entry_of_the_operands_dtype(monkeypatch, kernel, dtype, suffix):
    """K2's and K3's launcher picks the C entry by the operands' dtype: the
    output and K2's rel-term scratch take it, the log-sum-exp is float32;
    the bfloat16 launches are counted apart. K2 in bfloat16 passes no
    scratch (NULL) where the warpgroup rule takes the call, whose kernel
    forms the rel terms itself, and a bfloat16 one where it does not."""
    calls, rules = [], []
    monkeypatch.setattr(attention, "_geometry", lambda label, qkv, k_hw, heads, dt:
                        (qkv.shape[0], qkv.shape[1], qkv.shape[2] // (3 * heads)))
    monkeypatch.setattr(attention, "_call", lambda label, symbol, qkv, tensors, *a:
                        calls.append((symbol, [None if t is None else t.dtype for t in tensors])))
    monkeypatch.setattr(attention, "_wgmma_takes",
                        lambda symbol, *ints: rules.append((symbol, ints)) or True)
    qkv = torch.zeros(2, 16, 3 * 2 * 64, dtype=dtype)
    wrapper = (attention.fused_attention_rel_packed_ik if kernel == "K2"
               else attention.fused_attention_rel_packed)
    counts = wrapper.launches, wrapper.bf16_launches
    for name in ("launches", "bf16_launches"):  # restored after the test
        monkeypatch.setattr(wrapper, name, getattr(wrapper, name))
    if kernel == "K2":
        rel = (torch.zeros(16, 64, dtype=dtype), torch.zeros(16, 64, dtype=dtype))
        out, lse = attention._launch_k2(qkv, *rel, 0.125, (4, 4), 2, with_lse=True)
        symbol = f"mia_attention_rel_packed_ik_{suffix}"
    else:
        rel = (torch.zeros(4, 16, 4, dtype=dtype), torch.zeros(4, 16, 4, dtype=dtype))
        out, lse = attention._launch_k3(qkv, *rel, 0.125, (4, 4), 2, with_lse=True)
        symbol = f"mia_attention_rel_packed_{suffix}"
    assert calls[0][0] == symbol
    assert calls[0][1][:4] == [dtype] * 4 and calls[0][1][4] == torch.float32
    bf16 = dtype == torch.bfloat16
    assert calls[0][1][5:] == ([None if bf16 else dtype] if kernel == "K2" else [])
    assert rules == ([("mia_attention_rel_ik_fwd_wgmma_takes", (64, 16, 4, 4))]
                     if kernel == "K2" and bf16 else [])
    assert out.dtype == dtype and lse.dtype == torch.float32
    assert (wrapper.launches, wrapper.bf16_launches) == (counts[0] + (not bf16),
                                                         counts[1] + bf16)
    with pytest.raises(ValueError, match="bfloat16|float32"):  # operands of two dtypes
        (attention._launch_k2 if kernel == "K2" else attention._launch_k3)(
            qkv, rel[0].float() if bf16 else rel[0].bfloat16(), rel[1], 0.125, (4, 4), 2)
    if kernel == "K2" and bf16:  # a call the rule does not take: kernel R's scratch again
        monkeypatch.setattr(attention, "_wgmma_takes", lambda symbol, *ints: False)
        attention._launch_k2(qkv, *rel, 0.125, (4, 4), 2)
        assert calls[-1][1][5:] == [dtype]
