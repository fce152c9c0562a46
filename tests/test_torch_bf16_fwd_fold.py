"""A float32/bfloat16 CPU model of the tile order of the bfloat16 K3 / K6
forwards (the warpgroup kernel of ``csrc/attention_fwd_wgmma.cuh`` and the
statistics pass of ``csrc/attention_fwd_tc.cuh``'s bfloat16 instance), held
against the port's plain bfloat16 K3 and K6 and against the Pallas K3
(``fused_attention_rel_packed``) and K6 (``fused_attention_rel``) run on
bfloat16 inputs in interpret mode.

The model does what the kernel does, tile by tile: it forms
``q_aug = [bf16(q * bf16(scale)) | rel_h | rel_w | 0]`` and the one-hot
``k_aug = [k | E_h | E_w | 0]`` (96 or 128 columns at head dim 64), then
  pass 1, over 64-key tiles: ``S = q_aug . k_aug^T`` as one float32 product,
    the online row maximum and sum ``(m, l)`` in float32;
  pass 2, over the same tiles: S again, ``p = bf16(exp(S - m) / l)`` (the
    normalised probabilities, rounded where the Pallas kernels round
    ``(p / denom).astype(v.dtype)``), ``O += p . V`` in float32;
then ``out = bf16(O)`` and ``lse = m + log l``.

The second model, :func:`running_max_fwd`, is the rounding the bfloat16
``mma.sync`` instance made before the statistics pass: ``bf16(exp(S - m))``
at the running maximum, ``O`` rescaled tile by tile and divided by the float32
sum at the end. It misses the measure against JAX on the same inputs; the
test that says so is the record of that fault.

The measure is ``test_torch_bf16_kernels.py``'s: the largest distance in
bfloat16 ulps of the reference (the ulp taken at no less than 2^-6 of its
max) and the share of elements bit-equal. Against JAX the limit is the plain
version's own distance plus one ulp, and at least 99% bit-equal. Against the
plain version (the same roundings, float32 sums in another order: a
probability on a rounding boundary may round the other way) the model reads
at most ``PLAIN_ULPS`` at 99% bit-equal or more.
"""

import functools

import numpy as np
import pytest

import jax.numpy as jnp

from mia_tpu.ops.attention import fused_attention_rel as jax_k6
from mia_tpu.ops.attention import fused_attention_rel_packed as jax_k3

import torch
from test_torch_bf16_bwd_fold import fold_operands
from test_torch_bf16_kernels import MIN_EQUAL, _agreement, _bf16, _t

from mia_tpu_torch.ops import attention

TILE = 64  # keys a streamed tile
PLAIN_ULPS = 1.0  # the model against the plain bfloat16 version (measured: 1 ulp on every case)
BF = torch.bfloat16


def _round(x: torch.Tensor) -> torch.Tensor:
    return x.to(BF).float()


def _tiles(n):
    return [(k0, min(k0 + TILE, n)) for k0 in range(0, n, TILE)]


def _packed(o, b, heads):
    """(B*H, n, D) float32 → the packed (B, n, H*D) context in bfloat16."""
    bh, n, d = o.shape
    return o.to(BF).reshape(b, heads, n, d).transpose(1, 2).reshape(b, n, heads * d)


def fold_fwd(qkv, rel_h, rel_w, scale, k_hw, heads, reciprocal=False):
    """The statistics pass, then P.V on the normalised P → (context in
    bfloat16 as K3's, lse (B*H, n) float32). ``reciprocal``: p = x * (1/l)
    in place of x / l."""
    b, n, _ = qkv.shape
    q_aug, k_aug, v, _ = fold_operands(qkv, rel_h, rel_w, scale, k_hw, heads)
    rows = q_aug.shape[:2]
    m = torch.full(rows, -torch.inf)
    l = torch.zeros(rows)
    for k0, k1 in _tiles(n):  # pass 1: S alone, the online (m, l)
        s = q_aug @ k_aug[:, k0:k1].transpose(1, 2)
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
        m = mn
    inv = 1.0 / l
    o = torch.zeros(*rows, v.shape[-1])
    for k0, k1 in _tiles(n):  # pass 2: S again, P = bf16(exp(S - m) / l), O += P.V
        e = torch.exp(q_aug @ k_aug[:, k0:k1].transpose(1, 2) - m[..., None])
        p = _round(e * inv[..., None] if reciprocal else e / l[..., None])
        o = o + p @ v[:, k0:k1]
    return _packed(o, b, heads), m + torch.log(l)


def running_max_fwd(qkv, rel_h, rel_w, scale, k_hw, heads):
    """The running-maximum rounding: bf16(exp(S - m)) at the running m, O
    rescaled tile by tile, divided by the float32 sum at the end."""
    b, n, _ = qkv.shape
    q_aug, k_aug, v, _ = fold_operands(qkv, rel_h, rel_w, scale, k_hw, heads)
    rows = q_aug.shape[:2]
    m = torch.full(rows, -torch.inf)
    l = torch.zeros(rows)
    o = torch.zeros(*rows, v.shape[-1])
    for k0, k1 in _tiles(n):
        s = q_aug @ k_aug[:, k0:k1].transpose(1, 2)
        mn = torch.maximum(m, s.amax(-1))
        c = torch.exp(m - mn)
        e = torch.exp(s - mn[..., None])
        l = l * c + e.sum(-1)
        o = o * c[..., None] + _round(e) @ v[:, k0:k1]
        m = mn
    return _packed(o / l[..., None], b, heads)


# (batch, heads, key grid) at head dim 64: a 32 x 32 global grid (128 fold
# columns), 14 x 14 windows (96), a ragged 20 x 27 grid (odd kw, 540 keys: a
# last tile of 28)
CASES = {"grid 32x32": (1, 2, (32, 32)), "windows 14x14": (3, 2, (14, 14)),
         "grid 20x27": (1, 2, (20, 27))}
D = 64


def _case(name, seed):
    b, heads, k_hw = CASES[name]
    rng = np.random.default_rng(seed)
    n = k_hw[0] * k_hw[1]
    qkv = _bf16(rng, b, n, 3 * heads * D)
    rel_h, rel_w = _bf16(rng, b * heads, n, k_hw[0]), _bf16(rng, b * heads, n, k_hw[1])
    return qkv, rel_h, rel_w, heads, k_hw


def _jax(kernel, qkv, rel_h, rel_w, heads, k_hw):
    """The Pallas K3, or K6 on the same operands head-major (heads 1), in
    interpret mode → the packed context as float32 numpy."""
    scale = D ** -0.5
    if kernel == "K3":
        out = jax_k3(jnp.asarray(qkv), jnp.asarray(rel_h), jnp.asarray(rel_w), scale, k_hw,
                     heads, None, True)
        return np.asarray(out, np.float32)
    b, n, _ = qkv.shape
    q, k, v = (jnp.asarray(t.reshape(b * heads, n, D)) for t in
               qkv.reshape(b, n, 3, heads, D).transpose(2, 0, 3, 1, 4))
    out = jax_k6(q, k, v, jnp.asarray(rel_h), jnp.asarray(rel_w), scale, k_hw, None, True)
    return np.asarray(out, np.float32).reshape(b, heads, n, D).transpose(0, 2, 1, 3).reshape(
        b, n, heads * D)


def _plain(kernel, qkv, rel_h, rel_w, heads, k_hw):
    """The port's plain bfloat16 K3, or K6 on the operands head-major →
    (packed context, lse)."""
    scale = D ** -0.5
    if kernel == "K3":
        return attention.attention_rel_packed_bf16(qkv, rel_h, rel_w, scale, k_hw, heads)
    b, n, _ = qkv.shape
    q, k, v = (t.reshape(b * heads, n, D) for t in
               qkv.reshape(b, n, 3, heads, D).permute(2, 0, 3, 1, 4))
    out, lse = attention.attention_rel_bf16(q, k, v, rel_h, rel_w, scale, k_hw)
    return out.reshape(b, heads, n, D).transpose(1, 2).reshape(b, n, heads * D), lse


@pytest.mark.parametrize("kernel", ["K3", "K6"])
@pytest.mark.parametrize("case", list(CASES))
def test_fold_forward_model_matches_the_plain_bf16_forward(kernel, case):
    qkv, rel_h, rel_w, heads, k_hw = _case(case, seed=sum(CASES[case][2]) + 1)
    args = (_t(qkv), _t(rel_h), _t(rel_w))
    out, lse = fold_fwd(*args, D ** -0.5, k_hw, heads)
    want, want_lse = _plain(kernel, *args, heads, k_hw)
    assert out.dtype == BF and out.shape == want.shape
    ulps, equal = _agreement(out, want.float().numpy())
    assert ulps <= PLAIN_ULPS and equal >= MIN_EQUAL, (ulps, equal)
    assert (lse - want_lse).abs().max().item() <= 1e-5


@functools.cache
def _against_jax(kernel, case):
    """The Pallas kernel's context on the case's inputs (seeded apart from the
    plain version's test), the inputs as torch tensors, and the plain
    version's own (ulps, share bit-equal) against the Pallas kernel."""
    qkv, rel_h, rel_w, heads, k_hw = _case(case, seed=sum(CASES[case][2]) + 7)
    want = _jax(kernel, qkv, rel_h, rel_w, heads, k_hw)
    args = (_t(qkv), _t(rel_h), _t(rel_w))
    plain = _agreement(_plain(kernel, *args, heads, k_hw)[0], want)
    return want, args, heads, k_hw, plain


@pytest.mark.parametrize("kernel", ["K3", "K6"])
@pytest.mark.parametrize("case", list(CASES))
def test_fold_forward_model_matches_jax_pallas_in_bfloat16(kernel, case):
    """The normalised-P model within the plain version's own distance to the
    Pallas kernel plus one ulp, at least 99% bit-equal."""
    want, args, heads, k_hw, (plain_ulps, plain_equal) = _against_jax(kernel, case)
    assert plain_ulps <= 1.0 and plain_equal >= MIN_EQUAL, (plain_ulps, plain_equal)
    ulps, equal = _agreement(fold_fwd(*args, D ** -0.5, k_hw, heads)[0], want)
    assert ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL, (ulps, equal, plain_ulps)


@pytest.mark.parametrize("kernel", ["K3", "K6"])
@pytest.mark.parametrize("case", list(CASES))
def test_running_max_rounding_misses_the_jax_measure(kernel, case):
    """The record of the fault the statistics pass repairs: rounding
    exp(S - m) at the running maximum lands 9-15 ulps from the Pallas kernel
    with about half the elements bit-equal, on the inputs the normalised-P
    model holds at."""
    want, args, heads, k_hw, (plain_ulps, _) = _against_jax(kernel, case)
    ulps, equal = _agreement(running_max_fwd(*args, D ** -0.5, k_hw, heads), want)
    assert not (ulps <= plain_ulps + 1.0 and equal >= MIN_EQUAL), (ulps, equal)
    assert ulps > 4.0 and equal < 0.6, (ulps, equal)


def test_the_kernels_divide_by_the_sum_as_the_pallas_kernels_do():
    """Why the kernels take p = exp(S - m) / l, as the Pallas kernels, and not
    exp(S - m) * (1/l) (one multiply a probability for one reciprocal a row):
    the reciprocal does not keep the division's bit-equal share. On the
    32 x 32 grid it reads 0.99932 of the elements bit-equal to the plain
    version against the division's 0.99946 (against JAX 0.99929 / 0.99906;
    both 1 ulp at most, and equal on the other cases)."""
    want, args, heads, k_hw, _ = _against_jax("K3", "grid 32x32")
    plain = _plain("K3", *args, heads, k_hw)[0].float().numpy()
    div = _agreement(fold_fwd(*args, D ** -0.5, k_hw, heads)[0], plain)
    recip = _agreement(fold_fwd(*args, D ** -0.5, k_hw, heads, reciprocal=True)[0], plain)
    assert div[0] <= PLAIN_ULPS and recip[0] <= PLAIN_ULPS, (div, recip)
    assert recip[1] < div[1] - 1e-4, (div, recip)
