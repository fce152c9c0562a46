"""K10/K10b in bfloat16: the plain versions and the modules built on them
against ``mia_tpu``'s Pallas kernel in bfloat16.

The Pallas kernel (``mia_tpu/ops/upsample2x.py``) takes bfloat16 ``x`` and
``w`` and a float32 bias, sums every product in float32, adds the float32
bias and rounds once; its backward rounds ``dx`` once, ``dw`` once to the
weight's dtype and leaves ``db`` float32. The port's plain bfloat16 versions
(``conv_transpose2x_plain_bf16``, ``conv_transpose2x_bwd_plain_bf16``)
round the same way. Measured against ``conv_transpose2x_p(...,
interpret=True)`` and ``jax.vjp`` of it: the forward and ``dw`` bit for bit
at every shape here, ``dx`` bit for bit but for one element of 2304 one ulp
apart at (3, 4, 6, 64 → 32), ``db`` (float32, another summation order)
within 1e-6 relative. The limit is one ulp with at least 99.9% bit-equal
(the ulp taken at no less than 2^-6 of max |JAX|). The composition the
module ran before (the bias rounded to bfloat16, then a bfloat16 product and
a bfloat16 bias add: two roundings) reads 68-73% bit-equal, up to 15.5 ulps,
and misses it.

The module ``EinsumConvTranspose2x(compute_dtype=torch.bfloat16)`` with
``use_kernel="always"`` is held against flax's ``EinsumConvTranspose2x(
dtype=bfloat16, use_pallas="always")`` (measured bit for bit, forward and
every gradient), and with ``"never"`` against ``use_pallas="never"`` (the
einsum: bit for bit but for the bias gradient, which XLA's CPU backward sums
in bfloat16; the port's equals the float64 sum rounded once). The biases are
drawn nonzero: flax initialises them to zero, and the double rounding does
not show without them.

The SAM upscalers (2 and 4 stages) and a UNet with ``einsum_upsample=True``
run in bfloat16 with every stage on ``use_kernel="always"``, against the JAX
modules with ``use_pallas="always"``: ``mia_tpu``'s modules build
``EinsumConvTranspose2x`` by name, so the test patches that name to a
partial with ``use_pallas="always"``. Forward and gradients are held to the
measured agreement, each shown under JAX's own bfloat16-vs-float32 gap on
the same inputs.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import mia_tpu.models.sam.mask_decoder as jax_mask_decoder
import mia_tpu.models.unet as jax_unet
from mia_tpu.models.sam.mask_decoder import _Upscaler as JaxUpscaler
from mia_tpu.models.unet import EinsumConvTranspose2x as JaxEinsum
from mia_tpu.models.unet import UNet as JaxUNet
from mia_tpu.models.unet import UNetConfig as JaxUNetConfig
from mia_tpu.ops.upsample2x import conv_transpose2x_p

import torch

from mia_tpu_torch.models import EinsumConvTranspose2x, UNet, UNetConfig, unet_state_dict_from_flax
from mia_tpu_torch.models.sam.mask_decoder import _Upscaler
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.ops import upsample2x as up

BF = torch.bfloat16
# (B, H, W, Cin, Cout): the upscalers' kind of stage at narrow widths, a
# prompt-large-like thin stage and a ragged one (H = 5: the Pallas kernel's
# row band is 1)
SHAPES = [(2, 8, 8, 32, 16), (3, 4, 6, 64, 32), (1, 16, 16, 16, 16), (2, 5, 12, 24, 8)]
MAX_ULPS, MIN_EQUAL = 1.0, 0.999


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _agreement(got, want) -> tuple[float, float]:
    """(largest |got - want| in bfloat16 ulps of ``want``, share bit-equal);
    the ulp is taken at no less than 2^-6 of max |want|."""
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    mag = np.abs(want)
    floor = max(float(mag.max()) * 2.0 ** -6, 2.0 ** -126)
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, floor))) - 7)
    diff = np.abs(got - want)
    return float((diff / ulp).max()), float((diff == 0).mean())


def _holds(got, want) -> bool:
    ulps, equal = _agreement(got, want)
    return ulps <= MAX_ULPS and equal >= MIN_EQUAL


def _operands(shape, seed):
    """bfloat16-exact float32 numpy x, w (taps in output order), bias, dy."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    rnd = lambda a: _f32(jnp.asarray(a, jnp.bfloat16))  # noqa: E731
    return (rnd(rng.standard_normal((b, h, w, cin))),
            rnd(rng.standard_normal((2, 2, cin, cout)) * cin ** -0.5),
            rnd(rng.standard_normal(cout)),
            rnd(rng.standard_normal((b, 2 * h, 2 * w, cout))))


def _torch_weight_from_flax_kernel(kernel):
    """flax ``(2, 2, Cin, Cout)`` (taps reversed) → torch ``(Cin, Cout, 2, 2)``."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_bf16_k10_and_vjp_match_the_interpreted_pallas_kernel(shape):
    x, w, b, dy = _operands(shape, seed=0)
    xj, wj, dyj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    want, vjp = jax.vjp(lambda *a: conv_transpose2x_p(*a, True), xj, wj, jnp.asarray(b))
    want_dx, want_dw, want_db = vjp(dyj)
    assert want.dtype == want_dx.dtype == want_dw.dtype == jnp.bfloat16
    assert want_db.dtype == jnp.float32

    xt, wt, dyt = (torch.from_numpy(a).to(BF) for a in (x, w, dy))
    bt = torch.from_numpy(b)
    got = up.conv_transpose2x_plain_bf16(xt, wt, bt)
    assert got.dtype == BF and _holds(got, want), _agreement(got, want)
    dx, dw, db = up.conv_transpose2x_bwd_plain_bf16(xt, wt, dyt)
    assert dx.dtype == dw.dtype == BF and db.dtype == torch.float32
    for name, g, wnt in (("dx", dx, want_dx), ("dw", dw, want_dw)):
        assert _holds(g, wnt), (name, _agreement(g, wnt))
    np.testing.assert_allclose(db.numpy(), np.asarray(want_db), rtol=1e-6,
                               atol=1e-6 * float(np.abs(want_db).max()))
    # the wrapper takes the same plain versions for bfloat16 CPU tensors
    assert torch.equal(up.conv_transpose2x(xt, wt, bt), got)
    for a, c in zip(up.conv_transpose2x_fused_bwd(xt, wt, dyt), (dx, dw, db)):
        assert torch.equal(a, c)
    # the float32 plain versions on the widened operands round nothing
    assert torch.equal(up.conv_transpose2x_plain(xt.float(), wt.float(), bt).to(BF), got)
    # the composition the module ran before: bfloat16 bias, two roundings
    old = up.conv_transpose2x_plain(xt, wt, bt.to(BF))
    assert not _holds(old, want), _agreement(old, want)


def test_plain_bf16_vjp_answers_only_what_is_asked():
    x, w, _, dy = (torch.from_numpy(a).to(BF) for a in _operands((2, 4, 4, 16, 8), seed=1))
    full = up.conv_transpose2x_bwd_plain_bf16(x, w, dy)
    only_dx = up.conv_transpose2x_bwd_plain_bf16(x, w, dy, need_dw=False)
    assert only_dx[1] is None and only_dx[2] is None and torch.equal(only_dx[0], full[0])
    only_dw = up.conv_transpose2x_bwd_plain_bf16(x, w, dy, need_dx=False)
    assert only_dw[0] is None and torch.equal(only_dw[1], full[1]) and torch.equal(only_dw[2], full[2])


def _module_pair(shape, use_kernel, seed):
    """Flax and port ``EinsumConvTranspose2x`` in bfloat16 on the same
    float32 weights (a nonzero bias), the inputs and a cotangent."""
    cin, cout = shape[3], shape[4]
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape[:4]).astype(np.float32)
    dy = rng.standard_normal((shape[0], 2 * shape[1], 2 * shape[2], cout)).astype(np.float32)
    kernel = (rng.standard_normal((2, 2, cin, cout)) * cin ** -0.5).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    jm = JaxEinsum(cout, dimension=2, dtype=jnp.bfloat16, use_pallas=use_kernel)
    variables = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    tm = EinsumConvTranspose2x(cin, cout, use_kernel=use_kernel, compute_dtype=BF)
    tm.load_state_dict({"weight": _torch_weight_from_flax_kernel(kernel),
                        "bias": torch.from_numpy(bias)})
    return jm, variables, tm, x, dy


@pytest.mark.parametrize("shape", SHAPES[:3])
@pytest.mark.parametrize("use_kernel", ["always", "never"])
def test_module_matches_the_jax_module_of_the_same_option(shape, use_kernel):
    jm, variables, tm, x, dy = _module_pair(shape, use_kernel, seed=4)
    y, vjp = jax.vjp(lambda v, xx: jm.apply(v, xx), variables, jnp.asarray(x, jnp.bfloat16))
    gv, gx = vjp(jnp.asarray(dy, jnp.bfloat16))
    assert y.dtype == gx.dtype == jnp.bfloat16

    xt = torch.from_numpy(x).to(BF).requires_grad_()
    got = tm(xt)
    got.backward(torch.from_numpy(dy).to(BF))
    assert got.dtype == xt.grad.dtype == BF
    assert tm.weight.grad.dtype == tm.bias.grad.dtype == torch.float32
    want_dw = _torch_weight_from_flax_kernel(_f32(gv["params"]["kernel"]))
    for name, g, wnt in (("y", got, y), ("dx", xt.grad, gx), ("dw", tm.weight.grad, want_dw)):
        assert _holds(g, wnt), (use_kernel, name, _agreement(g, wnt))
    db, want_db = tm.bias.grad, _f32(gv["params"]["bias"])
    # the bias gradient: the float64 sum of the bfloat16 cotangent, rounded once
    once = torch.from_numpy(_f32(jnp.asarray(dy, jnp.bfloat16)).astype(np.float64).sum((0, 1, 2)))
    assert _holds(db, once.to(BF)), _agreement(db, once.to(BF))
    if use_kernel == "always":
        assert _holds(db, want_db), _agreement(db, want_db)
    else:  # XLA's CPU backward sums the einsum's bias cotangent in bfloat16
        assert not _holds(want_db, once.to(BF)), _agreement(want_db, once.to(BF))
    assert up.conv_transpose2x.bf16_launches == up.conv_transpose2x_fused_bwd.bf16_launches == 0


def test_module_before_the_repair_misses_the_pallas_module():
    """The forward the module ran before (its bias rounded to bfloat16, the
    plain bfloat16 product and bias add) misses JAX's ``use_pallas="always"``
    module: the second rounding."""
    jm, variables, tm, x, _ = _module_pair(SHAPES[1], "always", seed=4)
    want = jm.apply(variables, jnp.asarray(x, jnp.bfloat16))
    xt = torch.from_numpy(x).to(BF)
    w = tm.weight.to(BF).permute(2, 3, 0, 1)
    old = up.conv_transpose2x_plain(xt, w, tm.bias.to(BF))
    ulps, equal = _agreement(old, want)
    assert ulps > 4 and equal < 0.8, (ulps, equal)
    assert _holds(tm(xt), want)


def test_launchers_raise_on_bf16_cpu_tensors_odd_channels_and_mixed_dtypes():
    x, w, b, dy = (torch.from_numpy(a) for a in _operands((1, 4, 4, 16, 8), seed=2))
    xb, wb, dyb = x.to(BF), w.to(BF), dy.to(BF)
    with pytest.raises(ValueError, match="CUDA"):
        up._launch_k10(xb, wb, b)
    with pytest.raises(ValueError, match="CUDA"):
        up._launch_k10_bwd(xb, wb, dyb)
    # 16 bytes of bfloat16: channel counts multiples of 8 (float32 takes multiples of 4)
    x12, w12 = torch.zeros(1, 4, 4, 12, dtype=BF), torch.zeros(2, 2, 12, 8, dtype=BF)
    with pytest.raises(ValueError, match="multiples of 8"):
        up._launch_k10(x12, w12, b)
    with pytest.raises(ValueError, match="multiples of 8"):
        up._launch_k10_bwd(xb, torch.zeros(2, 2, 16, 4, dtype=BF), dyb[..., :4].contiguous())
    with pytest.raises(ValueError, match="multiples of 4"):
        up._launch_k10(torch.zeros(1, 4, 4, 6), torch.zeros(2, 2, 6, 8), b)
    # one dtype for x, w and dy, and a float32 bias
    with pytest.raises(ValueError, match="w must be .*bfloat16"):
        up._launch_k10(xb, w, b)
    with pytest.raises(ValueError, match="b must be .*float32"):
        up._launch_k10(xb, wb, b.to(BF))
    with pytest.raises(ValueError, match="dy must be .*bfloat16"):
        up._launch_k10_bwd(xb, wb, dy)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        up._launch_k10(x.double(), w.double(), b)
    assert up.conv_transpose2x.bf16_launches == up.conv_transpose2x_fused_bwd.bf16_launches == 0
