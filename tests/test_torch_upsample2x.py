"""K10/K10b's plain versions and the modules built on them against ``mia_tpu``.

Inputs come from seeded numpy. Tolerances (float32, another summation
order): forward max |port − JAX| ≤ 1e-5, ``dx``/``dw``/``db`` ≤ 1e-4 (absolute
and relative, as ``tests/test_ops_conv.py`` holds the Pallas kernel to its
einsum form). The Pallas kernel runs in interpret mode, as the JAX package's
own tests run it on the CPU.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import flax.linen as fnn

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

# (H, W, Cin, Cout) of tests/test_ops_conv.py's Pallas test, batch 2
SHAPES = [(8, 8, 32, 16), (4, 12, 16, 16), (8, 8, 64, 32)]


def _operands(shape, seed=3):
    h, w, cin, cout = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, h, w, cin)).astype(np.float32),
            (rng.standard_normal((2, 2, cin, cout)) * cin ** -0.5).astype(np.float32),
            rng.standard_normal((cout,)).astype(np.float32),
            rng.standard_normal((2, 2 * h, 2 * w, cout)).astype(np.float32))


def _torch_weight_from_flax_kernel(kernel):
    """flax ``(2, 2, Cin, Cout)`` (taps reversed) → torch ``(Cin, Cout, 2, 2)``."""
    return torch.from_numpy(np.ascontiguousarray(kernel[::-1, ::-1].transpose(2, 3, 0, 1)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_k10_matches_the_interpreted_pallas_kernel(shape):
    x, w, b, dy = _operands(shape)
    want = np.asarray(conv_transpose2x_p(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True))
    got = up.conv_transpose2x_plain(*map(torch.from_numpy, (x, w, b))).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    _, vjp = jax.vjp(lambda *a: conv_transpose2x_p(*a, True), *map(jnp.asarray, (x, w, b)))
    want_grads = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    got_grads = up.conv_transpose2x_bwd_plain(*map(torch.from_numpy, (x, w, dy)))
    assert got_grads[2].dtype == torch.float32
    for g, wnt in zip(got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), wnt, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", SHAPES)
def test_module_matches_jax_einsum_module_and_conv_transpose(shape):
    h, w, cin, cout = shape
    x, _, _, dy = _operands(shape, seed=4)
    jm = JaxEinsum(cout, dimension=2, use_pallas="never")
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    kernel = np.asarray(variables["params"]["kernel"])
    bias = np.random.default_rng(5).standard_normal(cout).astype(np.float32)
    variables = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    stock = fnn.ConvTranspose(cout, (2, 2), strides=(2, 2), padding="VALID")
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(stock.apply(variables, jnp.asarray(x))), want,
                               rtol=1e-5, atol=1e-5)

    def jax_loss(v, xx):
        return jnp.sum(jm.apply(v, xx) * jnp.asarray(dy))

    gv, gx = jax.grad(jax_loss, argnums=(0, 1))(variables, jnp.asarray(x))
    for use_kernel in ("never", "always"):  # on the CPU both take the plain version
        tm = EinsumConvTranspose2x(cin, cout, use_kernel=use_kernel)
        tm.load_state_dict({"weight": _torch_weight_from_flax_kernel(kernel),
                            "bias": torch.from_numpy(bias)})
        xt = torch.from_numpy(x).requires_grad_()
        got = tm(xt)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
        (got * torch.from_numpy(dy)).sum().backward()
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(tm.bias.grad.numpy(), np.asarray(gv["params"]["bias"]),
                                   rtol=1e-4, atol=1e-4)
        want_dw = _torch_weight_from_flax_kernel(np.asarray(gv["params"]["kernel"])).numpy()
        np.testing.assert_allclose(tm.weight.grad.numpy(), want_dw, rtol=1e-4, atol=1e-4)
    assert up.conv_transpose2x.launches == 0 and up.conv_transpose2x_fused_bwd.launches == 0


def test_module_3d_matches_jax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 3, 4, 5, 8)).astype(np.float32)
    jm = JaxEinsum(4, dimension=3)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    kernel = np.asarray(variables["params"]["kernel"])  # (2, 2, 2, Cin, Cout), taps reversed
    tm = EinsumConvTranspose2x(8, 4, dimension=3)
    tm.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(
            kernel[::-1, ::-1, ::-1].transpose(3, 4, 0, 1, 2))),
        "bias": torch.from_numpy(np.array(variables["params"]["bias"]))})
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.shape == (2, 6, 8, 10, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dimension"):
        EinsumConvTranspose2x(8, 4, dimension=1)
    with pytest.raises(ValueError, match="use_kernel"):
        EinsumConvTranspose2x(8, 4, use_kernel="auto")


def test_plain_vjp_matches_autograd_and_gradcheck():
    x, w, b, dy = (torch.from_numpy(a) for a in _operands((5, 7, 8, 4), seed=7))
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    want = torch.autograd.grad(up.conv_transpose2x_plain(*leaves), leaves, dy)
    got = up.conv_transpose2x_bwd_plain(x, w, dy)
    for g, wnt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), wnt.numpy(), rtol=1e-5, atol=1e-5)
    only_dx = up.conv_transpose2x_bwd_plain(x, w, dy, need_dw=False)
    assert only_dx[1] is None and only_dx[2] is None and torch.equal(only_dx[0], got[0])
    assert up.conv_transpose2x_bwd_plain(x, w, dy, need_dx=False)[0] is None
    # the wrapper's autograd.Function (the plain VJP on CPU tensors), in float64
    args = [t.double().requires_grad_() for t in (x[:1, :2, :3], w, b)]
    assert torch.autograd.gradcheck(up.conv_transpose2x, args)


def test_launchers_raise_on_cpu_tensors_and_odd_channels():
    x, w, b, dy = (torch.from_numpy(a) for a in _operands((4, 4, 8, 4)))
    with pytest.raises(ValueError, match="CUDA"):
        up._launch_k10(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        up._launch_k10_bwd(x, w, dy)


@pytest.fixture(scope="module")
def jax_unet():
    cfg = JaxUNetConfig(in_channels=1, out_classes=3, channels_list=(4, 8, 16), einsum_upsample=True)
    model = JaxUNet(cfg)
    x = np.random.default_rng(8).standard_normal((2, 16, 16, 1)).astype(np.float32)
    variables = jax.device_get(model.init(jax.random.PRNGKey(2), jnp.asarray(x), train=False))
    rng = np.random.default_rng(9)  # biases start at zero: give them signal
    for l in range(2):
        up_p = variables["params"]["decoder"][f"up{l}"]
        up_p["bias"] = rng.standard_normal(up_p["bias"].shape).astype(np.float32)
    return cfg, model, variables, x


@pytest.mark.parametrize("use_kernel", ["never", "always"])
def test_unet_with_einsum_upsample_matches_jax(jax_unet, use_kernel):
    cfg, model, variables, x = jax_unet
    want = np.asarray(model.apply(variables, jnp.asarray(x), train=False))
    tcfg = UNetConfig(in_channels=1, out_classes=3, channels_list=(4, 8, 16), einsum_upsample=True)
    tm = UNet(tcfg).eval()
    assert all(isinstance(m, EinsumConvTranspose2x) for m in tm.decoder.upsamples)
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    for m in tm.decoder.upsamples:
        m.use_kernel = use_kernel
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # the default decoder (nn.ConvTranspose2d) loads the same state dict and agrees
    stock = UNet(dataclasses.replace(tcfg, einsum_upsample=False)).eval()
    assert all(isinstance(m, torch.nn.ConvTranspose2d) for m in stock.decoder.upsamples)
    stock.load_state_dict(tm.state_dict())
    with torch.no_grad():
        np.testing.assert_allclose(stock(torch.from_numpy(x)).numpy(), got, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stages", [2, 4])
def test_sam_upscaler_matches_jax_and_loads_conv_transpose_state_dicts(stages):
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    jm = JaxUpscaler(transformer_dim=64, stages=stages)
    params = jax.device_get(jm.init(jax.random.PRNGKey(3), jnp.asarray(x))["params"])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    sd = sam_state_dict_from_flax({"params": {"mask_decoder": {"output_upscaling": params}}})
    sd = {k.removeprefix("mask_decoder.output_upscaling."): v for k, v in sd.items()}
    tm = _Upscaler(64, stages)
    tm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 4 * 2 ** stages, 4 * 2 ** stages, 64 // (8 if stages == 2 else 16))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    # a state dict of the earlier nn.ConvTranspose2d stages has the same keys and shapes
    widths = [64, 16, 8] if stages == 2 else [64, 16, 8, 4, 4]
    old = {}
    for i, key in enumerate(k for k in sd if k.endswith(".weight") and sd[k].dim() == 4):
        conv = torch.nn.ConvTranspose2d(widths[i], widths[i + 1], 2, stride=2)
        old[key], old[key.replace("weight", "bias")] = conv.weight.detach(), conv.bias.detach()
    assert {k: v.shape for k, v in old.items()} == {k: sd[k].shape for k in old}
    tm.load_state_dict({**sd, **old}, strict=True)
    for m in tm.modules():
        if isinstance(m, EinsumConvTranspose2x):
            m.use_kernel = "always"  # CPU tensors: still the plain version
    with torch.no_grad():
        assert tm(torch.from_numpy(x)).shape == got.shape
    assert up.conv_transpose2x.launches == 0
