"""The SAM upscalers and the UNet decoder in bfloat16 with every k2/s2 stage
on K10/K10b (``use_kernel="always"``) against ``mia_tpu``'s modules with
``use_pallas="always"``.

``mia_tpu``'s upscaler and UNet build ``EinsumConvTranspose2x`` by name, so
the test patches that name, in ``mia_tpu.models.sam.mask_decoder`` and
``mia_tpu.models.unet``, to a partial with ``use_pallas="always"``; nothing
under ``mia_tpu/`` changes. The bfloat16 references then run every stage
through ``conv_transpose2x_p`` (counted), compiled op by op
(``jax_bf16.py``); the float32 references run the einsum. Weights are seeded
numpy in the shapes ``jax.eval_shape`` gives (a flax init through the
interpreted Pallas kernel takes seconds a stage), every bias nonzero: flax
initialises them to zero, and the double rounding the port repaired does not
show without them.

Measured: the 2- and 4-stage upscalers bit for bit against JAX in output,
and within 0.011 of JAX's own bfloat16-vs-float32 gap in the input
cotangent and every stage's kernel and bias gradient; held at 0.05 of it.
With the stages on the plain einsum form (``"never"``) the upscalers miss
that hold. The UNet's logits and input cotangent lie 0.64 / 0.72 of JAX's
gap from JAX's bfloat16 ones, as with its stages on the einsum against
JAX's einsum (0.59 / 0.49): the rest of the UNet rounds as
``tests/test_torch_bf16_unet.py`` states, and ReLU carries the flips. So
each decoder stage is also held alone, on the input JAX's bfloat16 UNet
gives it: forward and VJP within one ulp and at least 99.9% bit-equal.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from flax import linen as nn

import mia_tpu.models.sam.mask_decoder as jax_mask_decoder
import mia_tpu.models.unet as jax_unet
import mia_tpu.ops.upsample2x as jax_upsample2x
from mia_tpu.models.sam.mask_decoder import _Upscaler as JaxUpscaler
from mia_tpu.models.unet import EinsumConvTranspose2x as JaxEinsum
from mia_tpu.models.unet import UNet as JaxUNet
from mia_tpu.models.unet import UNetConfig as JaxUNetConfig

import torch
from jax_bf16 import jit_op_by_op

from mia_tpu_torch.models import EinsumConvTranspose2x, UNet, UNetConfig, unet_state_dict_from_flax
from mia_tpu_torch.models.sam.mask_decoder import _Upscaler
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax
from mia_tpu_torch.ops import upsample2x as up

BF = torch.bfloat16
# ‖port − JAX bfloat16‖ / ‖JAX bfloat16 − JAX float32‖ at most. The upscalers: measured 0 for
# the output, 0-0.011 for the input cotangent and the stages' gradients (a hidden cotangent
# of the 4-stage chain that rounds the other way). The UNet's logits and input cotangent:
# measured 0.64 / 0.72, where the port's plain stages against JAX's einsum read 0.59 / 0.49:
# the UNet's other layers round as tests/test_torch_bf16_unet.py states, and ReLU carries
# those flips; its stages are held alone, on the inputs JAX's UNet gives them
UPSCALER_SHARE = 0.05
UNET_SHARES = {"y": 0.8, "dx": 0.9}
UNET_CHANNELS = (8, 16, 32)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rel(a, b, ref) -> float:
    a, b, ref = (_f32(t).astype(np.float64) for t in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


def _torch_weight_from_flax_kernel(kernel):
    """flax ``(2, 2, Cin, Cout)`` (taps reversed) → torch ``(Cin, Cout, 2, 2)``."""
    return torch.from_numpy(np.ascontiguousarray(_f32(kernel)[::-1, ::-1].transpose(2, 3, 0, 1)))


def _seeded(shapes, rng):
    """Seeded numpy leaves in the shapes of ``shapes`` (from ``jax.eval_shape``):
    kernels N(0, 1/fan-in), biases N(0, 0.5²), norm scales 1 + N(0, 0.1²),
    running means N(0, 0.1²) and variances U(0.5, 1.5)."""
    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        if name == "bias":
            return (0.5 * rng.standard_normal(s.shape)).astype(np.float32)
        if name in ("scale", "weight"):
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture
def pallas_always(monkeypatch):
    """Inside the returned context ``mia_tpu``'s modules build their
    ``EinsumConvTranspose2x`` with ``use_pallas="always"``; the list counts
    the Pallas kernel's calls."""
    calls = []
    kernel = jax_upsample2x.conv_transpose2x_p

    def counted(*args, **kwargs):
        calls.append(args[0].dtype)
        return kernel(*args, **kwargs)

    def patch():
        always = functools.partial(JaxEinsum, use_pallas="always")
        monkeypatch.setattr(jax_upsample2x, "conv_transpose2x_p", counted)
        monkeypatch.setattr(jax_mask_decoder, "EinsumConvTranspose2x", always)
        monkeypatch.setattr(jax_unet, "EinsumConvTranspose2x", always)

    return patch, calls


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


def _set_kernel(module, use_kernel):
    stages = [m for m in module.modules() if isinstance(m, EinsumConvTranspose2x)]
    for m in stages:
        m.use_kernel = use_kernel
    return stages


def _jax_vjp(apply, params, x, g):
    """(output, input cotangent, parameter gradients) of ``apply(params, x)``
    for the cotangent ``g``, compiled op by op."""
    def run(p, xx, gg):
        y, vjp = jax.vjp(apply, p, xx)
        gp, gx = vjp(gg.astype(y.dtype))
        return y, gx, gp

    return jit_op_by_op(run)(params, x, g)


@pytest.mark.parametrize("stages", [2, 4])
def test_bf16_upscaler_on_k10_matches_the_jax_pallas_upscaler(pallas_always, stages):
    patch, calls = pallas_always
    rng = np.random.default_rng(10 + stages)
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    side = 4 * 2 ** stages
    g = rng.standard_normal((2, side, side, 64 // (8 if stages == 2 else 16))).astype(np.float32)
    shapes = jax.eval_shape(JaxUpscaler(transformer_dim=64, stages=stages).init,
                            jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = _seeded(shapes, rng)

    def jax_run(dtype):
        jm = JaxUpscaler(transformer_dim=64, stages=stages, dtype=dtype)
        return _jax_vjp(lambda p, xx: jm.apply({"params": p}, xx), params,
                        jnp.asarray(x, dtype), jnp.asarray(g))

    y32, gx32, gp32 = jax_run(jnp.float32)
    patch()
    y16, gx16, gp16 = jax_run(jnp.bfloat16)
    assert calls == [jnp.bfloat16] * stages and y16.dtype == jnp.bfloat16

    sd = sam_state_dict_from_flax({"params": {"mask_decoder": {"output_upscaling": params}}})
    sd = {k.removeprefix("mask_decoder.output_upscaling."): v for k, v in sd.items()}
    tm = _Upscaler(64, stages, compute_dtype=BF)
    tm.load_state_dict(sd, strict=True)
    tconvs = _set_kernel(tm, "always")
    assert len(tconvs) == stages
    xt = torch.from_numpy(x).to(BF).requires_grad_()
    got = tm(xt)
    got.backward(torch.from_numpy(g).to(BF))
    assert got.dtype == xt.grad.dtype == BF
    holds = {"y": (got, y16, y32), "dx": (xt.grad, gx16, gx32)}
    for i, tconv in enumerate(tconvs):
        p16, p32 = gp16[f"up{i}"], gp32[f"up{i}"]
        holds[f"up{i} kernel"] = (tconv.weight.grad, _torch_weight_from_flax_kernel(p16["kernel"]),
                                  _torch_weight_from_flax_kernel(p32["kernel"]))
        holds[f"up{i} bias"] = (tconv.bias.grad, p16["bias"], p32["bias"])
    for name, (got_g, w16, w32) in holds.items():
        err, gap = _rel(got_g, w16, w32), _rel(w16, w32, w32)
        assert gap > 0 and err <= UPSCALER_SHARE * gap, (name, err, gap)
    assert up.conv_transpose2x.bf16_launches == up.conv_transpose2x_fused_bwd.bf16_launches == 0
    # the stages' einsum form rounds twice a stage and misses the Pallas upscaler
    _set_kernel(tm, "never")
    with torch.no_grad():
        plain = tm(torch.from_numpy(x).to(BF))
    assert _rel(plain, y16, y32) > UPSCALER_SHARE * _rel(y16, y32, y32)


def test_bf16_unet_decoder_on_k10_matches_the_jax_pallas_decoder(pallas_always):
    patch, calls = pallas_always
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    g = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    cfg = dict(in_channels=1, out_classes=3, channels_list=UNET_CHANNELS, einsum_upsample=True,
               dropout_prob=0.0)
    shapes = jax.eval_shape(functools.partial(JaxUNet(JaxUNetConfig(**cfg)).init, train=False),
                            jax.random.PRNGKey(0), jnp.asarray(x))
    variables = _seeded(shapes, rng)

    def jax_run(dtype):
        """The UNet's logits and input cotangent, and the input each
        upsampling stage gets (a second forward pass, recorded)."""
        jm = JaxUNet(JaxUNetConfig(**cfg, compute_dtype=dtype))
        apply = lambda p, xx: jm.apply({**variables, "params": p}, xx, train=False)  # noqa: E731

        def run(p, xx, gg):
            y, vjp = jax.vjp(apply, p, xx)
            _, gx = vjp(gg.astype(y.dtype))
            stage_inputs = {}

            def record(next_fun, args, kwargs, context):
                if isinstance(context.module, JaxEinsum) and context.method_name == "__call__":
                    stage_inputs[context.module.name] = args[0]
                return next_fun(*args, **kwargs)

            with nn.intercept_methods(record):
                apply(p, xx)
            return y, gx, stage_inputs

        return jit_op_by_op(run)(variables["params"], jnp.asarray(x), jnp.asarray(g))

    y32, gx32, _ = jax_run(jnp.float32)
    patch()
    y16, gx16, stage_inputs = jax_run(jnp.bfloat16)
    levels = len(UNET_CHANNELS) - 1
    assert calls == [jnp.bfloat16] * 2 * levels and y16.dtype == jnp.bfloat16

    tm = UNet(UNetConfig(**cfg, compute_dtype=BF)).eval()
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    assert _set_kernel(tm, "always") == list(tm.decoder.upsamples)
    xt = torch.from_numpy(x).requires_grad_()
    got = tm(xt)
    got.backward(torch.from_numpy(g).to(got.dtype))
    assert got.dtype == BF and xt.grad.dtype == torch.float32
    for name, got_v, w16, w32 in (("y", got, y16, y32), ("dx", xt.grad, gx16, gx32)):
        err, gap = _rel(got_v, w16, w32), _rel(w16, w32, w32)
        assert gap > 0 and err <= UNET_SHARES[name] * gap, (name, err, gap)

    # each decoder stage on the input JAX's bfloat16 UNet gives it: the Pallas module's
    # forward and VJP for a seeded cotangent, one ulp at most and 99.9% bit-equal
    assert set(stage_inputs) == {f"up{level}" for level in range(levels)}
    for level, stage in enumerate(tm.decoder.upsamples):
        params = variables["params"]["decoder"][f"up{level}"]
        xs = stage_inputs[f"up{level}"]
        assert xs.dtype == jnp.bfloat16
        jm = JaxEinsum(stage.out_channels, dtype=jnp.bfloat16, use_pallas="always")
        cot = rng.standard_normal((*xs.shape[:1], 2 * xs.shape[1], 2 * xs.shape[2],
                                   stage.out_channels)).astype(np.float32)
        want, gxs, gp = _jax_vjp(lambda p, xx: jm.apply({"params": p}, xx), params, xs,
                                 jnp.asarray(cot))
        stage.zero_grad()
        xst = torch.from_numpy(_f32(xs)).to(BF).requires_grad_()
        out = stage(xst)
        out.backward(torch.from_numpy(cot).to(BF))
        for name, a, b in (("y", out, want), ("dx", xst.grad, gxs),
                           ("dw", stage.weight.grad, _torch_weight_from_flax_kernel(gp["kernel"])),
                           ("db", stage.bias.grad, gp["bias"])):
            ulps, equal = _agreement(a, b)
            assert ulps <= 1.0 and equal >= 0.999, (level, name, ulps, equal)
    assert up.conv_transpose2x.bf16_launches == up.conv_transpose2x_fused_bwd.bf16_launches == 0
