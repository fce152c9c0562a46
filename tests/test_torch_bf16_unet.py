"""The port's UNet with ``compute_dtype=torch.bfloat16`` against the flax UNet
with ``compute_dtype=jnp.bfloat16``, from the same float32 weights; and
``al_train_torch --compute-dtype bfloat16`` end to end on the CPU.

Both round in bfloat16 at the same layers (convolutions, dropout,
activations, concatenation and residual sums in bfloat16; norms in float32),
but not at every operation in the same order: XLA may keep a convolution's
float32 sum through its bias add, PyTorch adds the bias inside the
convolution. So the two agree at the scale of bfloat16 noise, not bit for
bit. The measure is the relative Frobenius norm ``‖a − b‖ / ‖JAX float32‖``
(the max of one element swings with a single rounding). Each case states its
tolerance, asserts that it lies below JAX's own bfloat16-vs-float32 gap on
the same inputs, and that the port's float32 model misses it. Each kind of
layer is held alone, forward and backward, to one bfloat16 ulp
(``test_bfloat16_layer_vjp_matches_jax``); the whole model's gradient is
held only near JAX's own gap (``GRAD_TOL``), because JAX's CPU backward
rounds twice where the port rounds once (that test says where), and the
backward through train-mode batch norm carries those flips through every
layer.

The 2D residual block's CPU workaround (a strided 1x1 skip convolution run
at stride 1 on every second pixel, ``models/unet.py``) runs here in
bfloat16: the same bfloat16 weights and the same sums.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import flax.linen as fnn
from flax import serialization

from mia_tpu.losses import DiceAndCELoss as JaxLoss
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.models import unet as jax_unet
from mia_tpu.schedule import poly_warmup_schedule as jax_schedule
from mia_tpu.training.state import create_train_state, make_optimizer as jax_optimizer
from mia_tpu.transforms.normalization import zscore_normalize as jax_zscore

import torch
from jax_bf16 import jit_op_by_op

from mia_tpu_torch.losses import DiceAndCELoss
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_from_flax, unet_state_dict_to_flax
from mia_tpu_torch.models.flax_bridge import _conv_kernel, _tconv_kernel
from mia_tpu_torch.schedule import poly_warmup_schedule
from mia_tpu_torch.training import TrainState, make_optimizer, make_train_step
from mia_tpu_torch.transforms import zscore_normalize

CHANNELS = (8, 16, 32)
VARIANTS = {
    "plain": dict(),
    "res+instance+ds": dict(block_type="res", normalization="instance", deep_supervision=True,
                            ds_layer=2),
}
# relative Frobenius tolerance of the port's bfloat16 logits against JAX's, by case
FORWARD_TOL = {("plain", "eval"): 5e-3, ("plain", "train"): 9e-3,
               ("res+instance+ds", "eval"): 6e-3, ("res+instance+ds", "train"): 6e-3}


def _rel(a, b, ref) -> float:
    a, b, ref = (np.asarray(t, np.float32) for t in (a, b, ref))
    return float(np.linalg.norm(a - b) / np.linalg.norm(ref))


@functools.lru_cache(maxsize=None)
def _flax(variant):
    cfg = JaxUNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS, dropout_prob=0.0,
                        **VARIANTS[variant])
    jm = JaxUNet(cfg)
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = jax.tree.map(np.asarray, init(jax.random.key(0), jnp.zeros((1, 16, 16, 3))))
    rng = np.random.default_rng(0)
    for scope in ("encoder", "decoder"):  # eval-mode batch norm on non-trivial statistics
        for stats in variables.get("batch_stats", {}).get(scope, {}).values():
            n = stats["norm"]["mean"].shape
            stats["norm"]["mean"] = rng.normal(0, 0.1, n).astype(np.float32)
            stats["norm"]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return cfg, variables


def _port(variant, compute_dtype, variables):
    tm = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS, dropout_prob=0.0,
                         compute_dtype=compute_dtype, **VARIANTS[variant]))
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    return tm


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bfloat16_forward_matches_jax(variant, mode):
    cfg, variables = _flax(variant)
    x = np.random.default_rng(1).normal(size=(2, 32, 48, 3)).astype(np.float32)
    train = mode == "train"

    def jax_logits(dtype):
        jm = JaxUNet(dataclasses.replace(cfg, compute_dtype=dtype))
        if train and "batch_stats" in variables:
            return jit_op_by_op(lambda v, x: jm.apply(v, x, train=True,
                                                      mutable=["batch_stats"])[0])(
                variables, jnp.asarray(x))
        return jit_op_by_op(lambda v, x: jm.apply(v, x, train=train))(variables, jnp.asarray(x))

    want32, want16 = jax_logits(jnp.float32), jax_logits(jnp.bfloat16)
    assert want16.dtype == jnp.bfloat16
    tol, gap = FORWARD_TOL[(variant, mode)], _rel(want16, want32, want32)
    assert tol < gap, (tol, gap)

    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        tm = _port(variant, dtype, variables).train(train)
        with torch.no_grad():
            got[dtype] = tm(torch.from_numpy(x))
    assert got[torch.bfloat16].dtype == torch.bfloat16
    err = _rel(got[torch.bfloat16].float(), want16, want32)
    assert err <= tol, (err, tol, gap)
    assert _rel(got[torch.float32], want16, want32) > tol


def test_bfloat16_features_and_deep_supervision_heads():
    """``enc_feature``, ``pixel_feature`` and the deep-supervision heads come
    out in bfloat16, as the JAX model's, within the forward's tolerance."""
    cfg, variables = _flax("res+instance+ds")
    jb = JaxUNet(dataclasses.replace(cfg, compute_dtype=jnp.bfloat16))
    j32 = JaxUNet(cfg)
    x = np.random.default_rng(2).normal(size=(2, 32, 32, 3)).astype(np.float32)
    tm = _port("res+instance+ds", torch.bfloat16, variables).eval()
    with torch.no_grad():
        ds = tm(torch.from_numpy(x), return_ds=True)
        enc = tm.enc_feature(torch.from_numpy(x))
        _, feat = tm.pixel_feature(torch.from_numpy(x))
    want_ds, want_ds32 = (jit_op_by_op(lambda v, x, m=m: m.apply(v, x, train=False,
                                                                 return_ds=True))(
        variables, jnp.asarray(x)) for m in (jb, j32))
    assert len(ds) == len(want_ds) == 2
    for got, want, want32 in zip(ds, want_ds, want_ds32):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        assert _rel(got.float(), want, want32) <= FORWARD_TOL[("res+instance+ds", "eval")]
    want_enc, (_, want_feat) = jit_op_by_op(lambda v, x: (
        jb.apply(v, x, method=jb.enc_feature), jb.apply(v, x, method=jb.pixel_feature)))(
        variables, jnp.asarray(x))
    assert enc.dtype == torch.bfloat16 and want_enc.dtype == jnp.bfloat16
    assert feat.dtype == torch.bfloat16 and want_feat.dtype == jnp.bfloat16
    assert _rel(enc.float(), want_enc, want_enc) <= 1e-2
    assert _rel(feat.float(), want_feat, want_feat) <= 1e-2


ULP_FLOOR = 2.0 ** -6  # an element's ulp is taken at no less than this share of max |want|
MIN_EQUAL = 0.99  # share of a layer's bfloat16 outputs and gradients bit-equal to the reference


def _agreement(got, want) -> tuple[float, float]:
    """(largest distance in bfloat16 ulps of ``want``, share bit-equal)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    diff = np.abs(got - want)
    floor = max(float(np.abs(want).max()) * ULP_FLOOR, 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), floor))) - 7)
    return float((diff / ulp).max()), float((diff == 0).mean())


def _holds(got, want) -> bool:
    ulps, equal = _agreement(got, want)
    return ulps <= 1.0 and equal >= MIN_EQUAL


# (variant, flax path, port module, flax layer built as the JAX UNet builds it, cin, side)
LAYERS = {
    "conv": ("plain", "decoder/level0_block1/conv", "decoder.levels.0.1.all.0",
             lambda cfg: jax_unet._conv(cfg, 16, 3, 1), 16, 8),
    "conv stride 2": ("plain", "encoder/level1_block0/conv", "encoder.levels.1.0.all.0",
                      lambda cfg: jax_unet._conv(cfg, 16, 3, 2), 8, 16),
    "conv transpose": ("plain", "decoder/up0", "decoder.upsamples.0",
                       lambda cfg: fnn.ConvTranspose(16, (2, 2), (2, 2), padding="VALID",
                                                     dtype=cfg.compute_dtype), 32, 4),
    "batch norm, train": ("plain", "decoder/level0_block1/norm", "decoder.levels.0.1.all.2",
                          lambda cfg: jax_unet._norm(cfg, 16, True), 16, 8),
    "instance norm": ("res+instance+ds", "decoder/level0_block1/norm", "decoder.levels.0.1.all.1",
                      lambda cfg: jax_unet._norm(cfg, 16, True), 16, 8),
}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_bfloat16_layer_vjp_matches_jax(layer):
    """Each kind of UNet layer alone, forward and backward, in bfloat16
    against the flax layer built as the JAX UNet builds it (eager, so op by
    op), on the same float32 weights, a bfloat16 input and a bfloat16
    cotangent: output, input gradient and kernel gradient within one
    bfloat16 ulp and 99% bit-equal, norm parameter gradients (float32 sums)
    to 1e-5 of their max. Two of JAX's gradients round more than once on
    the CPU, and there the port is held to the float64 gradient rounded
    once to bfloat16 instead, which JAX then misses: a convolution's bias
    gradient, a sum of the bfloat16 cotangent that XLA accumulates in
    bfloat16, and the batch norm's input gradient, which JAX forms as two
    bfloat16 cotangents (one through the statistics, one through the
    normalisation, each cast from float32) and adds in bfloat16. These two
    are where the port's whole-model gradient parts from JAX's (GRAD_TOL).
    The port's float32 convolutions miss the bfloat16 output and input
    gradient; the norms compute in float32 in both, bar the output's
    dtype."""
    variant, path, name, build, cin, side = LAYERS[layer]
    cfg, variables = _flax(variant)
    flax_layer = build(dataclasses.replace(cfg, compute_dtype=jnp.bfloat16))
    params = functools.reduce(lambda t, k: t[k], path.split("/"), variables["params"])
    stats = functools.reduce(lambda t, k: t.get(k, {}), path.split("/"),
                             variables.get("batch_stats", {}))
    rng = np.random.default_rng(5)
    # non-zero biases (and norm scales): where a bias is added is part of the rounding
    params = {**params, "bias": 0.5 * rng.standard_normal(params["bias"].shape).astype(np.float32)}
    if "scale" in params:
        params["scale"] = (1 + 0.2 * rng.standard_normal(params["scale"].shape)).astype(np.float32)
    x = jnp.asarray(rng.standard_normal((2, side, side, cin)), jnp.bfloat16)

    def apply(p, x):
        if stats:
            return flax_layer.apply({"params": p, "batch_stats": stats}, x,
                                    mutable=["batch_stats"])[0]
        return flax_layer.apply({"params": p}, x)

    want, vjp = jax.vjp(apply, params, x)
    g = jnp.asarray(rng.standard_normal(want.shape), jnp.bfloat16)
    want_dp, want_dx = vjp(g)
    assert want.dtype == want_dx.dtype == jnp.bfloat16

    def nchw(a, dtype):
        return torch.from_numpy(np.array(a, np.float32)).permute(0, 3, 1, 2).to(dtype)

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    got = {}
    for dtype in (torch.bfloat16, torch.float32):
        module = dict(_port(variant, dtype, variables).train(True).named_modules())[name]
        with torch.no_grad():
            module.bias.copy_(torch.from_numpy(params["bias"]))
            if "scale" in params:
                module.weight.copy_(torch.from_numpy(params["scale"]))
        xt = nchw(x, dtype).requires_grad_()
        y = module(xt)
        y.backward(nchw(g, y.dtype))
        got[dtype] = y, xt.grad, module
    y, dx, module = got[torch.bfloat16]
    assert y.dtype == dx.dtype == torch.bfloat16
    assert _holds(nhwc(y), want)
    if layer == "batch norm, train":  # the float64 input gradient, rounded once
        x64 = torch.from_numpy(np.array(x, np.float64)).requires_grad_()
        mean = x64.mean((0, 1, 2))
        var = (x64 - mean).square().mean((0, 1, 2))
        y64 = ((x64 - mean) / torch.sqrt(var + 1e-5) * torch.from_numpy(np.array(params["scale"]))
               + torch.from_numpy(np.array(params["bias"])))
        y64.backward(torch.from_numpy(np.array(g, np.float64)))
        exact = x64.grad.to(torch.bfloat16).float().numpy()
        assert _holds(nhwc(dx), exact) and not _holds(want_dx, exact)
    else:
        assert _holds(nhwc(dx), want_dx)
    if "norm" in layer:
        for p, key in ((module.weight, "scale"), (module.bias, "bias")):
            ref = np.asarray(want_dp[key])
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    else:
        to_flax = _tconv_kernel if layer == "conv transpose" else _conv_kernel
        assert _holds(to_flax(module.weight.grad), want_dp["kernel"])
        exact = torch.from_numpy(np.array(g, np.float64)).sum((0, 1, 2)).to(torch.bfloat16)
        assert _holds(module.bias.grad, exact.float()) and not _holds(want_dp["bias"], exact.float())
    if "norm" not in layer:  # a norm computes in float32 in both: only its output dtype differs
        y32, dx32, _ = got[torch.float32]
        assert not _holds(nhwc(y32.to(torch.bfloat16)), want)
        assert not _holds(nhwc(dx32.to(torch.bfloat16)), want_dx)


GRAD_TOL = 0.15  # relative Frobenius distance of the parameter gradients
LOSS_TOL = 1e-5  # relative


def _jax_preprocess(images, labels):
    images = jax.vmap(jax_zscore)(images.astype(jnp.float32) / 255.0)
    return images, labels.astype(jnp.int32)


def _torch_preprocess(generator, images, labels):
    return zscore_normalize(images.to(torch.float32) / 255.0), labels.long()


def test_bfloat16_adam_step_matches_jax():
    """One train step in bfloat16 (Dice + CE, global-norm clip, Adam with L2
    decay): the loss and the parameter gradients against ``jax.grad`` of the
    flax model in bfloat16 (train-mode batch norm), and the float32
    parameters after the step against optax's Adam applied in float32 to the
    port's own gradients. The Adam update of a first step is about
    ``lr·sign(g)``, so held against JAX's it would only count the signs that
    bfloat16 noise flips; the gradient is where the two computations meet."""
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 3, (2, 32, 32), dtype=np.uint8)
    lr_kw = dict(initial_lr=1e-3, max_steps=10, warmup_steps=0)
    cfg, variables = _flax("plain")
    x, y = _jax_preprocess(jnp.asarray(images), jnp.asarray(labels))

    def jax_grad(dtype):
        jm = JaxUNet(dataclasses.replace(cfg, compute_dtype=dtype))

        def loss_fn(params):
            out, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                              train=True, mutable=["batch_stats"])
            return JaxLoss(ce_weight=1.0)(out, y)[0]

        # the backend's default here: op by op, XLA sums the Dice loss's
        # bfloat16 softmax denominators in bfloat16, where the port (and
        # XLA's default fusion) sum in float32
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
        return float(loss), grads

    (loss32, grads32), (loss16, grads16) = jax_grad(jnp.float32), jax_grad(jnp.bfloat16)

    def port_step(dtype):
        tm = _port("plain", dtype, variables)
        opt = make_optimizer("adam", tm.parameters(), poly_warmup_schedule(**lr_kw),
                             grad_clip=10.0, weight_decay=5e-4)
        seen = []
        step = opt.step
        opt.step = lambda grads: (seen.extend(g.clone() for g in grads), step(grads))[1]
        metrics = make_train_step(DiceAndCELoss(ce_weight=1.0), _torch_preprocess)(
            TrainState(tm, opt), torch.from_numpy(images), torch.from_numpy(labels))
        names = [n for n, _ in tm.named_parameters()]
        return tm, float(metrics["loss"]), dict(zip(names, seen))

    tm, loss, grads = port_step(torch.bfloat16)
    _, loss_f32, grads_f32 = port_step(torch.float32)
    keys = list(grads)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    assert all(grads[k].dtype == torch.float32 for k in keys)

    def flat(g):  # by the port's names, flattened
        return np.concatenate([np.asarray(g[k], np.float32).ravel() for k in keys])

    def flat_flax(tree):
        return flat(unet_state_dict_from_flax({"params": tree,
                                               "batch_stats": variables["batch_stats"]}))

    want16, want32 = flat_flax(grads16), flat_flax(grads32)
    gap = _rel(want16, want32, want32)
    assert GRAD_TOL < gap, (GRAD_TOL, gap)
    err = _rel(flat(grads), want16, want32)
    assert err <= GRAD_TOL, (err, gap)
    assert _rel(flat(grads_f32), want16, want32) > GRAD_TOL
    loss_gap = abs(loss16 - loss32) / abs(loss32)
    assert LOSS_TOL < loss_gap, (LOSS_TOL, loss_gap)
    assert abs(loss - loss16) / abs(loss32) <= LOSS_TOL, (loss, loss16, loss32)
    assert abs(loss_f32 - loss16) / abs(loss32) > LOSS_TOL

    # the step itself: optax's Adam on the port's gradients, in float32
    tx = jax_optimizer("adam", jax_schedule(**lr_kw), grad_clip=10.0, weight_decay=5e-4)
    params = variables["params"]
    port_grads = unet_state_dict_to_flax({**unet_state_dict_from_flax(variables),
                                          **{k: v for k, v in grads.items()}})["params"]
    updates, _ = tx.update(port_grads, tx.init(params), params)
    want = unet_state_dict_from_flax({"params": optax.apply_updates(params, updates),
                                      "batch_stats": variables["batch_stats"]})
    got = tm.state_dict()
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_al_train_bfloat16_writes_float32_checkpoints_jax_reads(tmp_path, monkeypatch):
    """``al_train_torch --compute-dtype bfloat16 --device cpu``, 2 rounds of 3
    iterations on a synthetic FUGC set: the UNet computes in bfloat16 over
    float32 parameters, losses are finite, and each round's ``model.msgpack``
    holds float32 arrays that the JAX UNet loads and runs."""
    from synth_data import make_fugc

    from mia_tpu_torch.entry.activelearning.train import train_entry
    from mia_tpu_torch.training import ALTrainer

    data = tmp_path / "fugc"
    make_fugc(data, n_train=10, n_val=2, n_test=2, size=(32, 32))
    base = ALTrainer._unet_config
    monkeypatch.setattr(ALTrainer, "_unet_config",
                        lambda self: dataclasses.replace(base(self), channels_list=CHANNELS))
    losses, conv_dtypes = [], set()
    orig_record = ALTrainer._record_train_loss

    def record(self, step_index, lr, loss):
        losses.append(loss)
        for m in self.model.modules():
            if isinstance(m, torch.nn.Conv2d) and not m._forward_hooks:
                m.register_forward_hook(lambda mod, i, o: conv_dtypes.add(o.dtype))
        return orig_record(self, step_index, lr, loss)

    monkeypatch.setattr(ALTrainer, "_record_train_loss", record)
    trainer = train_entry([
        "--work-path", str(tmp_path / "work"), "--data-path", str(data), "--device", "cpu",
        "--dataset", "fugc", "--in-channels", "3", "--num-classes", "2", "--image-size", "32",
        "--batch-size", "2", "--valid-mode", "slice", "--num-rounds", "2", "--budget", "2",
        "--num-iters", "3", "--valid-freq-iter", "3", "--lr-warmup-iter", "1",
        "--compute-dtype", "bfloat16", "--quiet",
    ])
    assert trainer.model.cfg.compute_dtype == torch.bfloat16
    assert conv_dtypes == {torch.bfloat16}
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS,
                               compute_dtype=jnp.bfloat16))
    template = jax.jit(lambda k, x: jm.init(k, x, train=False))(jax.random.key(0),
                                                                jnp.zeros((1, 32, 32, 3)))
    x = np.random.default_rng(4).normal(size=(1, 32, 32, 3)).astype(np.float32)
    for r in range(2):
        blob = (trainer.work_path / f"round_{r}/final_model/model.msgpack").read_bytes()
        raw = serialization.msgpack_restore(blob)
        assert all(a.dtype == np.float32 for a in jax.tree.leaves(raw))
        restored = serialization.from_bytes(template, blob)
        logits = jm.apply(restored, jnp.asarray(x), train=False)
        assert logits.dtype == jnp.bfloat16 and bool(jnp.isfinite(logits).all())
    # the JAX model on the last round's weights against the trainer's model
    trainer.model.eval()
    with torch.no_grad():
        got = trainer.model(torch.from_numpy(x))
    assert _rel(got.float(), logits, logits) <= 1e-2
