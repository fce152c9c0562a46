"""The port's 3D UNet (``UNetConfig(dimension=3)``) against the JAX package.

At widths (4, 8, 16, 32) on 16³ volumes, on the CPU, the same seeded
weights carried through ``unet_state_dict_from_flax``:

- plain blocks with batch norm and residual blocks with instance norm:
  eval-mode logits and ``enc_feature`` within 1e-5 of max |value|; one train
  step with dropout off: the loss, every gradient within 1e-5 of the
  largest, the batch statistics, and the parameters after Adam. The JAX side
  of the step runs in float64 (``compute_dtype`` and ``jax.enable_x64``):
  flax's BatchNorm takes the variance as E[x²] - E[x]², which at these
  shapes puts its own float32 gradients 5e-3 of the largest from float64,
  while the port's float32 gradients lie within 2e-6 of it;
- the deep-supervision heads: the logits' shape, equal to a trilinear
  ``F.interpolate`` of the port's own head convolutions (the JAX heads go
  through the 2D resize and keep the head's depth, so they cannot be
  compared);
- ``model.msgpack``: the port's bytes of a 3D tree are flax's, and flax's
  bytes restore in the port bit for bit.
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.losses import DiceAndCELoss as JaxLoss
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.training.state import make_optimizer as jax_optimizer
from mia_tpu_torch.losses import DiceAndCELoss
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_from_flax, unet_state_dict_to_flax
from mia_tpu_torch.training import TrainState, make_optimizer, make_train_step
from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack, to_bytes

CHANNELS = (4, 8, 16, 32)  # three upsamplings: ds_layer 3 puts heads on levels 0 and 1
SIDE = 16
VARIANTS = {
    "plain-batch": dict(block_type="plain", normalization="batch"),
    "res-instance": dict(block_type="res", normalization="instance"),
}


def _cfg(variant, **over):
    kw = dict(dimension=3, in_channels=1, out_classes=3, channels_list=CHANNELS, dropout_prob=0.0,
              **VARIANTS.get(variant, {}), **over)
    return JaxUNetConfig(**kw), UNetConfig(**kw)


def _seeded(shapes, seed):
    """Seeded leaves: kernels N(0, 1/fan_in), BN variances in [0.5, 1.5),
    everything else N(0, 0.2) (no conv bias starts at zero)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            return (rng.standard_normal(s.shape) / np.sqrt(np.prod(s.shape[:-1]))).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _pair(variant, seed=0, **over):
    jcfg, tcfg = _cfg(variant, **over)
    jm = JaxUNet(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, SIDE, SIDE, SIDE, 1)),
                                            train=False))
    variables = _seeded(shapes, seed)
    tm = UNet(tcfg)
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    return jm, tm, variables


def _inputs(seed=1, b=2):
    rng = np.random.default_rng(seed)
    return (rng.random((b, SIDE, SIDE, SIDE, 1)).astype(np.float32),
            rng.integers(0, 3, (b, SIDE, SIDE, SIDE)).astype(np.int32))


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} x {scale}"


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant):
    jm, tm, variables = _pair(variant)
    x, _ = _inputs()
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        feature = tm.enc_feature(torch.from_numpy(x))
    assert got.shape == (2, SIDE, SIDE, SIDE, 3)
    _close(got.numpy(), jm.apply(variables, jnp.asarray(x), train=False), 1e-5, "logits")
    _close(feature.numpy(), jm.apply(variables, jnp.asarray(x), method=jm.enc_feature), 1e-5,
           "enc_feature")


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_train_step_matches_jax(variant):
    jm, tm, variables = _pair(variant, seed=2)
    x, y = _inputs(seed=3)

    with jax.enable_x64(True):
        jm64 = JaxUNet(dataclasses.replace(jm.cfg, compute_dtype=jnp.float64))
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), variables)
        stats = v64.get("batch_stats")

        def loss(params):
            v = {"params": params, **({"batch_stats": stats} if stats else {})}
            logits, updated = jm64.apply(v, jnp.asarray(x, jnp.float64), train=True,
                                         mutable=["batch_stats"])
            return JaxLoss()(logits, jnp.asarray(y))[0], updated.get("batch_stats")

        (jloss, new_stats), jflax_grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            v64["params"])
        # optax's Adam on the JAX gradients
        tx = jax_optimizer("adam", 1e-3, 10.0, 5e-4)
        updates, _ = tx.update(jflax_grads, tx.init(v64["params"]), v64["params"])
        params = optax.apply_updates(v64["params"], updates)
        to_np = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float32), tree)  # noqa: E731
        jloss, jflax_grads, params, new_stats = map(to_np, (jloss, jflax_grads, params, new_stats))
    jgrads = unet_state_dict_from_flax({"params": jflax_grads})

    # the port's train step on the same weights: its loss and, through a hook
    # on the optimizer, the gradients it was handed
    seen = {}
    opt = make_optimizer("adam", tm.parameters(), 1e-3, 10.0, 5e-4)
    step = opt.step
    opt.step = lambda grads: (seen.setdefault("grads", [g.clone() for g in grads]), step(grads))[1]
    metrics = make_train_step(DiceAndCELoss(), lambda g, i, l: (i, l.long()))(
        TrainState(tm, opt), torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
    scale = max(np.abs(v.numpy()).max() for v in jgrads.values())
    for (name, _), g in zip(tm.named_parameters(), seen["grads"]):
        assert np.abs(g.numpy() - jgrads[name].numpy()).max() <= 1e-5 * scale, name

    # the parameters after Adam. Its first step is g/|g| · lr: where the
    # decayed gradient lies within the gradients' tolerance of zero, its sign
    # is float noise, and the step is held to one lr step either way
    want = unet_state_dict_from_flax({"params": params, "batch_stats": new_stats}
                                     if stats else {"params": params})
    start = unet_state_dict_from_flax(variables)
    got_sd = tm.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        got, value = got_sd[key].numpy(), value.numpy()
        if key not in jgrads:  # running statistics
            np.testing.assert_allclose(got, value, rtol=1e-5, atol=1e-6, err_msg=key)
            continue
        tiny = np.abs(jgrads[key].numpy() + 5e-4 * start[key].numpy()) <= 1e-4 * scale
        assert (np.abs(got - value)[tiny] <= 2e-3).all(), key
        assert np.isclose(got, value, rtol=1e-4, atol=1e-6)[~tiny].all(), key


def test_deep_supervision_heads_have_the_logits_shape():
    jm, tm, variables = _pair("res-instance", deep_supervision=True, ds_layer=3)
    x, _ = _inputs()
    heads = {}
    for l, head in tm.decoder.ds.items():
        head.register_forward_hook(lambda m, i, out, l=l: heads.__setitem__(l, out))
    tm.eval()
    with torch.no_grad():
        logits, *ds = tm(torch.from_numpy(x), return_ds=True)
        plain = tm(torch.from_numpy(x))
    torch.testing.assert_close(logits, plain, rtol=0, atol=0)
    assert len(ds) == 2 and sorted(heads) == ["0", "1"]
    # finest level first: level 1 (factor 2), then level 0 (factor 4)
    for out, (level, factor) in zip(ds, (("1", 2), ("0", 4))):
        assert out.shape == logits.shape
        want = F.interpolate(heads[level], scale_factor=factor, mode="trilinear",
                             align_corners=False)
        torch.testing.assert_close(out, want.permute(0, 2, 3, 4, 1), rtol=0, atol=0)
    # the JAX heads keep the head's depth (its 2D resize scales H and W only)
    jout = jm.apply(variables, jnp.asarray(x), train=False, return_ds=True)
    np.testing.assert_allclose(np.asarray(jout[0]), logits.numpy(), rtol=0,
                               atol=1e-5 * np.abs(logits.numpy()).max())
    assert [tuple(o.shape) for o in jout[1:]] == [(2, 8, 16, 16, 3), (2, 4, 16, 16, 3)]


@pytest.mark.parametrize("variant", VARIANTS)
def test_model_msgpack_round_trips_between_the_packages(variant):
    jm, tm, variables = _pair(variant, seed=4)
    flax_bytes = serialization.to_bytes(jax.tree.map(lambda a: a, variables))
    # the port's bytes of its own state dict are flax's
    assert to_bytes(unet_state_dict_to_flax(tm.state_dict())) == flax_bytes
    # flax's bytes restore in the port bit for bit, and flax restores the port's
    back = read_flax_msgpack(flax_bytes)
    fresh = UNet(tm.cfg)
    fresh.load_state_dict(unet_state_dict_from_flax(back))
    for key, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    restored = serialization.from_bytes(variables, to_bytes(unet_state_dict_to_flax(
        fresh.state_dict())))
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(variables)):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    # the restored weights give the JAX logits
    x, _ = _inputs(seed=5, b=1)
    fresh.eval()
    with torch.no_grad():
        got = fresh(torch.from_numpy(x)).numpy()
    _close(got, jm.apply(restored, jnp.asarray(x), train=False), 1e-5, "restored logits")
