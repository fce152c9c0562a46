"""The UNet's other options in the PyTorch port, held against the JAX package.

Residual blocks, instance norm and the deep-supervision heads (the UNets
that ``al_train``'s ``--block-type res``, ``--block-normalization
instance`` and ``--deep-supervision`` build), at small widths on the CPU,
with the same seeded weights carried through ``unet_state_dict_from_flax``:

- logits (eval and train mode) and the ``return_ds`` outputs within 1e-5
  of max |logit|, batch statistics within 1e-5;
- one train step with dropout off: every gradient within 1e-4 of the
  largest, the parameters after Adam (L2 decay) within 1e-4 relative;
- ``adamw`` moves the heads, whose gradient is zero, by its decay alone,
  as optax does;
- flax → torch → flax bit for bit, ``model.msgpack`` and ``opt_state.msgpack``
  the bytes flax writes, and the JAX importer reads the port's state dict
  (the reference's names) into the same variables.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.losses import DiceAndCELoss as JaxLoss
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.models.torch_port import import_torch_unet_checkpoint as jax_import_torch
from mia_tpu.training.state import make_optimizer as jax_optimizer
from mia_tpu_torch.losses import DiceAndCELoss
from mia_tpu_torch.models import (UNet, UNetConfig, import_torch_unet_checkpoint,
                                  unet_state_dict_from_flax, unet_state_dict_to_flax)
from mia_tpu_torch.training import (TrainState, load_optax_state, make_optimizer,
                                    make_train_step, to_optax_state)
from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack, to_bytes

CHANNELS = (8, 16, 32, 64)  # three upsamplings: ds_layer 3 puts heads on levels 0 and 1
VARIANTS = {
    "res-batch": dict(block_type="res", normalization="batch"),
    "plain-instance": dict(block_type="plain", normalization="instance"),
    "res-instance-ds": dict(block_type="res", normalization="instance", deep_supervision=True,
                            ds_layer=3),
}


def _cfg(variant, dropout=0.0, **over):
    kw = dict(in_channels=1, out_classes=3, channels_list=CHANNELS, dropout_prob=dropout,
              **VARIANTS[variant], **over)
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


def _pair(variant, seed=0, hw=(32, 32)):
    jcfg, tcfg = _cfg(variant)
    jm = JaxUNet(jcfg)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, *hw, 1)),
                                            train=False))
    variables = _seeded(shapes, seed)
    tm = UNet(tcfg)
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    return jm, tm, variables


def _inputs(seed=1, b=2, hw=(32, 32)):
    rng = np.random.default_rng(seed)
    return (rng.random((b, *hw, 1)).astype(np.float32),
            rng.integers(0, 3, (b, *hw)).astype(np.int32))


def _jax_grads(jm, variables, x, y):
    """``jax.grad`` of the Dice+CE loss in train mode → (param grads, batch stats)."""
    stats = variables.get("batch_stats")

    def loss(params):
        v = {"params": params, **({"batch_stats": stats} if stats else {})}
        logits, updated = jm.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
        return JaxLoss()(logits, jnp.asarray(y))[0], updated.get("batch_stats")

    return _jitted_grad(loss)(variables["params"])


def _jitted_grad(loss):
    return jax.jit(jax.grad(loss, has_aux=True))


def _assert_same_tree(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def _close(got, want, rel, what=""):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * scale, f"{what}: max |diff| {err} > {rel} x {scale}"


@pytest.mark.parametrize("variant", VARIANTS)
def test_forward_matches_jax(variant):
    jm, tm, variables = _pair(variant)
    x, _ = _inputs()
    ds = jm.cfg.deep_supervision
    tm.eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x), return_ds=ds)
    want = jm.apply(variables, jnp.asarray(x), train=False, return_ds=ds)
    if ds:
        assert len(got) == len(want) == 3  # logits, then the heads of levels 1 and 0
        for g, w in zip(got, want):
            assert g.shape == w.shape == (2, 32, 32, 3)
            _close(g.numpy(), w, 1e-5, "return_ds")
        with torch.no_grad():
            _close(tm(torch.from_numpy(x)).numpy(), want[0], 1e-5, "logits")
    else:
        _close(got.numpy(), want, 1e-5, "eval logits")

    # train mode: batch statistics (batch norm) or none at all (instance norm)
    tm.train()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    want, updated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    _close(got.numpy(), want, 1e-5, "train logits")
    if jm.cfg.normalization == "batch":
        back = unet_state_dict_to_flax(tm.state_dict())["batch_stats"]
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(updated["batch_stats"])):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)
    else:
        assert not updated.get("batch_stats") and not any(
            k.endswith("running_mean") for k in tm.state_dict())


@pytest.mark.parametrize("variant", VARIANTS)
def test_one_train_step_matches_jax(variant):
    jm, tm, variables = _pair(variant, seed=2)
    x, y = _inputs(seed=3)
    ids = [n for n, _ in tm.named_parameters()]

    # gradients of the same loss
    stats = variables.get("batch_stats")
    jflax_grads, new_stats = _jax_grads(jm, variables, x, y)
    jgrads = unet_state_dict_from_flax({"params": jflax_grads})
    tm.train()
    loss = DiceAndCELoss()(tm(torch.from_numpy(x)), torch.from_numpy(y).long())[0]
    tgrads = torch.autograd.grad(loss, list(tm.parameters()), allow_unused=True)
    scale = max(v.abs().max().item() for v in jgrads.values())
    for name, g in zip(ids, tgrads):
        want = jgrads[name].numpy()
        if ".ds." in name:  # the heads lie outside the loss: no gradient at all
            assert g is None and not want.any(), name
            continue
        assert np.abs(g.numpy() - want).max() <= 1e-4 * scale, name

    # one Adam step with L2 decay (the decay, not float noise, sets the sign
    # of a norm-fed conv bias's first update): optax on the JAX gradients,
    # the port's train step on its own
    tx = jax_optimizer("adam", 1e-3, 10.0, 5e-4)
    updates, _ = tx.update(jflax_grads, tx.init(variables["params"]), variables["params"])
    params = optax.apply_updates(variables["params"], updates)
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    tstate = TrainState(tm, make_optimizer("adam", tm.parameters(), 1e-3, 10.0, 5e-4))
    make_train_step(DiceAndCELoss(), lambda g, i, l: (i, l.long()))(
        tstate, torch.from_numpy(x), torch.from_numpy(y))
    want = unet_state_dict_from_flax({"params": params, "batch_stats": new_stats}
                                     if stats else {"params": params})
    start = unet_state_dict_from_flax(variables)
    # Adam's first step is g/|g| · lr: where the decayed gradient is within
    # the gradients' tolerance of zero, its sign is float noise in both
    # packages, and the step is held to one lr step either way
    noisy, total = 0, 0
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        got, value = tm.state_dict()[key].numpy(), value.numpy()
        ok = np.isclose(got, value, rtol=1e-4, atol=1e-6)
        if key in jgrads:
            decayed = jgrads[key].numpy() + 5e-4 * start[key].numpy()
            tiny = np.abs(decayed) <= 1e-3 * scale
            assert (np.abs(got - value)[tiny] <= 2e-3).all(), key
            ok |= tiny
            noisy, total = noisy + int((tiny & ~np.isclose(got, value, rtol=1e-4,
                                                           atol=1e-6)).sum()), total + got.size
        assert ok.all(), f"{key}: {np.argwhere(~ok)[:5]}"
    assert noisy <= 1e-3 * total, (noisy, total)


def test_adamw_moves_the_heads_by_its_decay_alone():
    jm, tm, variables = _pair("res-instance-ds", seed=4)
    x, y = _inputs(seed=5)
    tx = jax_optimizer("adamw", 1e-3, 10.0, 0.1)
    params, opt_state = variables["params"], tx.init(variables["params"])
    tstate = TrainState(tm, make_optimizer("adamw", tm.parameters(), 1e-3, 10.0, 0.1))
    tstep = make_train_step(DiceAndCELoss(), lambda g, i, l: (i, l.long()))
    for _ in range(2):
        grads, _ = _jax_grads(jm, {"params": params}, x, y)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        metrics = tstep(tstate, torch.from_numpy(x), torch.from_numpy(y))
        # the clip's global norm counts the heads' zero gradients
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(optax.global_norm(grads)),
                                   rtol=1e-5)
    heads = [n for n in tm.state_dict() if ".ds." in n]
    assert len(heads) == 4  # weight and bias of two heads
    want = unet_state_dict_from_flax({"params": params})
    for n in heads:
        start = unet_state_dict_from_flax(variables)[n]
        # p ← p − lr·wd·p, twice
        decayed = start * np.float32(1.0 - 1e-3 * 0.1) * np.float32(1.0 - 1e-3 * 0.1)
        got = tm.state_dict()[n]
        assert not torch.equal(got, start), n
        np.testing.assert_allclose(got.numpy(), want[n].numpy(), rtol=1e-6, atol=0, err_msg=n)
        np.testing.assert_allclose(got.numpy(), decayed.numpy(), rtol=1e-6, atol=0, err_msg=n)
    # the moments of the heads stay zero in both trees
    got_tree = to_optax_state(tstate.optimizer, tm)
    want_tree = serialization.to_state_dict(opt_state)
    for l in (0, 1):
        for moment in ("mu", "nu"):
            assert not np.asarray(got_tree["1"]["0"][moment]["decoder"][f"ds{l}_conv"]["kernel"]).any()
            assert not np.asarray(want_tree["1"]["0"][moment]["decoder"][f"ds{l}_conv"]["kernel"]).any()


@pytest.mark.parametrize("variant", VARIANTS)
def test_bridge_round_trip_and_msgpack_bytes(variant):
    jm, tm, variables = _pair(variant, seed=6)
    if jm.cfg.normalization == "instance":
        assert set(variables) == {"params"}
    tree = unet_state_dict_to_flax(tm.state_dict())
    _assert_same_tree(tree, variables)
    data = to_bytes(tree)
    assert data == serialization.to_bytes(jax.tree.map(lambda a: a, variables))
    _assert_same_tree(read_flax_msgpack(data), variables)
    # an optimizer's moments: parameters only
    _assert_same_tree(unet_state_dict_to_flax(dict(tm.named_parameters())),
                      {"params": variables["params"]})
    # the JAX importer reads the port's (the reference's) names into the same variables
    levels = tuple(range(len(CHANNELS) - 1))
    imported = jax_import_torch(tm.state_dict(), num_levels=len(CHANNELS),
                                block_type=jm.cfg.block_type, deep_supervision_layers=levels)
    _assert_same_tree(imported, variables)
    # and a reference .pth of the same model loads into the port as it is
    fresh = UNet(_cfg(variant)[1])
    import_torch_unet_checkpoint({"model": tm.state_dict()}, fresh)
    for k, v in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


@pytest.mark.parametrize("variant", ["res-batch", "res-instance-ds"])
def test_opt_state_msgpack_is_the_optax_tree(variant):
    jm, tm, variables = _pair(variant, seed=7)
    rng = np.random.default_rng(8)
    opt = make_optimizer("adamw", tm.parameters(), 1e-3, 10.0, 0.1)
    tx = jax_optimizer("adamw", 1e-3, 10.0, 0.1)
    params = variables["params"]
    state = tx.init(params)
    names = [n for n, _ in tm.named_parameters()]
    for scale in (30.0, 0.01):
        grads = {n: torch.from_numpy((scale * rng.standard_normal(p.shape)).astype(np.float32))
                 for n, p in tm.named_parameters()}
        opt.step([grads[n] for n in names])
        updates, state = tx.update(unet_state_dict_to_flax(grads)["params"], state, params)
        params = optax.apply_updates(params, updates)
    want = jax.tree.map(np.asarray, serialization.to_state_dict(state))
    got = to_optax_state(opt, tm)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.abs(a - b).max() <= 1e-5 * max(np.abs(b).max(), 1e-30)
    # flax's bytes into the port and back out: the same bytes
    flax_bytes = serialization.to_bytes(jax.tree.map(lambda a: a, state))
    fresh = make_optimizer("adamw", tm.parameters(), 1e-3, 10.0, 0.1)
    load_optax_state(fresh, tm, read_flax_msgpack(flax_bytes))
    assert to_bytes(to_optax_state(fresh, tm)) == flax_bytes


def test_only_the_3d_unet_is_left_unported():
    # every UNet the JAX package builds is ported (the 3D one:
    # tests/test_torch_unet3d.py); only configurations it cannot build raise
    with pytest.raises(ValueError):
        UNet(UNetConfig(dimension=4))
    with pytest.raises(ValueError):
        UNet(UNetConfig(block_type="dense"))
    assert UNetConfig(channels_list=CHANNELS, deep_supervision=True, ds_layer=3).ds_levels == [0, 1]
    # the full width: four upsamplings, heads on levels 1 and 2
    assert UNetConfig(deep_supervision=True, ds_layer=3).ds_levels == [1, 2]
    assert UNetConfig(channels_list=CHANNELS, deep_supervision=True, ds_layer=1).ds_levels == []
