"""The port's checkpoint files against ``flax.serialization``, on the CPU.

- ``utils/flax_msgpack.py``'s writer: the bytes of a UNet, a ``LegacyUNet``
  and the JAX ``SamDualmask``'s LoRA subset (through the inverse bridges of
  ``models/flax_bridge.py`` and ``models/sam_flax_bridge.py``) are the bytes
  flax writes for the same tree; ``flax.serialization.from_bytes`` restores
  every leaf bit for bit, and the port restores flax's bytes bit for bit.
- ``training/state.py::to_optax_state``: after two updates of the same
  gradients, the tree of ``adam`` (with and without weight decay), ``adamw``
  and ``sgd``, with a schedule and with a constant rate, has the structure
  and dtypes of ``flax.serialization.to_state_dict`` of the JAX package's
  optax state and its values within 1e-5 of max |value| (another float32
  order of operations); flax's bytes of that state load into the port and
  come back bit for bit.

The trainers' files: ``tests/test_torch_checkpoints_resume.py``.
"""


import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
from mia_tpu.models.legacy_unet import LegacyUNetConfig as JaxLegacyConfig
from mia_tpu.training.state import make_optimizer as jax_optimizer
from mia_tpu_torch.models import (LegacyUNet, LegacyUNetConfig, UNet, UNetConfig,
                                  legacy_unet_state_dict_from_flax, legacy_unet_state_dict_to_flax,
                                  unet_state_dict_from_flax, unet_state_dict_to_flax)
from mia_tpu_torch.training import load_optax_state, make_optimizer, to_optax_state
from mia_tpu_torch.utils import flax_msgpack
from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack, to_bytes

CHANNELS = (8, 16, 32)


def _seeded(shapes, seed):
    """Seeded leaves in the given shapes: kernels N(0, 1/fan_in), BN variances
    in [0.5, 1.5), everything else N(0, 0.2) (so no conv bias starts at zero)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = np.prod(s.shape[:-1])
            return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.random(s.shape)).astype(np.float32)
        return (0.2 * rng.standard_normal(s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _flax_bytes(tree):
    """The bytes the JAX package writes: its trees pass through ``jax.tree.map``."""
    return serialization.to_bytes(jax.tree.map(lambda x: x, tree))


def _assert_same_tree(got, want):
    """Equal structure, dtypes and bits."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


# --- model.msgpack ---------------------------------------------------------------


@pytest.mark.parametrize("einsum_upsample", [False, True])
def test_unet_msgpack_is_flax_bytes(einsum_upsample):
    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS,
                               einsum_upsample=einsum_upsample))
    variables = _seeded(jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                                       train=False)), 0)
    tm = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS,
                         einsum_upsample=einsum_upsample))
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    data = to_bytes(unet_state_dict_to_flax(tm.state_dict()))
    assert data == _flax_bytes(variables)
    _assert_same_tree(serialization.from_bytes(variables, data), variables)
    _assert_same_tree(read_flax_msgpack(_flax_bytes(variables)), variables)
    # the moments of an optimizer: parameters only
    params_only = unet_state_dict_to_flax({n: p for n, p in tm.named_parameters()})
    _assert_same_tree(params_only, {"params": variables["params"]})


def test_legacy_unet_msgpack_is_flax_bytes():
    net = JaxLegacyUNet(JaxLegacyConfig(n_channels=3, n_classes=3, width=8))
    variables = _seeded(jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0),
                                                        jnp.zeros((1, 32, 32, 3)), train=False)), 1)
    tm = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3, width=8))
    tm.load_state_dict(legacy_unet_state_dict_from_flax(variables))
    data = to_bytes(legacy_unet_state_dict_to_flax(tm.state_dict()))
    assert data == _flax_bytes(variables)
    _assert_same_tree(serialization.from_bytes(variables, data), variables)

    # bilinear (the JAX model cannot run it): no up-convolutions, torch → flax → torch
    bilinear = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=None, bilinear=True, width=8))
    tree = legacy_unet_state_dict_to_flax(bilinear.state_dict())
    assert not any(k.startswith("up_tconv") or k == "outc" for k in tree["params"])
    back = legacy_unet_state_dict_from_flax(read_flax_msgpack(to_bytes(tree)))
    for k, v in bilinear.state_dict().items():
        assert torch.equal(back[k], v) or k.endswith("num_batches_tracked"), k


def test_chunked_arrays_are_written_as_flax_chunks_them(monkeypatch):
    tree = {"a": np.arange(10, dtype=np.float32), "b": {"c": np.arange(7, dtype=np.int32)}}
    for module in (serialization, flax_msgpack):
        monkeypatch.setattr(module, "MAX_CHUNK_SIZE", 12)
    data = to_bytes(tree)
    assert b"__msgpack_chunked_array__" in data and data == serialization.to_bytes(tree)
    _assert_same_tree(serialization.from_bytes(tree, data), tree)
    _assert_same_tree(read_flax_msgpack(data), tree)


# --- opt_state.msgpack -------------------------------------------------------------


@pytest.mark.parametrize("scheduled", [True, False], ids=["schedule", "constant"])
@pytest.mark.parametrize("name,weight_decay", [("adam", 0.0), ("adam", 5e-4), ("adamw", 0.1),
                                               ("sgd", 0.1)])
def test_optax_state_matches_the_jax_optimizer(name, weight_decay, scheduled):
    torch.manual_seed(0)
    rng = np.random.default_rng(1)
    tm = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS))
    schedule = optax.linear_schedule(1e-3, 0.0, 10)
    opt = make_optimizer(name, tm.parameters(),
                         (lambda s: float(schedule(s))) if scheduled else 1e-3, 10.0, weight_decay)
    params = unet_state_dict_to_flax(tm.state_dict())["params"]
    tx = jax_optimizer(name, schedule if scheduled else 1e-3, 10.0, weight_decay)
    state = tx.init(params)
    names = [n for n, _ in tm.named_parameters()]
    for scale in (30.0, 0.01):  # one clipped step, one unclipped
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
    # the port's bytes through flax, flax's bytes through the port: bit for bit
    _assert_same_tree(serialization.to_state_dict(serialization.from_bytes(state, to_bytes(got))),
                      got)
    fresh = make_optimizer(name, tm.parameters(), opt.lr if scheduled else 1e-3, 10.0,
                           weight_decay)
    load_optax_state(fresh, tm, read_flax_msgpack(_flax_bytes(state)))
    _assert_same_tree(to_optax_state(fresh, tm), want)
    assert fresh.count == 2 or (name == "sgd" and not scheduled)


# --- the LoRA subset ----------------------------------------------------------------


def test_lora_msgpack_is_the_jax_lora_state_dict(tmp_path):
    from mia_tpu.models.sam import SamDualmask as JaxSamDualmask
    from mia_tpu.models.sam.lora import load_lora_bytes, lora_state_dict as jax_lora_state_dict
    from mia_tpu.models.sam.lora import save_lora_bytes
    from mia_tpu_torch.models.sam import SamDualmask
    from mia_tpu_torch.models.sam.lora import (load_lora_state_dict, lora_state_dict,
                                              read_lora_checkpoint, write_lora_msgpack)
    from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

    kw = dict(img_size=64, num_classes=3, encoder_embed_dim=32, encoder_depth=2,
              encoder_num_heads=2, encoder_global_attn_indexes=(1,), lora_rank=2)
    jm = JaxSamDualmask(**kw, use_stacked_decoders=False)
    shapes = jax.eval_shape(lambda k: jm.init({"params": k, "prompt": k, "dropout": k},
                                              jnp.zeros((1, 64, 64, 3)), 64,
                                              method=jm.init_variables), jax.random.PRNGKey(0))
    params = _seeded(shapes["params"], 2)
    tm = SamDualmask(**kw)
    tm.load_state_dict(sam_state_dict_from_flax({"params": params}), strict=True)

    write_lora_msgpack(tm, tmp_path / "lora.msgpack")
    data = (tmp_path / "lora.msgpack").read_bytes()
    target = jax_lora_state_dict(params)
    assert data == save_lora_bytes(params)
    _assert_same_tree(serialization.from_bytes(target, data), target)
    # the JAX package loads it into its full params, the frozen encoder untouched
    loaded = load_lora_bytes(jax.tree.map(np.zeros_like, params), data)
    assert not np.any(loaded["image_encoder"]["block0"]["attn"]["qkv"]["kernel"])
    np.testing.assert_array_equal(loaded["mask_decoder2"]["core"]["iou_token"],
                                  params["mask_decoder2"]["core"]["iou_token"])

    # flax's bytes into the port: every LoRA entry bit for bit
    (tmp_path / "jax.msgpack").write_bytes(save_lora_bytes(params))
    fresh = SamDualmask(**kw)
    load_lora_state_dict(fresh, read_lora_checkpoint(tmp_path / "jax.msgpack"))
    for k, v in lora_state_dict(fresh).items():
        assert torch.equal(v, lora_state_dict(tm)[k]), k
