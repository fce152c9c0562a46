"""The checkpoint files of the port's trainers against the JAX package's,
on the CPU at narrow width (UNet 8..32, 32x32).

- Cross resume: a JAX ``ALTrainer``'s ``final_model`` (``model.msgpack``,
  ``opt_state.msgpack``, ``training_state.json``) resumes in
  ``al_train_torch`` and a port one in the JAX ``load_state_dict``, at the
  same iteration, round and data list, every parameter, statistic and
  moment equal bit for bit; one train step after the resume agrees with the
  other package's step within ``tests/test_torch_train_step.py``'s
  tolerances (losses 1e-5 relative, parameters 1e-4 relative + 1e-6, the
  BN-fed conv biases 1e-5 absolute).
- ``fugc2025_train_torch``'s ``fold_<i>/model.msgpack`` restores through
  ``flax.serialization.from_bytes`` into the JAX UNet.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.losses import DiceAndCELoss as JaxLoss
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.training import ALTrainer as JaxALTrainer
from mia_tpu.training.steps import make_train_step as jax_train_step
from mia_tpu.transforms.normalization import zscore_normalize as jax_zscore
from mia_tpu_torch.losses import DiceAndCELoss
from mia_tpu_torch.models import unet_state_dict_from_flax, unet_state_dict_to_flax
from mia_tpu_torch.training import ALTrainer, make_train_step, to_optax_state
from mia_tpu_torch.transforms import zscore_normalize
from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack
from synth_data import make_fugc
from test_torch_checkpoints import CHANNELS, _assert_same_tree, _seeded


@pytest.fixture(scope="module")
def fugc_root(tmp_path_factory):
    return make_fugc(tmp_path_factory.mktemp("fugc_ckpt"), n_train=8, n_val=2, n_test=2,
                     size=(40, 48))


@pytest.fixture
def narrow(monkeypatch):
    for cls in (ALTrainer, JaxALTrainer):
        full = cls._unet_config
        monkeypatch.setattr(cls, "_unet_config", lambda self, full=full: dataclasses.replace(
            full(self), channels_list=CHANNELS))


def _config(root):
    return dict(dataset="fugc", data_path=str(root), in_channels=3, num_classes=2, image_size=32,
                batch_size=2, budget=2, num_iters=10, lr_warmup_iter=2, dropout_prob=0.0,
                active_selector_name="entropy", optimizer_kwargs={"weight_decay": 5e-4})


def _started(cls, tmp_path, root, resume=None, **kw):
    """A trainer of either package, initialised and started (resumed if asked)."""
    trainer = cls(work_path=tmp_path / cls.__module__.split(".")[0], config=_config(root),
                  resume=resume, verbose=False, **kw)
    trainer.initialize()
    trainer.on_train_start()
    return trainer


def _batch(seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8),
            rng.integers(0, 3, (2, 32, 32), dtype=np.uint8))


def _one_step_each(jt, tt, seed):
    """One train step (no augmentation, as in ``test_torch_train_step.py``) in
    each package from its trainer's state; hold the losses and parameters."""
    images, labels = _batch(seed)

    def jax_pre(rng, im, lb):
        return jax.vmap(jax_zscore)(im.astype(jnp.float32) / 255.0), lb.astype(jnp.int32)

    def torch_pre(generator, im, lb):
        return zscore_normalize(im.to(torch.float32) / 255.0), lb.long()

    jstep = jax_train_step(JaxLoss(), donate=False, preprocess_fn=jax_pre)
    state, jmetrics = jstep(jt.state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(1))
    tmetrics = make_train_step(DiceAndCELoss(), torch_pre)(
        tt.state, torch.from_numpy(images), torch.from_numpy(labels))
    for key in ("loss", "loss_ce", "loss_dice"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    want = unet_state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats})
    for key, value in tt.model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        tol = dict(rtol=0, atol=1e-5) if ".all.0.bias" in key else dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(value.numpy(), want[key].numpy(), err_msg=key, **tol)


def _assert_same_state(jt, tt):
    """The two trainers hold the same parameters, statistics and moments, bit for bit."""
    _assert_same_tree(unet_state_dict_to_flax(tt.model.state_dict()),
                      {"params": jax.device_get(jt.state.params),
                       "batch_stats": jax.device_get(jt.state.batch_stats)})
    _assert_same_tree(to_optax_state(tt.state.optimizer, tt.model),
                      jax.tree.map(np.asarray, serialization.to_state_dict(jt.state.opt_state)))


def test_a_jax_final_model_resumes_in_the_port(fugc_root, tmp_path, narrow):
    jt = _started(JaxALTrainer, tmp_path, fugc_root)
    # a state that is no fresh init: seeded weights and statistics, two updates
    seeded = _seeded(jax.eval_shape(lambda: {"params": jt.state.params,
                                             "batch_stats": jt.state.batch_stats}), 4)
    jt.state = jt.state.replace(params=seeded["params"], batch_stats=seeded["batch_stats"])
    rng = np.random.default_rng(3)
    for _ in range(2):
        jt.state = jt.state.apply_gradients(jax.tree.map(
            lambda p: rng.standard_normal(p.shape).astype(np.float32), jt.state.params))
    jt.active_dataset.extend_train_set(jt.active_dataset.pool_dataset.image_idx[:2])
    jt.current_iter, jt.current_epoch, jt.current_round = 7, 3, 0
    final = tmp_path / "jax_run" / "final_model"
    jt.save_state_dict(final, save_training_state=True)
    jt.flush_saves()
    assert {p.name for p in final.iterdir()} == {"model.msgpack", "opt_state.msgpack",
                                                  "training_state.json"}
    saved = json.loads((final / "training_state.json").read_text())

    tt = _started(ALTrainer, tmp_path, fugc_root, resume=str(final), device="cpu")
    assert (tt.current_iter, tt.current_epoch, tt.current_round) == (8, 4, 1)
    assert tt.state.step == saved["current_iter"] + 1 and tt.state.optimizer.count == 2
    assert tt.active_dataset.data_list() == saved["data_list"]
    assert len(saved["data_list"]["labeled_image_idx"]) == 2
    _assert_same_state(jt, tt)
    _one_step_each(jt, tt, 5)


def test_a_port_final_model_resumes_in_jax(fugc_root, tmp_path, narrow):
    tt = _started(ALTrainer, tmp_path, fugc_root, device="cpu")
    rng = np.random.default_rng(6)
    with torch.no_grad():  # weights and statistics that are no fresh init
        for p in tt.model.parameters():
            p.add_(0.05 * torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)))
        for m in tt.model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.2)
                m.running_var.uniform_(0.5, 1.5)
    opt = tt.state.optimizer
    for _ in range(2):
        opt.step([torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                  for p in opt.params])
    tt.active_dataset.extend_train_set(tt.active_dataset.pool_dataset.image_idx[:2])
    tt.current_iter, tt.current_epoch, tt.current_round = 5, 2, 1
    final = tmp_path / "port_run" / "final_model"
    tt.save_state_dict(final, save_training_state=True)
    assert {p.name for p in final.iterdir()} == {"model.msgpack", "opt_state.msgpack",
                                                  "training_state.json"}
    saved = json.loads((final / "training_state.json").read_text())

    jt = _started(JaxALTrainer, tmp_path, fugc_root, resume=str(final))
    assert (jt.current_iter, jt.current_epoch, jt.current_round) == (6, 3, 2)
    assert int(jt.state.step) == saved["current_iter"] + 1
    assert jt.active_dataset.data_list() == saved["data_list"]
    assert len(saved["data_list"]["labeled_image_idx"]) == 2
    _assert_same_state(jt, tt)
    _one_step_each(jt, tt, 7)


def test_fold_model_msgpack_restores_through_flax(fugc_root, tmp_path, narrow):
    from mia_tpu_torch.entry.fugc2025.train import train_entry

    trainer = train_entry(["--work-dir", str(tmp_path / "work"), "--data-dir", str(fugc_root),
                           "--device", "cpu", "--num-folds", "2", "--num-epochs", "1",
                           "--batch-size", "2", "--image-size", "32", "--valid-freq-iter", "2"])
    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS))
    target = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    target = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), target)
    data = (trainer.work_path / "fold_1" / "model.msgpack").read_bytes()
    restored = serialization.from_bytes(target, data)
    _assert_same_tree(restored, read_flax_msgpack(data))
    assert jax.tree.structure(restored) == jax.tree.structure(target)
