"""The ``al_train_torch`` slice end to end on the CPU, and against the JAX
``ALTrainer``.

- ``train_entry([... "--device", "cpu" ...])`` on a synthetic FUGC set at
  narrow width: two AL rounds, the round layout on disk, and the labeled set
  growing by the budget.
- One whole AL run (round 0, the entropy selection, round 1) through both
  trainers from the same weights, augmentation off and dropout 0: training
  losses, validation metrics and the selected case ids must agree.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from mia_tpu.training import ALTrainer as JaxALTrainer
from mia_tpu_torch.entry.activelearning.train import train_entry
from mia_tpu_torch.models import unet_state_dict_from_flax
from mia_tpu_torch.ops.warp import affine_warp_shift2pass_fused
from mia_tpu_torch.training import ALTrainer
from synth_data import make_fugc


@pytest.fixture(scope="module")
def fugc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fugc_slice")
    make_fugc(root, n_train=8, n_val=2, n_test=2, size=(40, 48))
    return root


def _narrow(trainer_cls, monkeypatch, channels):
    full = trainer_cls._unet_config
    monkeypatch.setattr(
        trainer_cls, "_unet_config",
        lambda self: dataclasses.replace(full(self), channels_list=channels),
    )


def test_entry_runs_two_rounds_on_cpu(fugc_root, tmp_path, monkeypatch):
    _narrow(ALTrainer, monkeypatch, (8, 16, 32))
    trainer = train_entry([
        "--work-path", str(tmp_path), "--data-path", str(fugc_root), "--device", "cpu",
        "--dataset", "fugc", "--in-channels", "3", "--num-classes", "2",
        "--image-size", "32", "--batch-size", "2", "--valid-mode", "slice",
        "--active-selector", "entropy", "--do-augment", "--do-normalize",
        "--num-rounds", "2", "--budget", "2", "--num-iters", "3",
        "--valid-freq-iter", "2", "--lr-warmup-iter", "1", "--quiet",
    ])
    work = trainer.work_path
    for r in range(2):
        assert (work / f"round_{r}/data_list.json").is_file()
        assert (work / f"round_{r}/best_model/model.msgpack").is_file()
        assert (work / f"round_{r}/final_model/model.msgpack").is_file()
        assert (work / f"round_{r}/final_model/training_state.json").is_file()
        assert (work / f"test_mean_round_{r}.csv").is_file()
    dl0 = json.loads((work / "round_0/data_list.json").read_text())
    dl1 = json.loads((work / "round_1/data_list.json").read_text())
    assert len(dl0["labeled_image_idx"]) == 2
    assert len(dl1["labeled_image_idx"]) == 2 + 2
    assert set(dl0["labeled_image_idx"]) <= set(dl1["labeled_image_idx"])
    assert (work / "config.json").is_file() and any((work / "sanity").glob("*.png"))
    header = (work / "test_mean_round_1.csv").read_text().splitlines()[0]
    assert "all-DSC" in header and "anterior lip-DSC" in header
    # the CPU run took the plain warp: the kernel's launch count stays 0
    assert affine_warp_shift2pass_fused.launches == 0
    assert next(trainer.model.parameters()).device.type == "cpu"


def _config(root, **over):
    base = dict(
        seed=7, dataset="fugc", data_path=str(root), in_channels=3, num_classes=2,
        image_size=32, batch_size=2, valid_batch_size=1, valid_mode="slice",
        active_learning=True, num_rounds=2, budget=2, active_selector_name="entropy",
        num_iters=3, valid_freq_iter=2, lr_warmup_iter=1, start_lr=1e-3,
        do_augment=False, do_normalize=True, do_oversample=True,
        optimizer_name="adam", optimizer_kwargs={"weight_decay": 5e-4}, dropout_prob=0.0,
    )
    base.update(over)
    return base


def _spy(trainer, log):
    """Record train losses and per-case validation metrics of a trainer."""
    record, valid_end = trainer._record_train_loss, trainer.on_valid_epoch_end

    def record_loss(step_index, lr, loss):
        log["loss"].append((trainer.current_round, step_index, loss))
        return record(step_index, lr, loss)

    def on_valid_epoch_end():
        valid_end()
        for o in trainer.epoch_valid_outputs:
            log["valid"].append((np.asarray(o["metric_all"]), np.asarray(o["metric"]), o["loss"]))

    trainer._record_train_loss = record_loss
    trainer.on_valid_epoch_end = on_valid_epoch_end


def test_al_run_matches_jax_trainer(fugc_root, tmp_path, monkeypatch):
    channels = (8, 16)
    _narrow(JaxALTrainer, monkeypatch, channels)
    _narrow(ALTrainer, monkeypatch, channels)
    weights, jlog, tlog = {}, {"loss": [], "valid": []}, {"loss": [], "valid": []}

    jt = JaxALTrainer(work_path=tmp_path / "jax", config=_config(fugc_root), verbose=False)
    jax_build = jt._build_model

    def jax_build_model(round_key=0):
        jax_build(round_key)
        variables = jax.tree.map(np.array, {"params": jt.state.params,
                                            "batch_stats": jt.state.batch_stats})
        # non-zero conv biases before BN: from zero their update is Adam
        # acting on gradient float noise (see test_torch_train_step.py)
        rng = np.random.default_rng(round_key)
        for scope in ("encoder", "decoder"):
            for name, block in variables["params"][scope].items():
                if name.startswith("level"):
                    n = block["conv"]["bias"].shape
                    block["conv"]["bias"] = (rng.choice([-1.0, 1.0], n)
                                             * rng.uniform(0.02, 0.05, n)).astype(np.float32)
        jt.state = jt.state.replace(params=jax.tree.map(jax.numpy.asarray, variables["params"]))
        weights[round_key] = variables

    jt._build_model = jax_build_model
    _spy(jt, jlog)
    jt.initialize()
    jt.run_training()

    tt = ALTrainer(work_path=tmp_path / "torch", device="cpu", config=_config(fugc_root),
                   verbose=False)
    torch_build = tt._build_model

    def torch_build_model(round_key=0):
        torch_build(round_key)
        tt.model.load_state_dict(unet_state_dict_from_flax(weights[round_key]))

    tt._build_model = torch_build_model
    _spy(tt, tlog)
    tt.initialize()
    tt.run_training()

    assert [k[:2] for k in tlog["loss"]] == [k[:2] for k in jlog["loss"]]
    assert len(tlog["loss"]) == 6
    np.testing.assert_allclose([k[2] for k in tlog["loss"]], [k[2] for k in jlog["loss"]],
                               rtol=1e-5, atol=1e-6)
    assert len(tlog["valid"]) == len(jlog["valid"]) == 4  # 2 rounds x 1 valid x 2 cases
    for (ta, tc, tl), (ja, jc, jl) in zip(tlog["valid"], jlog["valid"]):
        for got, want in ((ta, ja), (tc, jc)):
            np.testing.assert_allclose(got[..., [0, 3]], want[..., [0, 3]], atol=1e-6, rtol=0)
            np.testing.assert_allclose(got[..., [1, 2]], want[..., [1, 2]], atol=1e-4, rtol=0)
        np.testing.assert_allclose(tl, jl, rtol=1e-5, atol=1e-6)

    for r in range(2):
        dl_t = json.loads((tt.work_path / f"round_{r}/data_list.json").read_text())
        dl_j = json.loads((jt.work_path / f"round_{r}/data_list.json").read_text())
        assert dl_t == dl_j
