"""BUSI, checkpoints and round control of ``al_train_torch`` against the JAX
package, on the CPU at narrow width.

- ``BUSIDataset`` samples equal ``mia_tpu``'s; ``process_label`` drops
  8-connected components under the size;
- ``train_entry`` with ``--dataset busi`` (one foreground class);
- ``--init-round-path`` from a ``best_model/model.msgpack`` written by
  flax: the run starts at round 1 and its model's logits equal the JAX
  model's within 1e-5 of max |logit|;
- ``--resume``: the counters (each + 1), the parameters and the optimizer's
  count and moments restored bit for bit, the data list reloaded;
- ``fugc2025_predict_torch`` reading a flax ``model.msgpack`` ``LegacyUNet``
  fold before a ``model.pth`` beside it: the class map equals the JAX model's;
- ``--persist-model-weight``: round 1 trains from round 0's best model, and
  from fresh weights after ``--init-round-path``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.data import BUSIDataset as JaxBUSI
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu_torch.data import DATASETS, BUSIDataset
from mia_tpu_torch.models import unet_state_dict_from_flax
from mia_tpu_torch.entry.activelearning.train import train_entry
from mia_tpu_torch.training import ALTrainer
from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack
from synth_data import make_busi, make_fugc

CHANNELS = (8, 16, 32)


@pytest.fixture
def narrow(monkeypatch):
    full = ALTrainer._unet_config
    monkeypatch.setattr(ALTrainer, "_unet_config",
                        lambda self: dataclasses.replace(full(self), channels_list=CHANNELS))


@pytest.fixture(scope="module")
def busi_root(tmp_path_factory):
    return make_busi(tmp_path_factory.mktemp("busi"), n=16, size=(36, 44))


@pytest.fixture(scope="module")
def fugc_root(tmp_path_factory):
    return make_fugc(tmp_path_factory.mktemp("fugc_resume"), n_train=8, n_val=2, n_test=2,
                     size=(40, 48))


def _argv(work, data, *extra, dataset="fugc", classes="2"):
    return ["--work-path", str(work), "--data-path", str(data), "--device", "cpu",
            "--dataset", dataset, "--in-channels", "3", "--num-classes", classes,
            "--image-size", "32", "--batch-size", "2", "--valid-mode", "slice",
            "--do-augment", "--do-normalize", "--budget", "2", "--num-iters", "3",
            "--valid-freq-iter", "2", "--lr-warmup-iter", "1", "--quiet", *extra]


@pytest.mark.parametrize("split", ["train", "valid", "test"])
@pytest.mark.parametrize("image_size", [None, 32])
def test_busi_samples_equal_the_jax_dataset(busi_root, split, image_size):
    want = JaxBUSI(data_path=busi_root, split=split, image_channels=3, image_size=image_size)
    got = DATASETS["busi"](data_path=busi_root, split=split, image_channels=3,
                           image_size=image_size)
    assert got.case_names() == want.case_names() and len(got) == 8
    assert got.CLASSES == want.CLASSES and got.NUM_CLASSES == 1
    for i in range(len(got)):
        g, w = got.get_sample(i), want.get_sample(i)
        assert g["case_name"] == w["case_name"]
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["label"], w["label"])
        assert [str(p) for p in got.sample_paths(i)] == [str(p) for p in want.sample_paths(i)]


def test_busi_process_label_uses_8_connectivity():
    label = np.zeros((12, 12), np.uint8)
    label[0, 0] = label[1, 1] = label[2, 2] = 1  # a diagonal of 3: one component, dropped
    label[5:9, 5:9] = 1  # 16 pixels: kept
    label[0:2, 6:9] = 1  # 6 pixels touching the next 6 at a corner: 12 together, kept
    label[2:4, 9:12] = 1
    want = label.copy()
    want[0, 0] = want[1, 1] = want[2, 2] = 0
    got = BUSIDataset.process_label(label)
    np.testing.assert_array_equal(got, want)
    assert label[0, 0] == 1  # the input is left as it was


def test_train_entry_runs_busi_on_cpu(busi_root, tmp_path, narrow):
    trainer = train_entry(_argv(tmp_path, busi_root, "--num-rounds", "2", "--active-selector",
                                "kmean-cosine", dataset="busi", classes="1"))
    work = trainer.work_path
    sizes = [len(json.loads((work / f"round_{r}/data_list.json").read_text())
                 ["labeled_image_idx"]) for r in range(2)]
    assert sizes == [2, 4]
    for r in range(2):
        assert (work / f"round_{r}/best_model/model.msgpack").is_file()
        rows = (work / f"test_mean_round_{r}.csv").read_text().splitlines()
        assert rows[0].split(",") == [f"{c}-{m}" for c in ("all", "tumor")
                                      for m in ("DSC", "HD", "ASD", "JSD")]
        assert len(rows) == 1 + 8
    assert trainer.model.decoder.seg_output.weight.shape[0] == 2


def _jax_variables(out_classes):
    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=out_classes, channels_list=CHANNELS))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    rng = np.random.default_rng(11)
    variables = jax.tree.map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32), shapes)
    for scope in ("encoder", "decoder"):
        for stats in variables["batch_stats"][scope].values():
            stats["norm"]["var"] = np.abs(stats["norm"]["var"]) + 0.5
    return jm, variables


def test_init_round_path_from_a_flax_msgpack(fugc_root, tmp_path, narrow):
    jm, variables = _jax_variables(3)
    round_0 = tmp_path / "round_0"
    (round_0 / "best_model").mkdir(parents=True)
    (round_0 / "best_model" / "model.msgpack").write_bytes(serialization.to_bytes(variables))
    names = sorted(p.stem for p in (fugc_root / "train" / "images").glob("*.png"))
    (round_0 / "data_list.json").write_text(json.dumps(
        {"labeled_image_idx": names[:2], "pool_image_idx": names[2:]}))

    x = np.random.default_rng(0).random((2, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))
    seen = []
    start = ALTrainer.on_round_start

    def on_round_start(self):
        self.model.eval()
        with torch.no_grad():
            seen.append((self.current_round, self.model(torch.from_numpy(x)).numpy()))
        return start(self)

    ALTrainer.on_round_start = on_round_start
    try:
        trainer = train_entry(_argv(tmp_path / "run", fugc_root, "--num-rounds", "2",
                                    "--active-selector", "coreset-cosine",
                                    "--init-round-path", str(round_0)))
    finally:
        ALTrainer.on_round_start = start
    assert [r for r, _ in seen] == [1]
    got = seen[0][1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    work = trainer.work_path
    assert not (work / "round_0").exists() and (work / "test_mean_round_0.csv").is_file()
    dl = json.loads((work / "round_1/data_list.json").read_text())
    assert dl["labeled_image_idx"][:2] == names[:2] and len(dl["labeled_image_idx"]) == 4
    assert (work / "round_1/best_model/model.msgpack").is_file()


def test_resume_restores_counters_parameters_and_optimizer(fugc_root, tmp_path, narrow):
    argv = _argv(tmp_path, fugc_root, "--active-selector", "margin", "--do-oversample")
    first = train_entry(argv + ["--num-rounds", "1"])
    final = first.work_path / "round_0" / "final_model"
    saved = json.loads((final / "training_state.json").read_text())
    assert saved["current_round"] == 0 and saved["current_iter"] == 3
    opt = read_flax_msgpack(final / "opt_state.msgpack")["1"]["1"]  # clip → (decay, adam, lr)
    model = unet_state_dict_from_flax(read_flax_msgpack(final / "model.msgpack"))

    config = dict(first.config._config_dict, num_rounds=2)
    trainer = ALTrainer(work_path=tmp_path, device="cpu", config=config, resume=str(final),
                        verbose=False)
    trainer.initialize()
    trainer.on_train_start()
    assert (trainer.current_round, trainer.current_iter, trainer.current_epoch) == (
        1, saved["current_iter"] + 1, saved["current_epoch"] + 1)
    assert trainer.state.step == saved["current_iter"] + 1
    assert trainer.state.optimizer.count == int(opt["count"]) == 3
    names = [n for n, _ in trainer.model.named_parameters()]
    for key in ("mu", "nu"):
        want = unet_state_dict_from_flax({"params": opt[key]})
        for n, got in zip(names, getattr(trainer.state.optimizer, key)):
            assert torch.equal(got, want[n]), n
    for k, v in trainer.model.state_dict().items():
        if not k.endswith("num_batches_tracked"):  # flax keeps no such counter
            assert torch.equal(v, model[k]), k
    assert trainer.active_dataset.data_list() == saved["data_list"]

    # through the entry: the run goes on at round 1 and adds the budget
    resumed = train_entry(argv + ["--num-rounds", "2", "--resume", str(final)])
    dl = json.loads((resumed.work_path / "round_1/data_list.json").read_text())
    assert len(dl["labeled_image_idx"]) == 4
    assert dl["labeled_image_idx"][:2] == saved["data_list"]["labeled_image_idx"]


def test_model_checkpoint_reads_pth_msgpack_and_directories(fugc_root, tmp_path, narrow):
    jm, variables = _jax_variables(3)
    trainer = ALTrainer(work_path=tmp_path, device="cpu", verbose=False, config=dict(
        dataset="fugc", data_path=str(fugc_root), in_channels=3, num_classes=2, image_size=32))
    trainer.initialize()
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "model.msgpack").write_bytes(serialization.to_bytes(variables))
    x = np.random.default_rng(1).random((1, 32, 32, 3)).astype(np.float32)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), train=False))

    def logits():
        trainer.model.eval()
        with torch.no_grad():
            return trainer.model(torch.from_numpy(x)).numpy()

    for source in (ckpt, ckpt / "model.msgpack"):
        trainer._build_model()
        trainer.load_model_checkpoint(source)
        np.testing.assert_allclose(logits(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    torch.save({"model": trainer.model.state_dict()}, tmp_path / "wrapped.pt")
    trainer._build_model()
    trainer.load_model_checkpoint(tmp_path / "wrapped.pt")
    np.testing.assert_allclose(logits(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    # a checkpoint of another width warns and leaves the weights as they were
    _, wide = _jax_variables(3)
    wide["params"]["decoder"]["seg_output"]["kernel"] = np.zeros((1, 1, 4, 3), np.float32)
    (tmp_path / "bad.msgpack").write_bytes(serialization.to_bytes(wide))
    before = logits()
    trainer.load_model_checkpoint(tmp_path / "bad.msgpack")
    np.testing.assert_array_equal(logits(), before)


def test_predict_reads_a_flax_msgpack_legacy_fold(tmp_path):
    from mia_tpu.entry.fugc2025.predict import model as JaxPredictModel
    from mia_tpu.models.legacy_unet import LegacyUNet as JaxLegacyUNet
    from mia_tpu.models.legacy_unet import LegacyUNetConfig as JaxLegacyConfig
    from mia_tpu_torch.entry.fugc2025 import predict as predict_mod
    from mia_tpu_torch.models import LegacyUNet, LegacyUNetConfig
    from mia_tpu_torch.models import legacy_unet_state_dict_from_flax

    net = JaxLegacyUNet(JaxLegacyConfig(n_channels=3, n_classes=3))
    shapes = jax.eval_shape(lambda: net.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                             train=False))
    rng = np.random.default_rng(2)
    v = jax.tree.map(lambda s: (rng.standard_normal(s.shape) / np.sqrt(
        max(1, np.prod(s.shape[:-1])))).astype(np.float32), shapes)
    v["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, v["batch_stats"])
    # standardise the head on a seeded frame so that the classes follow the image
    tnet = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3)).eval()
    v["params"]["outc"]["bias"] = np.zeros(3, np.float32)
    tnet.load_state_dict(legacy_unet_state_dict_from_flax(v))
    with torch.no_grad():
        logits = tnet(torch.from_numpy(rng.random((1, 32, 32, 3)).astype(np.float32)))
    std, mean = torch.std_mean(logits, (0, 1, 2))
    v["params"]["outc"]["kernel"] = v["params"]["outc"]["kernel"] / std.numpy()
    v["params"]["outc"]["bias"] = -(mean / std).numpy()

    fold = tmp_path / "fold_0"
    fold.mkdir()
    (fold / "model.msgpack").write_bytes(serialization.to_bytes(v))
    # a model.pth beside it is not read: model.msgpack comes first
    torch.save({k: torch.zeros_like(t) for k, t in tnet.state_dict().items()}, fold / "model.pth")

    yy, xx = np.mgrid[0:40, 0:48]
    image = (120 + 80 * np.sin(xx / 5.0)[..., None] * np.cos(yy / 7.0)[..., None]
             + rng.normal(0, 25, (40, 48, 3))).clip(0, 255).astype(np.uint8)
    jm = JaxPredictModel([32], folds=(0,))
    jm.variables = [v]
    want = jm.predict(image.transpose(2, 0, 1))
    tm = predict_mod.model([32], folds=(0,), device="cpu").load(tmp_path)
    got = tm.predict(image.transpose(2, 0, 1))
    assert got.shape == want.shape == (40, 48)
    assert len(np.unique(want)) >= 2
    assert (got != want).mean() == 0.0


@pytest.mark.parametrize("init_round", [False, True])
def test_persist_model_weight_carries_the_previous_best(fugc_root, tmp_path, narrow, init_round):
    """Round 1 trains from round 0's best model with ``--persist-model-weight``;
    after ``--init-round-path`` it starts from fresh weights, as in the JAX
    package (the loaded round 0 only scores the pool)."""
    extra = []
    if init_round:
        first = train_entry(_argv(tmp_path / "first", fugc_root, "--num-rounds", "1",
                                  "--active-selector", "confidence"))
        extra = ["--init-round-path", str(first.work_path / "round_0")]
    seen = {}
    start_loader = ALTrainer._start_round_loader

    def capture(self, data_list_path):
        seen[self.current_round] = {k: v.clone() for k, v in self.model.state_dict().items()}
        return start_loader(self, data_list_path)

    ALTrainer._start_round_loader = capture
    try:
        trainer = train_entry(_argv(tmp_path / "run", fugc_root, "--num-rounds", "2",
                                    "--active-selector", "confidence", "--persist-model-weight",
                                    *extra))
    finally:
        ALTrainer._start_round_loader = start_loader
    source = (first.work_path if init_round else trainer.work_path) / "round_0/best_model"
    best = unet_state_dict_from_flax(read_flax_msgpack(source / "model.msgpack"))
    same = all(torch.equal(seen[1][k], best[k]) for k in best
               if not k.endswith("num_batches_tracked"))
    assert sorted(seen) == ([1] if init_round else [0, 1])
    assert same is (not init_round)
