"""``al_train``'s ACDC and thyroid path in the PyTorch port, on the CPU.

- Volume-mode validation and test: the port's ``_eval_batch`` on an ACDC
  volume ``(1, D, H, W, C)`` against the JAX trainer's, with the same
  narrow UNet weights through the bridge and raw spacings with three
  distinct values per case (so a mixed-up axis shows): one row per volume,
  DSC and JC equal, HD and ASD within 1e-5 relative, the loss within 1e-5;
  with ``--postprocess-mask`` too. ``perform_real_test`` writes the JAX
  trainer's ``test_mean_round_0.csv``: the same header (RV/Myo/LV) and rows.
- ``al_train_torch``'s ``train_entry`` on ACDC with the default
  ``--valid-mode volumn``, and on TN3K and TG3K with ``--block-type res
  --block-normalization instance --deep-supervision``: rounds, validation,
  selection and the real test run; the test CSV's header is the JAX
  trainer's for the same dataset.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax

from mia_tpu.training import ALTrainer as JaxALTrainer
from mia_tpu_torch.data import ACDCDataset, collate
from mia_tpu_torch.entry.activelearning.train import train_entry
from mia_tpu_torch.models import unet_state_dict_from_flax
from mia_tpu_torch.ops.warp import affine_warp_shift2pass_fused
from mia_tpu_torch.training import ALTrainer
from synth_data import make_acdc, make_tn3k

CHANNELS = (8, 16, 32)
# (z, y, x) raw spacings: three distinct values, different per case
SPACINGS = {"patient100_frame01": (5.0, 1.25, 1.75), "patient101_frame01": (7.5, 1.5, 0.875)}


@pytest.fixture(scope="module")
def acdc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc_volume")
    make_acdc(root, n_slices=10, n_vols=2, size=(36, 44), depth=5)
    rows = ["case,sz,sy,sx"]
    rows += [f"patient{i:03d}_frame01,6.0,1.4,1.6" for i in range(10)]
    rows += [f"{case},{','.join(map(str, sp))}" for case, sp in SPACINGS.items()]
    (root / "ACDC" / "raw_spacing.csv").write_text("\n".join(rows) + "\n")
    return root


def _narrow(trainer_cls, monkeypatch, channels=CHANNELS):
    full = trainer_cls._unet_config
    monkeypatch.setattr(trainer_cls, "_unet_config",
                        lambda self: dataclasses.replace(full(self), channels_list=channels))


def _config(root, **over):
    base = dict(seed=3, dataset="ACDC", data_path=str(root), in_channels=1, num_classes=3,
                image_size=32, valid_batch_size=1, valid_mode="volumn", do_normalize=True,
                dropout_prob=0.0, num_rounds=1, budget=4, num_iters=2)
    base.update(over)
    return base


def _assert_metrics(got, want):
    """metric rows (..., 4) of (DSC, HD, ASD, JC): DSC/JC equal, HD/ASD
    within 1e-5 relative (NaN where JAX has NaN)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 3]], want[..., [0, 3]])
    np.testing.assert_allclose(got[..., [1, 2]], want[..., [1, 2]], rtol=1e-5, atol=0)


@pytest.mark.parametrize("postprocess", [False, True], ids=["plain", "postprocess"])
def test_volume_eval_and_test_csv_match_jax(acdc_root, tmp_path, monkeypatch, postprocess):
    _narrow(JaxALTrainer, monkeypatch)
    _narrow(ALTrainer, monkeypatch)
    config = _config(acdc_root, postprocess_mask=postprocess)
    jt = JaxALTrainer(work_path=tmp_path / "jax", config=config, verbose=False)
    jt.initialize()
    variables = jax.tree.map(np.array, {"params": jt.state.params,
                                        "batch_stats": jt.state.batch_stats})
    tt = ALTrainer(work_path=tmp_path / "torch", device="cpu", config=config, verbose=False)
    tt.initialize()
    tt.model.load_state_dict(unet_state_dict_from_flax(variables))
    jt._setup_loss()
    jt._make_programs()
    tt._setup_loss()

    valid = ACDCDataset(acdc_root, split="valid", image_channels=1)
    finite = 0
    for i, case in enumerate(valid.samples_list):
        batch = collate([valid.get_sample(i)])
        assert batch["image"].shape == (1, 5, 36, 44, 1)
        np.testing.assert_array_equal(batch["spacing"][0], SPACINGS[case])
        j_all, j_cls, j_loss = jt._eval_batch(batch)
        t_all, t_cls, t_loss = tt._finalize_eval(*tt._eval_batch(batch))
        assert t_all.shape == (1, 4) and t_cls.shape == (1, 3, 4)  # one row per volume
        _assert_metrics(t_all, j_all)
        _assert_metrics(t_cls, j_cls)
        np.testing.assert_allclose(t_loss, j_loss, rtol=1e-5, atol=1e-6)
        finite += int(np.isfinite(t_cls[..., 1]).sum())
    assert finite >= 2  # HD actually compared on several classes

    jt.perform_real_test()
    tt.perform_real_test()
    j_rows = (jt.work_path / "test_mean_round_0.csv").read_text().splitlines()
    t_rows = (tt.work_path / "test_mean_round_0.csv").read_text().splitlines()
    assert t_rows[0] == j_rows[0]
    assert t_rows[0].split(",")[4:8] == ["RV-DSC", "RV-HD", "RV-ASD", "RV-JSD"]
    assert len(t_rows) == len(j_rows) == 3  # a row per test volume
    got = np.array([r.split(",") for r in t_rows[1:]], np.float64).reshape(2, 4, 4)
    want = np.array([r.split(",") for r in j_rows[1:]], np.float64).reshape(2, 4, 4)
    _assert_metrics(got, want)


def test_volume_batch_needs_the_volume_mode(acdc_root, tmp_path, monkeypatch):
    _narrow(ALTrainer, monkeypatch)
    tt = ALTrainer(work_path=tmp_path, device="cpu",
                   config=_config(acdc_root, valid_mode="slice"), verbose=False)
    tt.initialize()
    tt._setup_loss()
    batch = collate([ACDCDataset(acdc_root, split="valid", image_channels=1).get_sample(0)])
    with pytest.raises(ValueError, match="volumn"):
        tt._eval_batch(batch)


def _jax_test_header(root, tmp_path, monkeypatch, **over):
    _narrow(JaxALTrainer, monkeypatch)
    jt = JaxALTrainer(work_path=tmp_path / "jax", config=_config(root, **over), verbose=False)
    jt.initialize()
    jt.perform_real_test()
    return (jt.work_path / "test_mean_round_0.csv").read_text().splitlines()[0]


def test_acdc_entry_runs_rounds_in_volume_mode(acdc_root, tmp_path, monkeypatch):
    _narrow(ALTrainer, monkeypatch)
    trainer = train_entry([
        "--work-path", str(tmp_path / "torch"), "--data-path", str(acdc_root), "--device", "cpu",
        "--image-size", "32", "--batch-size", "2", "--do-augment", "--do-normalize",
        "--active-selector", "entropy", "--num-rounds", "2", "--budget", "2",
        "--num-iters", "3", "--valid-freq-iter", "2", "--lr-warmup-iter", "1", "--quiet",
    ])
    assert trainer.config.dataset == "ACDC" and trainer.config.valid_mode == "volumn"
    work = trainer.work_path
    for r in range(2):
        for rel in ("data_list.json", "best_model/model.msgpack", "final_model/model.msgpack",
                    "final_model/opt_state.msgpack"):
            assert (work / f"round_{r}" / rel).is_file(), rel
    sizes = [len(json.loads((work / f"round_{r}/data_list.json").read_text())
                 ["labeled_image_idx"]) for r in range(2)]
    assert sizes == [2, 4]
    log = (work / "log.txt").read_text()
    assert "RandomRotation90" in log and "Valid results" in log
    rows = (work / "test_mean_round_1.csv").read_text().splitlines()
    assert len(rows) == 3 and np.isfinite(float(rows[1].split(",")[4]))
    assert affine_warp_shift2pass_fused.launches == 0
    assert rows[0] == _jax_test_header(acdc_root, tmp_path, monkeypatch)


@pytest.fixture(scope="module")
def thyroid_roots(tmp_path_factory):
    tn3k = make_tn3k(tmp_path_factory.mktemp("tn3k"), n=12, size=(32, 40))
    tg3k = tmp_path_factory.mktemp("tg3k")
    write_tg3k(tg3k, n=12, size=(32, 40))
    return {"tn3k": tn3k, "tg3k": tg3k}


def write_tg3k(root, n, size, seed=0):
    """TG3K layout: ``thyroid-{image,mask}/%04d.jpg`` and one split file."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for d in ("thyroid-image", "thyroid-mask"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, size).astype(np.uint8)).save(
            root / "thyroid-image" / f"{i:04}.jpg")
        Image.fromarray((rng.integers(0, 2, size) * 255).astype(np.uint8)).save(
            root / "thyroid-mask" / f"{i:04}.jpg")
    (root / "tg3k-trainval.json").write_text(
        json.dumps({"train": list(range(n // 2)), "val": list(range(n // 2, n))}))
    return root


@pytest.mark.parametrize("dataset", ["tn3k", "tg3k"])
def test_thyroid_entry_runs_every_unet_option(thyroid_roots, tmp_path, monkeypatch, dataset):
    _narrow(ALTrainer, monkeypatch, channels=(8, 16, 32, 64))
    root = thyroid_roots[dataset]
    trainer = train_entry([
        "--work-path", str(tmp_path / "torch"), "--data-path", str(root), "--device", "cpu",
        "--dataset", dataset, "--num-classes", "1", "--image-size", "32", "--batch-size", "2",
        "--do-augment", "--num-rounds", "1", "--budget", "2", "--num-iters", "3",
        "--valid-freq-iter", "2", "--lr-warmup-iter", "1", "--block-type", "res",
        "--block-normalization", "instance", "--deep-supervision", "--ds-layer", "3",
        "--optimizer", "adamw", "--quiet",
    ])
    state = trainer.model.state_dict()
    assert any(".downsample_skip." in k for k in state)
    assert [k for k in state if ".ds." in k] == ["decoder.ds.0.0.weight", "decoder.ds.0.0.bias",
                                                  "decoder.ds.1.0.weight", "decoder.ds.1.0.bias"]
    assert not any("running_mean" in k for k in state)
    header = (trainer.work_path / "test_mean_round_0.csv").read_text().splitlines()[0]
    assert header == _jax_test_header(root, tmp_path, monkeypatch, dataset=dataset,
                                      num_classes=1, in_channels=1)
    assert header.split(",")[4:] == ["thyroid-DSC", "thyroid-HD", "thyroid-ASD", "thyroid-JSD"]
