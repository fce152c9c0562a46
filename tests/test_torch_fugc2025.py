"""The FUGC K-fold trainers and tools of the port against ``mia_tpu``
(the ensemble predictor is in ``test_torch_fugc2025_predict.py``).

- ``UNetTrainer``/``SemiTrainer``: the splits equal the JAX trainers' for one
  seed (both draw one numpy permutation); two folds run on ``make_fugc`` through
  ``fugc2025_train_torch`` on the CPU and leave the JAX package's files
  (``fold_<i>/model.msgpack``).
- the RLE tools: the JAX package's round trip, and equal codes.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from mia_tpu.tools import encode_rle as jax_encode_rle
from mia_tpu.training.unet_trainer import SemiTrainer as JaxSemiTrainer
from mia_tpu.training.unet_trainer import UNetTrainer as JaxUNetTrainer

import torch

from mia_tpu_torch.entry.fugc2025 import predict as predict_mod
from mia_tpu_torch.entry.fugc2025 import train as train_mod
from mia_tpu_torch.entry.fugc2025.preprocess.mask2rle import mask2rle_entry
from mia_tpu_torch.entry.fugc2025.preprocess.rle2mask import rle2mask_entry
from mia_tpu_torch.tools import decode_rle, encode_rle
from mia_tpu_torch.training import ALTrainer, SemiTrainer, UNetTrainer

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth_data import make_fugc  # noqa: E402


@pytest.fixture
def narrow_unet(monkeypatch):
    full = ALTrainer._unet_config
    monkeypatch.setattr(ALTrainer, "_unet_config",
                        lambda self: dataclasses.replace(full(self), channels_list=(4, 8)))


def _config(data, **over):
    return {**dict(seed=5, dataset="fugc", data_path=str(data), in_channels=3, num_classes=2,
                   image_size=32, batch_size=2, valid_mode="slice", valid_freq_iter=1,
                   lr_warmup_iter=1, do_augment=False, do_normalize=True, dropout_prob=0.0), **over}


def test_splits_equal_the_jax_trainers(tmp_path):
    names = [f"case_{i:02d}" for i in range(23)]
    for seed in (5, 1337):
        cfg = dict(seed=seed, dataset="fugc", data_path=str(tmp_path))
        kw = dict(num_folds=5, valid_rate=0.2)
        want = JaxUNetTrainer(work_path=tmp_path / "j", config=dict(cfg), verbose=False,
                              **kw)._get_split_dicts(names)
        trainer = UNetTrainer(work_path=tmp_path / "t", device="cpu", config=dict(cfg), **kw)
        got = trainer._get_split_dicts(names)
        assert got == want and len(got) == 5
        for split in got:
            trainer._assert_no_data_leak(split)
            assert len(split["valid"]) == 4 and len(split["train"]) == 19
        kw = dict(labeled_ratio=0.25, valid_rate=0.2)
        want = JaxSemiTrainer(work_path=tmp_path / "j", config=dict(cfg), verbose=False,
                              **kw).get_random_split_dict(names)
        got = SemiTrainer(work_path=tmp_path / "t", device="cpu", config=dict(cfg),
                          **kw).get_random_split_dict(names)
        assert got == want and len(got["labeled"]) == 4
    with pytest.raises(AssertionError, match="data leak"):
        UNetTrainer._assert_no_data_leak({"train": ["a", "b"], "valid": ["b"]})
    given = [{"train": ["a"], "valid": ["b"]}]
    assert UNetTrainer(work_path=tmp_path / "t", device="cpu", config=dict(cfg),
                       split_dicts=given)._get_split_dicts(names) is given


def test_train_entry_runs_two_folds_on_cpu(tmp_path, narrow_unet, monkeypatch):
    make_fugc(tmp_path / "data", n_train=10, size=(32, 32))
    starts = []
    on_round_start = UNetTrainer.on_round_start

    def watched(self):
        self.state.optimizer.count = 7  # must be reset at the fold's start
        on_round_start(self)
        starts.append((self._fold_index, self.state.optimizer.count, self.state.step,
                       self.config.num_iters, id(self.model),
                       sorted(self.active_dataset.labeled_dataset.image_idx),
                       sorted(self.valid_dataset.image_idx)))

    monkeypatch.setattr(UNetTrainer, "on_round_start", watched)
    trainer = train_mod.train_entry([
        "--work-dir", str(tmp_path / "work"), "--data-dir", str(tmp_path / "data"),
        "--device", "cpu", "--seed", "5", "--num-folds", "2", "--num-epochs", "2",
        "--batch-size", "2", "--image-size", "32", "--valid-freq-iter", "2",
        "--weight-decay", "0.1", "--no-augment"])
    assert isinstance(trainer, UNetTrainer) and trainer.config.active_learning is False
    assert trainer.config.optimizer_kwargs == {"weight_decay": 0.1}
    assert trainer.state.optimizer.weight_decay == 0.1 and not trainer.state.optimizer.decoupled
    work = trainer.work_path
    assert work.parent == tmp_path / "work"  # the fold loop restored the root work path
    # two folds, fresh weights each, the step count reset, num_epochs → num_iters
    assert [s[0] for s in starts] == [0, 1] and starts[0][4] != starts[1][4]
    assert all(s[1] == 0 and s[2] == 0 and s[3] == 2 * (8 // 2) for s in starts)
    splits = trainer._get_split_dicts(trainer.get_dataset("train").case_names())
    for fold, (_, _, _, _, _, labeled, valid) in enumerate(starts):
        assert labeled == sorted(splits[fold]["train"]) and valid == sorted(splits[fold]["valid"])
        assert not set(labeled) & set(valid) and len(valid) == 2
        base = work / f"fold_{fold}"
        for rel in ("model.msgpack", "round_0/best_model/model.msgpack",
                    "round_0/final_model/model.msgpack",
                    "round_0/data_list.json", "test_mean_round_0.csv"):
            assert (base / rel).is_file(), rel
        assert (base / "model.msgpack").read_bytes() == (
            base / "round_0/best_model/model.msgpack").read_bytes()
        listed = json.loads((base / "round_0/data_list.json").read_text())
        assert sorted(listed["labeled_image_idx"]) == labeled and listed["pool_image_idx"] == []
    assert trainer.current_iter == 8 and trainer.state.optimizer.count == 8

    # the reference's mismatch: the folds hold the 32..512 UNet, predict wants a LegacyUNet
    with pytest.raises(ValueError, match="not a state dict of LegacyUNet"):
        predict_mod.model(folds=[0], device="cpu").load(work)


def test_semi_trainer_and_postprocess_mask_on_cpu(tmp_path, narrow_unet, monkeypatch):
    from mia_tpu_torch.models import UnetProcessor

    make_fugc(tmp_path / "data", n_train=10, size=(32, 32))
    calls = []
    denoise = UnetProcessor.denoise_one_mask

    def watched(self, mask):
        out = denoise(self, mask)
        calls.append((tuple(mask.shape), mask.dtype, int((out != mask).sum())))
        return out

    monkeypatch.setattr(UnetProcessor, "denoise_one_mask", watched)
    trainer = SemiTrainer(
        work_path=tmp_path / "work", device="cpu", verbose=False, labeled_ratio=0.25, valid_rate=0.2,
        config=_config(tmp_path / "data", num_iters=2, valid_freq_iter=2, do_oversample=True,
                       postprocess_mask=True))
    trainer.initialize()
    trainer.run_training()
    split = trainer.split_dict
    assert (len(split["valid"]), len(split["labeled"]), len(split["unlabeled"])) == (2, 2, 6)
    assert (trainer.work_path / "round_0/final_model/model.msgpack").is_file()
    listed = json.loads((trainer.work_path / "round_0/data_list.json").read_text())
    assert sorted(listed["labeled_image_idx"]) == sorted(split["labeled"])
    assert sorted(listed["pool_image_idx"]) == sorted(split["unlabeled"])
    # every validated and tested slice went through the denoise at its own size
    assert len(calls) == 2 + 2 and all(c[0] == (1, 40, 48) or c[0] == (1, 32, 32) for c in calls)
    assert any(c[2] > 0 for c in calls)


def test_entries_default_to_cuda_and_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    assert train_mod.parse_args(["--data-dir", "x"]).device == "cuda"
    assert predict_mod.parse_args(["--images", "x"]).device == "cuda"
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_mod.train_entry(["--data-dir", str(tmp_path), "--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict_mod.predict_entry(["--images", str(tmp_path), "--run-model",
                                   "--work-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="--device cpu"):
        predict_mod.model()
    args = train_mod.parse_args(["--data-dir", "x"])
    assert (args.num_folds, args.num_epochs, args.batch_size, args.optimizer, args.weight_decay,
            args.valid_rate, args.seed) == (5, 1000, 32, "adam", 0.1, 0.2, 1337)


def test_rle_tools_round_trip_and_codec_equals_the_jax_package(tmp_path):
    rng = np.random.default_rng(7)
    for size in (1, 7, 64, 1000):
        arr = (rng.integers(0, 2, size) * 255).astype(np.uint8)
        code = encode_rle(arr)
        assert code == jax_encode_rle(arr) and np.array_equal(decode_rle(code), arr)
    image_dir, label_dir = tmp_path / "images", tmp_path / "labels"
    image_dir.mkdir()
    label_dir.mkdir()
    mask = np.zeros((20, 24), np.uint8)
    mask[4:12, 6:14] = 1
    mask[14:18, 2:8] = 2
    Image.fromarray((rng.random((20, 24)) * 255).astype(np.uint8)).save(
        image_dir / "labeled_data_000.png")
    Image.fromarray(mask).save(label_dir / "labeled_data_000.png")
    mask2rle_entry(["--image-dir", str(image_dir), "--label-dir", str(label_dir),
                    "--unlabel-dir", str(label_dir), "--output-path", str(tmp_path / "project.json")])
    data = json.loads((tmp_path / "project.json").read_text())
    assert len(data) == 1 and data[0]["data"]["type"] == "labeled"
    assert len(data[0]["predictions"][0]["result"]) == 2
    for task in data:  # feed back as annotations (the reference's width/height swap undone)
        task["annotations"] = task.pop("predictions")
        for res in task["annotations"][0]["result"]:
            res["original_width"], res["original_height"] = 24, 20
    (tmp_path / "annotated.json").write_text(json.dumps(data))
    rle2mask_entry(["--image-dir", str(image_dir), "--label-dir", str(tmp_path / "empty"),
                    "--mask-file", str(tmp_path / "annotated.json"),
                    "--save-dir", str(tmp_path / "out"), "--threshold", "2"])
    back = np.array(Image.open(tmp_path / "out" / "labels" / "labeled_data_000.png"))
    assert np.array_equal(back, mask)
    assert (tmp_path / "out" / "visualized" / "labeled_data_000.png").is_file()
