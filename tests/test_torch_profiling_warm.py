"""Trace spans, the pool-cache warmer and the loader's uint8 PIL wire, on the CPU.

- ``utils/profiling.py``: after an ``al_train_torch`` run of 2 rounds x 3
  iterations, ``phase_times()`` counts one ``train/step`` a train step, one
  ``al/select`` a round and one ``valid/step`` a validation batch; a
  ``start_profiler``/``stop_profiler`` capture of round 1's train steps
  writes a Chrome trace whose ``train/step`` ranges each enclose the step's
  convolutions; the names match the JAX package's spans.
- ``ALTrainer._warm_pool_cache``: with ``warm_pool_cache`` the pool is in
  the loader's cache before round 1's selection (and not without it), the
  picks are the same either way, and an error inside the warmer's thread
  never reaches training.
- ``data/loader.py``: with the native decoder unavailable, the batch is
  uint8 and equals ``rint(255 x`` the JAX loader's PIL float batch ``)``.
"""

import dataclasses
import json
import threading

import numpy as np
import pytest

import mia_tpu.native as jax_native
from mia_tpu.data import BatchLoader as JaxBatchLoader, FUGCDataset as JaxFUGCDataset
from mia_tpu_torch import native
from mia_tpu_torch.data import BatchLoader, FUGCDataset
from mia_tpu_torch.data import loader as loader_module
from mia_tpu_torch.entry.activelearning.train import train_entry
from mia_tpu_torch.training import ALTrainer
from mia_tpu_torch.utils import profiling
from synth_data import make_fugc

ITERS = 3


@pytest.fixture(scope="module")
def fugc_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("fugc_warm")
    make_fugc(root, n_train=10, n_val=2, n_test=2, size=(40, 48))
    return root


def _narrow(monkeypatch):
    full = ALTrainer._unet_config
    monkeypatch.setattr(ALTrainer, "_unet_config",
                        lambda self: dataclasses.replace(full(self), channels_list=(8, 16, 32)))


@pytest.fixture(autouse=True)
def narrow(monkeypatch):
    _narrow(monkeypatch)


def _run(root, work, monkeypatch, warm=True, **hooks):
    """``train_entry`` of a 2-round run; ``hooks`` wrap ALTrainer methods
    (``name=lambda orig: method``); returns the trainer and the number of
    pool samples in the decode cache when round 1's selection began."""
    seen = {}

    def round_start(orig):
        def start(self):
            if self.current_round == 1:
                thread = getattr(self, "_pool_warm_thread", None)
                if thread is not None:
                    thread.join(timeout=60)
                    assert not thread.is_alive()
                pool = self.active_dataset.pool_dataset
                cache = getattr(pool.dataset, "_decoded_cache", {})
                seen["cached"] = sum(pool.case_name_to_idx[pool.image_idx[i]] in cache
                                     for i in range(len(pool)))
                seen["pool"] = len(pool)
            return orig(self)
        return start

    def warm_switch(orig):
        def warm_pool_cache(self):
            self.config.warm_pool_cache = warm
            return orig(self)
        return warm_pool_cache

    for name, wrap in {"on_round_start": round_start, "_warm_pool_cache": warm_switch,
                       **hooks}.items():
        monkeypatch.setattr(ALTrainer, name, wrap(getattr(ALTrainer, name)))
    trainer = train_entry([
        "--work-path", str(work), "--data-path", str(root), "--device", "cpu",
        "--dataset", "fugc", "--in-channels", "3", "--num-classes", "2",
        "--image-size", "32", "--batch-size", "2", "--valid-mode", "slice",
        "--active-selector", "entropy", "--do-normalize",
        "--num-rounds", "2", "--budget", "2", "--num-iters", str(ITERS),
        "--valid-freq-iter", "2", "--lr-warmup-iter", "1", "--quiet",
    ])
    return trainer, seen


def _picks(trainer):
    return json.loads((trainer.work_path / "round_1/data_list.json").read_text())


def test_spans_and_a_profiler_capture_of_round_1(fugc_root, tmp_path, monkeypatch):
    valid_calls, trace = [], {}

    def valid_step(orig):
        def step(self, batch):
            valid_calls.append(1)
            return orig(self, batch)
        return step

    def train_step(orig):
        def step(self, batch):
            if self.current_round == 1 and self.current_iter == 0:
                profiling.start_profiler(tmp_path / "trace")
            orig(self, batch)
            if self.current_round == 1 and self.current_iter == ITERS:
                trace["path"] = profiling.stop_profiler()
        return step

    profiling.reset_phase_times()
    _run(fugc_root, tmp_path / "work", monkeypatch, valid_step=valid_step, train_step=train_step)
    times = profiling.phase_times()
    assert {name: t["count"] for name, t in times.items()} == {
        "al/select": 2, "train/step": 2 * ITERS, "valid/step": len(valid_calls)}
    assert len(valid_calls) > 0
    for t in times.values():
        assert t["total_s"] > 0 and t["mean_s"] == pytest.approx(t["total_s"] / t["count"])
    profiling.reset_phase_times()
    assert profiling.phase_times() == {}

    assert trace["path"].parent == tmp_path / "trace" and trace["path"].name.endswith(
        ".pt.trace.json")
    events = json.loads(trace["path"].read_text())["traceEvents"]
    spans = [e for e in events if e.get("name") == "train/step" and e.get("ph") == "X"]
    convs = [e for e in events if e.get("name") == "aten::convolution" and e.get("ph") == "X"]
    assert len(spans) == ITERS
    for span in spans:
        start, end = span["ts"], span["ts"] + span["dur"]
        assert any(start <= c["ts"] and c["ts"] + c["dur"] <= end for c in convs)
    # the capture began after round 1's selection
    assert not any(e.get("name") == "al/select" for e in events)


def test_profiler_refuses_a_second_capture(tmp_path):
    profiling.start_profiler(tmp_path)
    try:
        with pytest.raises(RuntimeError):
            profiling.start_profiler(tmp_path)
    finally:
        profiling.stop_profiler()
    with pytest.raises(RuntimeError):
        profiling.stop_profiler()


def test_warmer_fills_the_pool_cache_and_keeps_the_picks(fugc_root, tmp_path, monkeypatch):
    warm, seen_warm = _run(fugc_root, tmp_path / "on", monkeypatch, warm=True)
    monkeypatch.undo()  # the first run's hooks
    _narrow(monkeypatch)
    cold, seen_cold = _run(fugc_root, tmp_path / "off", monkeypatch, warm=False)
    # round 1's pool: the 10 cases less round 0's budget of 2
    assert seen_warm == {"cached": 8, "pool": 8}
    assert seen_cold == {"cached": 0, "pool": 8}
    assert _picks(warm) == _picks(cold)


def test_warmer_errors_never_reach_training(fugc_root, tmp_path, monkeypatch):
    decode, failed = loader_module._decode, []

    def flaky(base, indices):
        if threading.current_thread().name == "pool-cache-warmer":
            failed.append(indices)
            raise RuntimeError("decode failed in the warmer")
        return decode(base, indices)

    monkeypatch.setattr(loader_module, "_decode", flaky)
    trainer, seen = _run(fugc_root, tmp_path / "work", monkeypatch)
    assert failed and seen["cached"] == 0
    assert (trainer.work_path / "round_1/final_model/model.msgpack").is_file()


def test_pil_wire_ships_uint8_equal_to_the_jax_float_batch(fugc_root, monkeypatch):
    monkeypatch.setattr(native, "_load", lambda: (None, "g++ failed: png.h missing"))
    monkeypatch.setattr(jax_native, "is_available", lambda: False)
    got = next(iter(BatchLoader(FUGCDataset(fugc_root, split="train", image_size=32),
                                batch_size=4, shuffle=False, num_prefetch=0)))
    want = next(iter(JaxBatchLoader(JaxFUGCDataset(fugc_root, split="train", image_size=32),
                                    batch_size=4, shuffle=False, device_put=False,
                                    num_prefetch=0)))
    assert want["image"].dtype == np.float32 and got["image"].dtype == np.uint8
    np.testing.assert_array_equal(got["image"], np.rint(want["image"] * 255.0).astype(np.uint8))
    np.testing.assert_array_equal(got["label"], want["label"])
    assert got["case_name"] == want["case_name"]
