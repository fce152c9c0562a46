"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
never runs on the CPU unless asked to, never counts a kernel launch on
CPU tensors, and names the host decode path it takes."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mia_tpu_torch import native
from mia_tpu_torch.data import BatchLoader, FUGCDataset, decode_path
from mia_tpu_torch.device import resolve_device
from mia_tpu_torch.entry.activelearning.train import parse_args, train_entry
from mia_tpu_torch.ops.warp import affine_warp_shift2pass_fused

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
from synth_data import make_fugc  # noqa: E402


def test_port_imports_neither_jax_nor_mia_tpu(tmp_path):
    # the pytest process has JAX from conftest.py, hence a fresh interpreter,
    # which also drives two tiny AL rounds through the entry point
    code = f"""
import dataclasses, sys
sys.path.insert(0, "tests")
from synth_data import make_fugc
from mia_tpu_torch.entry.activelearning.train import train_entry
from mia_tpu_torch.training import ALTrainer
full = ALTrainer._unet_config
ALTrainer._unet_config = lambda self: dataclasses.replace(full(self), channels_list=(4, 8))
make_fugc(__import__("pathlib").Path({str(tmp_path)!r}) / "data", n_train=4, n_val=1, n_test=1,
          size=(32, 32))
train_entry(["--work-path", {str(tmp_path)!r}, "--data-path", {str(tmp_path / "data")!r},
             "--device", "cpu", "--dataset", "fugc", "--in-channels", "3",
             "--num-classes", "2", "--image-size", "32", "--batch-size", "2",
             "--num-rounds", "2", "--budget", "2", "--num-iters", "2",
             "--valid-freq-iter", "1", "--active-selector", "entropy",
             "--do-augment", "--do-normalize", "--quiet"])
bad = sorted(m for m in sys.modules
             if m in ("jax", "mia_tpu") or m.startswith(("jax.", "flax", "optax", "mia_tpu.")))
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "ok"


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    assert parse_args(["--data-path", "x"]).device == "cuda"  # the default
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_entry(["--data-path", str(tmp_path), "--work-path", str(tmp_path),
                     "--dataset", "fugc"])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")


def test_k1_counter_stays_zero_on_cpu_tensors():
    img = torch.rand(3, 24, 24, 4)
    mats = torch.tensor([[1.0, 0.0, 2.0], [0.0, 1.0, -1.0]]).expand(3, 2, 3)
    out = affine_warp_shift2pass_fused(img, mats)
    assert out.shape == img.shape
    assert affine_warp_shift2pass_fused.launches == 0


@pytest.mark.parametrize("native_builds", [True, False])
def test_decode_path_is_named_and_matches_the_batches(tmp_path, monkeypatch, native_builds):
    if native_builds and not native.is_available():
        pytest.skip(f"native decoder does not build here: {native.unavailable_reason()}")
    if not native_builds:
        monkeypatch.setattr(native, "_load", lambda: (None, "g++ failed: png.h missing"))
    make_fugc(tmp_path, n_train=4, size=(40, 48))
    ds = FUGCDataset(tmp_path, split="train", image_size=32)
    batch = next(iter(BatchLoader(ds, batch_size=2, shuffle=False, num_prefetch=0)))
    if native_builds:
        assert decode_path().startswith("native")
        assert batch["image"].dtype == np.uint8
    else:
        assert decode_path().startswith("PIL") and "png.h missing" in decode_path()
        assert batch["image"].dtype == np.float32
    assert batch["image"].shape == (2, 32, 32, 3)
