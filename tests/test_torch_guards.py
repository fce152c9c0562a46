"""Guards of the PyTorch port: it imports neither JAX nor the JAX package,
never runs on the CPU unless asked to, never counts a kernel launch on
CPU tensors (forward, backward or K5), never launches a kernel on one,
refuses a head dim its attention kernels are not built for and encoder
options that contradict each other, and names the host decode path it
takes."""

import os
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
from mia_tpu_torch.ops import attention, ln_window, morphology, unpartition_residual
from mia_tpu_torch.ops.warp import _launch_k1, affine_warp_shift2pass_fused

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests"))
from synth_data import make_fugc  # noqa: E402

# Every pytest-xdist worker imports this file when it collects. Several workers, each with
# one intra-op thread per core, spend most of their time spinning at OpenMP barriers (a file
# that takes 140 s alone took 1030 s beside five other workers): two threads a worker.
if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(2)


def test_port_imports_neither_jax_nor_mia_tpu(tmp_path):
    # the pytest process has JAX from conftest.py, hence a fresh interpreter,
    # which imports every module of the port, drives two tiny AL rounds and
    # a tiny CPC-SAM run (one phase-1 and one phase-2 step) through their
    # entry points, a second CPC-SAM run with the contrastive loss, VAT and
    # --resume (the feature memory, both losses and the checkpoint reader),
    # serves a tiny SAM on the CPU, generates masks automatically and embeds
    # through every route of the encoder, then trains two FUGC folds and runs
    # the fold ensemble with its denoise
    code = f"""
import dataclasses, importlib, pkgutil, sys
import numpy as np
sys.path.insert(0, "tests")
import mia_tpu_torch
for info in pkgutil.walk_packages(mia_tpu_torch.__path__, "mia_tpu_torch."):
    importlib.import_module(info.name)
from synth_data import make_acdc, make_fugc
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
from mia_tpu_torch.entry.cpcsam.train import train_entry as cpcsam_entry
from mia_tpu_torch.models.sam import build_sam
from mia_tpu_torch.training import cpcsam_trainer
build_sam._VIT_SPECS["vit_b"] = dict(embed_dim=32, depth=2, num_heads=2, global_idx=(1,))
cpcsam_trainer.PATIENTS_TO_SLICES["ACDC"]["1"] = 2
acdc = __import__("pathlib").Path({str(tmp_path)!r}) / "acdc"
make_acdc(acdc, n_slices=4, n_vols=1, size=(64, 64), depth=2)
cpc = cpcsam_entry(["--work-path", {str(tmp_path / "cpc")!r}, "--data-path", str(acdc),
                    "--device", "cpu", "--image-size", "64", "--batch-size", "2",
                    "--lora-rank", "2", "--warmup-iter", "1", "--min-iter", "2",
                    "--max-iter", "2", "--valid-freq-iter", "2", "--quiet"])
assert (cpc.work_path / "test_mean.csv").is_file()
aux = cpcsam_entry(["--work-path", {str(tmp_path / "aux")!r}, "--data-path", str(acdc),
                    "--device", "cpu", "--image-size", "64", "--batch-size", "2",
                    "--lora-rank", "2", "--warmup-iter", "1", "--min-iter", "2",
                    "--max-iter", "2", "--valid-freq-iter", "2", "--quiet",
                    "--use-contrastive-loss", "--use-adv-loss",
                    "--resume", str(cpc.work_path / "final_model")])
assert aux.current_iter == 2 and aux.memory is not None
from mia_tpu_torch.models.sam import Sam, SamPredictor
predictor = SamPredictor(Sam(img_size=64, num_classes=3, encoder_embed_dim=32, encoder_depth=2,
                             encoder_num_heads=2, encoder_global_attn_indexes=(1,)), max_points=4)
predictor.set_image((np.random.default_rng(0).random((48, 56, 3)) * 255).astype(np.uint8))
masks, iou, low_res = predictor.predict(point_coords=np.array([[20.0, 30.0]]),
                                        point_labels=np.array([1]))
assert masks.shape == (3, 48, 56) and iou.shape == (3,) and low_res.shape == (3, 16, 16)
from mia_tpu_torch.models.sam import ImageEncoderViT, SamAutomaticMaskGenerator
records = SamAutomaticMaskGenerator(predictor, points_per_side=2, points_per_batch=3,
                                    pred_iou_thresh=-1e9, stability_score_thresh=-1.0).generate(
    (np.random.default_rng(1).random((48, 56, 3)) * 255).astype(np.uint8))
assert records and set(records[0]) == {{"segmentation", "rle", "area", "bbox", "predicted_iou"}}
import torch
for options in (dict(fuse_unpart_residual="always"), dict(attn_route="head_major"),
                dict(fuse_ln_window="never", attn_route="grid_native"), dict(use_rel_pos=False)):
    enc = ImageEncoderViT(img_size=40, patch_size=4, embed_dim=16, depth=2, num_heads=2,
                          window_size=4, global_attn_indexes=(1,), **options)
    with torch.no_grad():
        assert enc(torch.zeros(1, 40, 40, 3)).shape == (1, 10, 10, 256)
from mia_tpu_torch.entry.fugc2025.predict import model as predict_model, predict_entry
from mia_tpu_torch.entry.fugc2025.train import train_entry as fugc_entry
from mia_tpu_torch.models import LegacyUNet, LegacyUNetConfig
fugc = fugc_entry(["--work-dir", {str(tmp_path / "fugc")!r}, "--data-dir", {str(tmp_path / "data")!r},
                   "--device", "cpu", "--num-folds", "2", "--num-epochs", "1", "--batch-size", "2",
                   "--image-size", "32", "--valid-freq-iter", "1"])
assert (fugc.work_path / "fold_1" / "model.msgpack").is_file()
ensemble = predict_model([32], folds=[0, 1], device="cpu")
ensemble.net_config = LegacyUNetConfig(width=4)
for fold in (0, 1):
    torch.manual_seed(fold)
    (fugc.work_path / f"legacy/fold_{{fold}}").mkdir(parents=True)
    torch.save(LegacyUNet(ensemble.net_config).state_dict(),
               fugc.work_path / f"legacy/fold_{{fold}}/checkpoint_best.pth")
pred = ensemble.load(fugc.work_path / "legacy").predict(
    (np.random.default_rng(2).random((3, 40, 48)) * 255).astype(np.uint8))
assert pred.shape == (40, 48) and set(np.unique(pred)) <= {{0, 1, 2}}
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


def test_k2_k3_k4_counters_stay_zero_on_cpu_tensors():
    x = torch.rand(1, 9, 11, 16)
    windows = ln_window.ln_window_partition_fused(x, torch.ones(16), torch.zeros(16), 4)
    assert windows.shape == (9, 4, 4, 16)
    qkv = torch.rand(9, 16, 3 * 2 * 8)
    tab = torch.rand(16, 8)
    assert attention.fused_attention_rel_packed_ik(qkv, tab, tab, 0.3, (4, 4), 2).shape == (9, 16, 16)
    rel = torch.rand(18, 16, 4)
    assert attention.fused_attention_rel_packed(qkv, rel, rel, 0.3, (4, 4), 2).shape == (9, 16, 16)
    assert ln_window.ln_window_partition_fused.launches == 0
    assert attention.fused_attention_rel_packed_ik.launches == 0
    assert attention.fused_attention_rel_packed.launches == 0


def test_backward_and_k5_counters_stay_zero_on_cpu_tensors():
    """Gradients through the K2, K3 and K4 wrappers and K5's wrapper on CPU
    tensors take the plain versions: no counter moves."""
    counters = (attention.fused_attention_rel_packed_ik, attention.fused_attention_rel_packed,
                ln_window.ln_window_partition_fused, attention.fused_attention_rel_packed_ik_bwd,
                attention.fused_attention_rel_packed_bwd, ln_window.ln_window_partition_fused_bwd,
                morphology.connected_components_fused)
    before = [c.launches for c in counters]
    x = torch.rand(1, 9, 11, 16, requires_grad=True)
    windows = ln_window.ln_window_partition_fused(x, torch.ones(16), torch.zeros(16), 4)
    qkv = torch.rand(9, 16, 3 * 2 * 8, requires_grad=True)
    tab = torch.rand(16, 8)
    rel = torch.rand(18, 16, 4, requires_grad=True)
    out = (attention.fused_attention_rel_packed_ik(qkv, tab, tab, 0.3, (4, 4), 2).sum()
           + attention.fused_attention_rel_packed(qkv, rel, rel, 0.3, (4, 4), 2).sum()
           + windows.sum())
    out.backward()
    assert x.grad is not None and qkv.grad is not None and rel.grad is not None
    labels = morphology.connected_components_fused((torch.rand(2, 12, 12) > 0.5).int())
    assert labels.dtype == torch.int32 and labels.shape == (2, 12, 12)
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K2b", "K3b", "K4b", "K5"])
def test_kernel_launchers_raise_on_cpu_tensors(kernel):
    qkv, tab, rel = torch.rand(1, 16, 3 * 2 * 16), torch.rand(16, 16), torch.rand(2, 16, 4)
    idx = torch.zeros(1, 8, dtype=torch.int32)
    out, g, lse = torch.rand(1, 16, 32), torch.rand(1, 16, 32), torch.rand(2, 16)
    x, ones = torch.rand(1, 8, 8, 16), torch.ones(16)
    launch = {
        "K1": lambda: _launch_k1(torch.rand(1, 8, 8, 4), idx, idx, idx, idx),
        "K2": lambda: attention._launch_k2(qkv, tab, tab, 0.25, (4, 4), 2),
        "K3": lambda: attention._launch_k3(qkv, rel, rel, 0.25, (4, 4), 2),
        "K4": lambda: ln_window._launch_k4(x, ones, torch.zeros(16), 4, 1e-6),
        "K2b": lambda: attention._launch_k2_bwd(qkv, tab, tab, out, g, lse, 0.25, (4, 4), 2),
        "K3b": lambda: attention._launch_k3_bwd(qkv, rel, rel, out, g, lse, 0.25, (4, 4), 2),
        "K4b": lambda: ln_window._launch_k4_bwd(x, torch.rand(4, 4, 4, 16), torch.rand(1, 8, 8),
                                                torch.rand(1, 8, 8), ones, 4),
        "K5": lambda: morphology._launch_k5(torch.ones(2, 8, 8, dtype=torch.int32)),
    }[kernel]
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch()


def test_k6_to_k9_counters_stay_zero_on_cpu_tensors():
    q, rel = torch.rand(4, 16, 8), torch.rand(4, 16, 4)
    assert attention.fused_attention_rel(q, q, q, rel, rel, 0.3, (4, 4)).shape == (4, 16, 8)
    assert attention.fused_attention(q, q, q, torch.rand(4, 16, 16), 0.3).shape == (4, 16, 8)
    grid = torch.rand(4, 5, 6, 4)
    out = attention.fused_attention_rel_win(torch.rand(2, 5, 6, 48), grid, grid,
                                            torch.rand(3, 16), 0.3, 4, 2)
    assert out.shape == (2, 5, 6, 16)
    x_new, y = unpartition_residual.unpartition_add_ln(
        torch.rand(8, 4, 4, 16), torch.rand(2, 5, 6, 16), torch.ones(16), torch.zeros(16), 4)
    assert x_new.shape == y.shape == (2, 5, 6, 16)
    assert (attention.fused_attention_rel.launches, attention.fused_attention.launches,
            attention.fused_attention_rel_win.launches,
            unpartition_residual.unpartition_add_ln.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("kernel,d,match", [
    ("K6", 64, "CUDA tensor"), ("K7", 64, "CUDA tensor"), ("K8", 64, "CUDA tensor"),
    ("K9", 64, "CUDA tensor"), ("K6", 24, "head dims"), ("K7", 24, "head dims"),
    ("K8", 24, "head dims")])
def test_route_kernel_launchers_raise_on_cpu_tensors_and_unsupported_head_dims(kernel, d, match):
    """The launchers of K6-K9 take a CUDA tensor or raise; K6-K8 refuse any
    head dim the template is not built for (64 and 80), as the JAX package's
    packed kernels refuse a layout they cannot tile."""
    q, rel = torch.rand(2, 16, d), torch.rand(2, 16, 4)
    grid = torch.rand(2, 5, 6, 4)
    launch = {
        "K6": lambda: attention._launch_k6(q, q, q, rel, rel, 0.25, (4, 4)),
        "K7": lambda: attention._launch_k7(q, q, q, torch.rand(2, 16, 16), 0.25),
        "K8": lambda: attention._launch_k8(torch.rand(1, 5, 6, 3 * 2 * d), grid, grid,
                                           torch.rand(3, 2 * d), 0.25, 4, 2),
        "K9": lambda: unpartition_residual._launch_k9(
            torch.rand(4, 4, 4, d), torch.rand(1, 5, 6, d), torch.ones(d), torch.zeros(d), 4),
    }[kernel]
    with pytest.raises(ValueError, match=match):
        launch()


@pytest.mark.parametrize("kernel", ["K6b", "K8b", "K9b"])
def test_route_backward_launchers_raise_on_cpu_tensors(kernel):
    q, rel, lse = torch.rand(2, 16, 64), torch.rand(2, 16, 4), torch.rand(2, 16)
    grid, x = torch.rand(2, 5, 6, 4), torch.rand(1, 5, 6, 64)
    launch = {
        "K6b": lambda: attention._launch_k6_bwd(q, q, q, rel, rel, q, q, lse, 0.25, (4, 4)),
        "K8b": lambda: attention._launch_k8_bwd(
            torch.rand(1, 5, 6, 3 * 2 * 64), grid, grid, torch.rand(3, 128), torch.rand(1, 5, 6, 128),
            torch.rand(1, 5, 6, 128), torch.rand(2, 30), 0.25, 4, 2),
        "K9b": lambda: unpartition_residual._launch_k9_bwd(
            x, x, x, torch.rand(1, 5, 6), torch.rand(1, 5, 6), torch.ones(64), 4),
    }[kernel]
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch()


def test_k10_counters_stay_zero_and_launchers_raise_on_cpu_tensors():
    """K10's wrapper and its gradient on CPU tensors take the plain versions;
    the launchers take a CUDA tensor or raise."""
    from mia_tpu_torch.models import EinsumConvTranspose2x
    from mia_tpu_torch.ops import upsample2x

    before = (upsample2x.conv_transpose2x.launches, upsample2x.conv_transpose2x_fused_bwd.launches)
    stage = EinsumConvTranspose2x(8, 4, use_kernel="always")
    x = torch.rand(2, 3, 5, 8, requires_grad=True)
    y = stage(x)
    assert y.shape == (2, 6, 10, 4)
    y.square().sum().backward()
    assert x.grad is not None and stage.weight.grad is not None and stage.bias.grad is not None
    with torch.no_grad():
        assert torch.equal(stage(x), y)
    assert (upsample2x.conv_transpose2x.launches,
            upsample2x.conv_transpose2x_fused_bwd.launches) == before
    w = stage.weight.detach().permute(2, 3, 0, 1).contiguous()
    with pytest.raises(ValueError, match="CUDA tensor"):
        upsample2x._launch_k10(x.detach(), w, stage.bias.detach())
    with pytest.raises(ValueError, match="CUDA tensor"):
        upsample2x._launch_k10_bwd(x.detach(), w, y.detach())


def test_route_gradients_count_no_launch_on_cpu_tensors():
    """Gradients through the K6-K9 wrappers on CPU tensors take the plain
    versions (forward and VJP): no counter moves."""
    counters = (attention.fused_attention_rel, attention.fused_attention_rel_bwd,
                attention.fused_attention, attention.fused_attention_rel_win,
                attention.fused_attention_rel_win_bwd, unpartition_residual.unpartition_add_ln,
                unpartition_residual.unpartition_add_ln_fused_bwd)
    before = [c.launches for c in counters]
    q = torch.rand(4, 16, 8, requires_grad=True)
    rel = torch.rand(4, 16, 4, requires_grad=True)
    out = attention.fused_attention_rel(q, q, q, rel, rel, 0.3, (4, 4)).sum()
    out = out + attention.fused_attention(q, q, q, torch.rand(4, 16, 16), 0.3).sum()
    grid = torch.rand(4, 5, 6, 4)
    qkv = torch.rand(2, 5, 6, 48, requires_grad=True)
    out = out + attention.fused_attention_rel_win(qkv, grid, grid, torch.rand(3, 16), 0.3, 4, 2).sum()
    windows = torch.rand(8, 4, 4, 16, requires_grad=True)
    x_new, y = unpartition_residual.unpartition_add_ln(
        windows, torch.rand(2, 5, 6, 16), torch.ones(16), torch.zeros(16), 4)
    (out + x_new.sum() + y.square().sum()).backward()
    assert all(t.grad is not None for t in (q, rel, qkv, windows))
    assert [c.launches for c in counters] == before


@pytest.mark.parametrize("options,match", [
    (dict(fuse_unpart_residual="always", fuse_ln_window="never"), "fuse_ln_window"),
    (dict(attn_route="grid_native"), "fuse_ln_window"),
    (dict(attn_route="grid_native", fuse_ln_window="always"), "fuse_ln_window"),
    (dict(attn_route="lanes"), "attn_route"),
    (dict(fuse_ln_window="sometimes"), "fuse_ln_window"),
])
def test_contradicting_encoder_options_raise_at_construction(options, match):
    from mia_tpu_torch.models.sam import ImageEncoderViT

    kw = dict(img_size=32, patch_size=4, embed_dim=16, depth=2, num_heads=2, window_size=4,
              global_attn_indexes=(1,))
    with pytest.raises(ValueError, match=match):
        ImageEncoderViT(**kw, **options)
    ImageEncoderViT(**kw, fuse_ln_window="never", attn_route="grid_native")  # the valid pairing
    ImageEncoderViT(**kw, fuse_unpart_residual="always")


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
