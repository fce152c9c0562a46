#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mia_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--out DIR]

1. Prints the card (``nvidia-smi`` name and power limit) and the CUDA version.
2. Builds the hand-written kernels from ``mia_tpu_torch/csrc`` with nvcc.
3. Kernel phase: holds K1 (the affine-warp kernel) against its plain PyTorch
   version on the card — 60 recipe-range matrices at (12, 256, 256, 4), the
   identity, an all-out-of-source map and odd shapes — bit for bit, and
   times both with CUDA events.
4. Slice phase: writes a synthetic FUGC dataset (48/8/8 PNGs at 336x544)
   and runs ``al_train_torch``'s ``train_entry`` with the README's FUGC flags
   at full width (32..512), batch 12, 256², on ``cuda``: 2 AL rounds of 30
   iterations. Checks parameters on the card, finite losses, the round
   files, the labeled set growing by the budget, K1 launches from the train
   steps, and the trained UNet's logits on the card against the same
   weights on the CPU (in full float32, and with the run's TF32
   convolutions). Prints the loader's host decode path (native uint8 or
   PIL float32) and the bytes each train batch shipped, beside the step
   and round times that depend on them.
5. Prints one JSON line with the kernels, then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, when there is no CUDA device, when it is
not next to the package it tests, or when any phase fails. ``--out DIR``
also writes the trainer's log and the JSON lines into DIR.
"""

from __future__ import annotations

import argparse
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
K1_SOURCE = "mia_tpu_torch/csrc/affine_warp.cu"
K1_REPLACES = "mia_tpu/ops/warp.py:300"  # affine_warp_pallas


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, torch, blocks=11, per_block=50, warmup=10):
    """Median over blocks of the mean CUDA-event time of one call (ms)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_block):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_block)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# kernel phase
# ---------------------------------------------------------------------------


def recipe_matrices(torch, gen, n, h, w, device):
    """FUGC-recipe maps: scale U(0.7, 1.4), rotation U(-15, 15), and both."""
    from mia_tpu_torch.ops.warp import affine_inverse_matrix

    def u(lo, hi):
        return torch.rand(n, generator=gen, device=device) * (hi - lo) + lo

    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    zeros2 = torch.zeros(n, 2, device=device)
    ones = torch.ones(n, device=device)
    zeros = torch.zeros(n, device=device)
    scale = affine_inverse_matrix(zeros, zeros2, u(0.7, 1.4), zeros2, center)
    rot = affine_inverse_matrix(u(-15.0, 15.0), zeros2, ones, zeros2, center)
    bottom = torch.tensor([[[0.0, 0.0, 1.0]]], device=device).expand(n, 1, 3)
    both = (torch.cat([scale, bottom], 1) @ torch.cat([rot, bottom], 1))[:, :2]
    kind = torch.arange(n, device=device) % 3
    return torch.where(
        (kind == 0)[:, None, None], scale, torch.where((kind == 1)[:, None, None], rot, both)
    ).contiguous()


def stack_input(torch, gen, shape, device):
    b, h, w, c = shape
    img = torch.rand((b, h, w, c - 1), generator=gen, device=device)
    lbl = torch.randint(0, 3, (b, h, w, 1), generator=gen, device=device).float()
    return torch.cat([img, lbl], -1).contiguous()


def kernel_phase(torch, device):
    from mia_tpu_torch.ops import warp

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    cases = []
    b, h, w, c = 12, 256, 256, 4
    for _ in range(5):  # 60 recipe-range matrices
        cases.append(("recipe", stack_input(torch, gen, (b, h, w, c), device),
                      recipe_matrices(torch, gen, b, h, w, device)))
    eye = torch.eye(2, 3, device=device).expand(b, 2, 3).contiguous()
    cases.append(("identity", stack_input(torch, gen, (b, h, w, c), device), eye))
    far = eye.clone()
    far[:, :, 2] = 10_000.0
    cases.append(("out-of-source", stack_input(torch, gen, (b, h, w, c), device), far))
    for shape in ((3, 37, 45, 4), (2, 40, 48, 3), (1, 33, 17, 5)):
        cases.append((f"odd{shape}", stack_input(torch, gen, shape, device),
                      recipe_matrices(torch, gen, shape[0], shape[1], shape[2], device)))

    max_err = 0.0
    for name, img, mats in cases:
        _, hh, ww, _ = img.shape
        idx = warp._warp_shift2pass_indices(mats, hh, ww)
        got = warp._launch_k1(img, *idx)
        want = warp._shift2pass_gather(img, *idx)
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"K1 {name}: shape {tuple(got.shape)}")
        err = (got - want).abs().max().item()
        max_err = max(max_err, err)
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"K1 {name}: not bit-exact against the plain version (max |diff| {err})")
        wrapped = warp.affine_warp_shift2pass_fused(img, mats)
        plain = warp.affine_warp_shift2pass(img, mats)
        check(torch.equal(wrapped, plain), f"K1 {name}: wrapper differs from the plain warp")
        if name == "identity":
            check(torch.equal(got, img), "K1 identity map changed the input")
        if name == "out-of-source":
            check(not got.any(), "K1 out-of-source map left non-zero pixels")
    torch.cuda.synchronize()

    img, mats = cases[0][1], cases[0][2]
    idx = warp._warp_shift2pass_indices(mats, h, w)
    plain_a = time_ms(lambda: warp._shift2pass_gather(img, *idx), torch)
    k1_a = time_ms(lambda: warp._launch_k1(img, *idx), torch)
    k1_b = time_ms(lambda: warp._launch_k1(img, *idx), torch)
    plain_b = time_ms(lambda: warp._shift2pass_gather(img, *idx), torch)
    k1_ms, plain_ms = min(k1_a, k1_b), min(plain_a, plain_b)
    print(f"K1 bit-exact vs plain on {len(cases)} cases (max |diff| {max_err})")
    print(f"K1 at (12, 256, 256, 4): kernel {k1_a * 1e3:.2f} / {k1_b * 1e3:.2f} us, "
          f"plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us (median of 11 x 50 launches)")
    return {"max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms}


# ---------------------------------------------------------------------------
# slice phase
# ---------------------------------------------------------------------------


def write_fugc(root: Path, n_train=48, n_val=8, n_test=8, size=(336, 544), seed=0):
    """FUGC-layout PNGs: grayscale images with two lip-like ellipses."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    hh, ww = size
    yy, xx = np.mgrid[0:hh, 0:ww]
    for split, n in (("train", n_train), ("val", n_val), ("test", n_test)):
        (root / split / "images").mkdir(parents=True, exist_ok=True)
        (root / split / "labels").mkdir(parents=True, exist_ok=True)
        for i in range(n):
            label = np.zeros(size, np.uint8)
            for cls in (1, 2):
                cy, cx = rng.uniform(0.25, 0.75) * hh, rng.uniform(0.25, 0.75) * ww
                ry, rx = rng.uniform(0.05, 0.15) * hh, rng.uniform(0.05, 0.15) * ww
                label[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = cls
            image = 60.0 + 70.0 * label + rng.normal(0.0, 20.0, size)
            name = f"{split}_{i:03d}.png"
            Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(
                root / split / "images" / name)
            Image.fromarray(label).save(root / split / "labels" / name)


def slice_phase(torch, workdir: Path):
    from mia_tpu_torch.data import decode_path
    from mia_tpu_torch.entry.activelearning.train import train_entry
    from mia_tpu_torch.ops import warp
    from mia_tpu_torch.training import ALTrainer

    data = workdir / "fugc"
    write_fugc(data)
    rounds, budget, iters, batch = 2, 8, 30, 12
    argv = [
        "--work-path", str(workdir / "work"), "--data-path", str(data),
        "--device", "cuda", "--dataset", "fugc", "--in-channels", "3",
        "--num-classes", "2", "--image-size", "256", "--batch-size", str(batch),
        "--valid-mode", "slice", "--active-selector", "entropy",
        "--do-augment", "--do-normalize", "--optimizer", "adam",
        "--lr-scheduler", "poly", "--lr-warmup-iter", "5",
        "--num-rounds", str(rounds), "--budget", str(budget),
        "--num-iters", str(iters), "--valid-freq-iter", "15",
        "--do-oversample", "--quiet",
    ]

    steps, losses, round_s, k1_in_steps, wire = [], [], [], [], set()
    orig_step = ALTrainer.train_step
    orig_record = ALTrainer._record_train_loss
    orig_start, orig_end = ALTrainer.on_round_start, ALTrainer.on_round_end

    def timed_step(self, batch_):
        torch.cuda.synchronize()
        before = warp.affine_warp_shift2pass_fused.launches
        t0 = time.perf_counter()
        orig_step(self, batch_)
        torch.cuda.synchronize()
        steps.append((self.current_round, time.perf_counter() - t0))
        k1_in_steps.append(warp.affine_warp_shift2pass_fused.launches - before)
        img = batch_["image"]
        wire.add((str(img.dtype).removeprefix("torch."), img.numel() * img.element_size()))

    def record(self, step_index, lr, loss):
        losses.append(loss)
        return orig_record(self, step_index, lr, loss)

    def round_start(self):
        self._smoke_t0 = time.perf_counter()
        return orig_start(self)

    def round_end(self):
        out = orig_end(self)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - self._smoke_t0)
        return out

    ALTrainer.train_step, ALTrainer._record_train_loss = timed_step, record
    ALTrainer.on_round_start, ALTrainer.on_round_end = round_start, round_end
    try:
        warp.affine_warp_shift2pass_fused.launches = 0
        t0 = time.perf_counter()
        trainer = train_entry(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = warp.affine_warp_shift2pass_fused.launches
    finally:
        ALTrainer.train_step, ALTrainer._record_train_loss = orig_step, orig_record
        ALTrainer.on_round_start, ALTrainer.on_round_end = orig_start, orig_end

    work = trainer.work_path
    check(torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "float32 compute must run TF32 convolutions and full-float32 matmuls")
    params = list(trainer.model.parameters())
    check(all(p.device.type == "cuda" for p in params), "UNet parameters are not on CUDA")
    check(trainer.model.encoder.levels[4][1].all[0].weight.shape[0] == 512, "UNet is not at full width")
    check(len(steps) == rounds * iters, f"{len(steps)} train steps, expected {rounds * iters}")
    check(len(losses) == rounds * iters and all(math.isfinite(x) for x in losses),
          f"train losses not all finite: {losses}")
    for r in range(rounds):
        for rel in ("data_list.json", "best_model/model.pth", "final_model/model.pth"):
            check((work / f"round_{r}" / rel).is_file(), f"missing round_{r}/{rel}")
        check((work / f"test_mean_round_{r}.csv").is_file(), f"missing test_mean_round_{r}.csv")
    dl = [json.loads((work / f"round_{r}/data_list.json").read_text()) for r in range(rounds)]
    sizes = [len(d["labeled_image_idx"]) for d in dl]
    check(sizes == [budget * (r + 1) for r in range(rounds)], f"labeled sizes {sizes}")
    check(set(dl[0]["labeled_image_idx"]) <= set(dl[1]["labeled_image_idx"]),
          "round 1 dropped round-0 cases")
    check(sum(k1_in_steps) > 0 and all(k == 1 for k in k1_in_steps),
          f"K1 launches per train step: {k1_in_steps}")
    test_rows = (work / f"test_mean_round_{rounds - 1}.csv").read_text().splitlines()
    check(len(test_rows) == 9 and "all-DSC" in test_rows[0], "test CSV malformed")

    # the trained UNet on the card against the same weights on the CPU:
    # in full float32 (the math) and with the run's TF32 convolutions
    from mia_tpu_torch.models import UNet

    cpu_model = UNet(trainer.model.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    cpu_model.eval()
    trainer.model.eval()
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = cpu_model(x)
        tf32 = torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = False
            got_fp32 = trainer.model(x.cuda()).cpu()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        got_tf32 = trainer.model(x.cuda()).cpu()
    check(got_tf32.shape == (2, 256, 256, 3) and torch.isfinite(got_tf32).all(),
          "logits malformed")
    scale = want.abs().max().item()
    fp32_err = (got_fp32 - want).abs().max().item()
    tf32_err = (got_tf32 - want).abs().max().item()
    check(fp32_err < 1e-4 * max(scale, 1.0),
          f"float32 UNet logits on the card vs CPU differ by {fp32_err} (scale {scale})")
    check(tf32_err < 2e-2 * max(scale, 1.0),
          f"TF32 UNet logits on the card vs CPU differ by {tf32_err} (scale {scale})")

    warm = [s for r, s in steps[5:iters]] + [s for r, s in steps[iters + 5:]]
    step_ms = statistics.median(warm) * 1e3
    print(f"slice: {rounds} AL rounds x {iters} iters at width 32..512, 256^2, batch {batch}; "
          f"labeled {sizes}; losses first {losses[0]:.4f} last {losses[-1]:.4f}")
    print(f"slice: train step median {step_ms:.2f} ms ({batch / step_ms * 1e3:.1f} img/s) "
          f"after 5 warm-up steps per round; round seconds {[round(s, 2) for s in round_s]}; "
          f"total {total_s:.1f} s")
    print(f"slice: host decode: {decode_path()}; train batches shipped as "
          + ", ".join(f"{d} images of {n / 2**20:.2f} MiB" for d, n in sorted(wire)))
    print(f"slice: K1 launches {launches} in the run, {sum(k1_in_steps)} from train steps; "
          f"UNet logits card vs CPU max |diff| {fp32_err:.3g} (float32), "
          f"{tf32_err:.3g} (TF32 convs), max |logit| {scale:.3g}")
    return {"launches": launches, "log": work / "log.txt", "host_decode": decode_path()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None, help="also write logs here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA GPU is required",
              file=sys.stderr)
        return 2
    if not (HERE / K1_SOURCE).is_file():
        print(f"chip_smoke: {K1_SOURCE} not found next to this script; run it from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    import mia_tpu_torch

    if Path(mia_tpu_torch.__file__).resolve().parent != HERE / "mia_tpu_torch":
        print(f"chip_smoke: imported {mia_tpu_torch.__file__}, not this checkout's package",
              file=sys.stderr)
        return 2

    from mia_tpu_torch.ops import cuda_build

    device = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    cuda_build.load_library()
    build_s = time.perf_counter() - t0
    print(f"kernels built and loaded in {build_s:.2f} s")

    k1 = kernel_phase(torch, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = slice_phase(torch, Path(tmp))
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            shutil.copy(sl["log"], args.out / "chip_smoke_train_log.txt")
    imported = sorted(m for m in sys.modules if m in ("jax", "mia_tpu")
                      or m.startswith(("jax.", "mia_tpu.")))
    check(not imported, f"JAX or the JAX package was imported: {imported}")

    kernels = {"kernels": [{
        "name": "affine_warp_shift2pass (K1)",
        "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES,
        "launches": sl["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}
    result = {"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(
            json.dumps({"card": card, "host_decode": sl["host_decode"], **kernels, **result},
                       indent=1))
    print(card)
    print(json.dumps(kernels))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
