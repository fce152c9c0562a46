"""Where the PyTorch port's SAM serving spends its time on one GPU.

ViT-B/512 ``SamPredictor`` with seeded random weights, a 480x640 uint8 frame
(input 512x384, padded), the port's float32 setting (TF32 convolutions,
full-float32 matmuls). Prints the median ``set_image`` and ``predict``
times and a ``torch.profiler`` table of device time by kernel for
``set_image``, with the hand-written kernels (K2, K3, K4), the cuDNN
convolutions and the cuBLAS GEMMs summed into groups. Needs a CUDA device.

    python scripts/profile_torch_sam.py [--runs 5] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mia_tpu_torch.device import set_compute_precision  # noqa: E402
from mia_tpu_torch.models.sam import SamPredictor, sam_model_registry  # noqa: E402

GROUPS = (  # (label, substrings of the kernel name), first match wins
    ("K2 windowed attention", ("attention_rel_kernel<64, true", "attention_rel_kernelILi64ELb1")),
    ("K3 global attention", ("attention_rel_kernel<64, false", "attention_rel_kernelILi64ELb0")),
    ("K4 LayerNorm + partition", ("ln_window_partition_kernel",)),
    ("cuDNN convolutions", ("fprop", "implicit", "cudnn", "conv2d")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "Kernel2")),
)


def median_ms(fn, n=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=5, help="set_image calls profiled")
    parser.add_argument("--trace", type=Path, default=None, help="chrome trace output")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sam: needs a CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    set_compute_precision("float32")
    torch.manual_seed(0)
    model, _ = sam_model_registry["vit_b"](512, 3, device="cuda")
    predictor = SamPredictor(model)
    rng = np.random.default_rng(0)
    image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
    point, label = np.array([[320.0, 240.0]]), np.array([1])

    print(f"set_image: {median_ms(lambda: predictor.set_image(image)):.2f} ms (median of 20)")
    print(f"predict (1 point): "
          f"{median_ms(lambda: predictor.predict(point_coords=point, point_labels=label)):.2f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.runs):
            predictor.set_image(image)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / args.runs
    print(f"set_image kernel time {total:.3f} ms per call ({len(kernels)} kernel names)")
    grouped = {group: [0.0, 0] for group, _ in GROUPS}
    grouped["other"] = [0.0, 0]
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in GROUPS if any(k.lower() in name for k in keys)), "other")
        grouped[group][0] += e.self_device_time_total / 1e3 / args.runs
        grouped[group][1] += e.count // args.runs
    print("by group (ms per set_image, share, launches):")
    for group, (ms, count) in grouped.items():
        print(f"  {ms:8.3f} {ms / total:6.1%} {count:5d}  {group}")
    print("by kernel (top 15):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        ms = e.self_device_time_total / 1e3 / args.runs
        print(f"  {ms:8.3f} {ms / total:6.1%} {e.count // args.runs:5d}  {e.key[:100]}")
    if args.trace is not None:
        prof.export_chrome_trace(str(args.trace))


if __name__ == "__main__":
    main()
