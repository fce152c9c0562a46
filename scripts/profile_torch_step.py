"""Where the PyTorch port's FUGC train step spends its time on one GPU.

Full-width UNet (32..512), batch 12, 256², FUGC augmentation + z-score,
Dice+CE, clip + Adam — the step of ``al_train_torch``. Prints the median
step time with TF32 convolutions (the port's float32 setting) and in full
float32, the time of each stage, and a ``torch.profiler`` table of device
time by kernel. Needs a CUDA device.

    python scripts/profile_torch_step.py [--batch 12] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mia_tpu_torch.losses import DiceAndCELoss  # noqa: E402
from mia_tpu_torch.models import UNet, UNetConfig  # noqa: E402
from mia_tpu_torch.schedule import poly_warmup_schedule  # noqa: E402
from mia_tpu_torch.training import TrainState, make_optimizer, make_train_step  # noqa: E402
from mia_tpu_torch.transforms import get_train_transform, zscore_normalize  # noqa: E402


def median_ms(fn, n=20, warmup=5) -> float:
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
    parser.add_argument("--batch", type=int, default=12)
    parser.add_argument("--trace", type=Path, default=None, help="chrome trace output")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_step: needs a CUDA device")

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    gen = torch.Generator(device=dev).manual_seed(0)
    b = args.batch
    images = torch.randint(0, 256, (b, 256, 256, 3), generator=gen, device=dev, dtype=torch.uint8)
    labels = torch.randint(0, 3, (b, 256, 256), generator=gen, device=dev, dtype=torch.uint8)
    recipe = get_train_transform("fugc")
    loss_fn = DiceAndCELoss()

    def preprocess(g, im, lb):
        im, lb = recipe(g, im.to(torch.float32) / 255.0, lb.long())
        return zscore_normalize(im), lb

    torch.manual_seed(0)
    model = UNet(UNetConfig(in_channels=3, out_classes=3)).to(dev, memory_format=torch.channels_last)
    opt = make_optimizer("adam", model.parameters(), poly_warmup_schedule(1e-3, 4000, 250),
                         grad_clip=10.0, weight_decay=5e-4)
    state = TrainState(model, opt)
    step = make_train_step(loss_fn, preprocess)
    torch.backends.cuda.matmul.allow_tf32 = False

    for tf32 in (True, False):
        torch.backends.cudnn.allow_tf32 = tf32
        ms = median_ms(lambda: step(state, images, labels, gen))
        name = "TF32 convolutions" if tf32 else "full float32"
        print(f"train step, {name}: {ms:.2f} ms ({b / ms * 1e3:.1f} img/s)")
    torch.backends.cudnn.allow_tf32 = True

    x, y = preprocess(gen, images, labels)
    model.train()

    def forward_backward():
        total = loss_fn(model(x, gen), y)[0]
        torch.autograd.grad(total, state.params)

    grads = [torch.randn_like(p) * 1e-3 for p in state.params]
    print(f"  preprocess (augmentation + z-score): {median_ms(lambda: preprocess(gen, images, labels)):.2f} ms")
    print(f"  forward + loss + backward: {median_ms(forward_backward):.2f} ms")
    print(f"  clip + Adam ({len(state.params)} tensors): {median_ms(lambda: opt.step(grads)):.2f} ms")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step(state, images, labels, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / 5
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / 5
    print(f"profiled: {wall * 1e3:.2f} ms/step wall, {device_ms:.2f} ms/step kernel time "
          "(the profiler adds host overhead to the wall time)")
    print("kernel time per step by kernel (ms, share, launches):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:20]:
        ms = e.self_device_time_total / 1e3 / 5
        print(f"  {ms:8.3f} {ms / device_ms:6.1%} {e.count // 5:5d}  {e.key[:100]}")
    if args.trace is not None:
        prof.export_chrome_trace(str(args.trace))


if __name__ == "__main__":
    main()
