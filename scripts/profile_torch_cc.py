"""Time the connected-components kernel K5 of one or more source trees on one GPU.

For comparing two versions of ``mia_tpu_torch/csrc/connected_components.cu``
within one run: unpack the other tree with ``git archive <commit>
mia_tpu_torch | tar -x -C <dir>`` and name it with ``--tree``; every tree
builds its own kernel library, in its own process. Each tree times K5 on the
masks ``chip_smoke.py`` times it on (12 images x 3 decoders x 4 classes of
64x64 pseudo-labels: blobs, speckle, empty, full) and on a (4, 512, 512)
stack (the global-scratch path), as medians of 11 blocks of 10 launches by
CUDA events, twice each (the wrapper's mask conversion included), with the
kernel's own device time under ``torch.profiler`` over one block, and
prints a digest of the labels (equal digests across trees: the same labels)
and whether they equal the plain version's.

    python scripts/profile_torch_cc.py [--tree DIR] [--tree DIR2 ...]

Several ``--tree`` arguments run in the given order (parent, change, change,
parent shows a drift of the card). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(torch, fn, blocks=11, per_block=10):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(per_block):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_block)
    return statistics.median(times)


def device_ms(torch, fn, per_block=10):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(per_block):
            fn()
        torch.cuda.synchronize()
    mine = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and "connected_components_kernel" in e.key]
    return sum(e.self_device_time_total for e in mine) / 1e3 / sum(e.count for e in mine)


def bench(tree: str) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    sys.path.insert(0, tree)
    from mia_tpu_torch.ops import morphology

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    cases = {"(144, 64, 64)": chip_smoke.class_masks(torch, chip_smoke.label_maps(torch, gen, 36,
                                                                                  64, device)),
             "(4, 512, 512)": chip_smoke.label_maps(torch, gen, 4, 512, device).clamp(max=1)
             .to(torch.int32)}
    for label, masks in cases.items():
        got = morphology._launch_k5(masks)
        exact = torch.equal(got, morphology.connected_components(masks))
        digest = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()[:12]
        fn = lambda masks=masks: morphology._launch_k5(masks)  # noqa: E731
        times = ", ".join(f"{time_ms(torch, fn) * 1e3:.2f}" for _ in range(2))
        print(f"{tree}: K5 {label}: {times} us (median of 11 x 10 launches), device "
              f"{device_ms(torch, fn) * 1e3:.2f} us; labels {digest}, equal to the plain "
              f"version's: {exact}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="root of a tree that holds mia_tpu_torch/")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process of one tree
    args = ap.parse_args(argv)
    if args.one:
        bench(args.one)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", str(Path(tree).resolve())], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
