"""Time the backward attention kernels of a source tree on one GPU.

For comparing two versions of ``mia_tpu_torch/csrc/attention_bwd.cuh`` (or
of the parent commit's ``attention_rel.cu``) within one run: unpack the other
tree with ``git archive <commit> mia_tpu_torch | tar -x -C <dir>`` and name it
with ``--tree``; every tree builds its own kernel library. Prints the card,
then K3b (global, ``(12, 1024, 2304)`` packed qkv) and K2b (windows, ``(108,
196, 2304)``) at the ViT-B/512 training shape for batch 12 as medians of 7
blocks of 10 launches by CUDA events, twice each, K3b's largest error against
its plain VJP, and K6b (global) and K8b where the tree has them. Needs a CUDA
device.

    python scripts/profile_torch_attention_bwd.py [--tree DIR] [--tree DIR2 ...]

Several ``--tree`` arguments run in the given order, one process each
(parent, change, change, parent is the order that shows a drift of the card).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(torch, fn, blocks=7, per_block=10):
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
    return sorted(times)[len(times) // 2]


def bench(tree: str) -> None:
    import torch

    sys.path.insert(0, tree)
    from mia_tpu_torch.ops import attention

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(3)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    heads, d, ws, side, b = 12, 64, 14, 32, 12
    scale = d ** -0.5
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    qkv2 = randn(b * 9, ws * ws, 3 * heads * d)
    out2, lse2 = attention._launch_k2(qkv2, rh, rw, scale, (ws, ws), heads, with_lse=True)
    g2 = randn(b * 9, ws * ws, heads * d)
    qkv3 = randn(b, side * side, 3 * heads * d)
    rel_h, rel_w = (randn(b * heads, side * side, side) for _ in range(2))
    out3, lse3 = attention._launch_k3(qkv3, rel_h, rel_w, scale, (side, side), heads,
                                      with_lse=True)
    g3 = randn(b, side * side, heads * d)

    def k2b():
        return attention._launch_k2_bwd(qkv2, rh, rw, out2, g2, lse2, scale, (ws, ws), heads, False)

    def k3b():
        return attention._launch_k3_bwd(qkv3, rel_h, rel_w, out3, g3, lse3, scale, (side, side),
                                        heads)

    want = attention.attention_rel_packed_bwd(qkv3, rel_h, rel_w, out3, g3, scale, (side, side),
                                              heads)
    err = max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(k3b(), want))
    print(f"{tree}: K3b within {err:.3g} of max |plain|")
    for _ in range(2):
        print(f"{tree}: K3b B=12 {time_ms(torch, k3b):.4f} ms, K2b B=12 "
              f"{time_ms(torch, k2b):.4f} ms", flush=True)
    if hasattr(attention, "_launch_k6_bwd"):
        q, k, v = (randn(b * heads, side * side, d) for _ in range(3))
        out6, lse6 = attention._launch_k6(q, k, v, rel_h, rel_w, scale, (side, side), with_lse=True)
        g6 = randn(b * heads, side * side, d)
        ms = time_ms(torch, lambda: attention._launch_k6_bwd(q, k, v, rel_h, rel_w, out6, g6, lse6,
                                                             scale, (side, side)), per_block=5)
        print(f"{tree}: K6b global B=12 {ms:.4f} ms", flush=True)
    if hasattr(attention, "_launch_k8_bwd"):
        grid = randn(b, side, side, 3 * heads * d)
        r8h, r8w = (randn(b * heads, side, side, ws) for _ in range(2))
        bias_kv = randn(3, heads * d)
        out8, lse8 = attention._launch_k8(grid, r8h, r8w, bias_kv, scale, ws, heads, with_lse=True)
        g8 = randn(b, side, side, heads * d)
        ms = time_ms(torch, lambda: attention._launch_k8_bwd(grid, r8h, r8w, bias_kv, out8, g8,
                                                             lse8, scale, ws, heads), per_block=5)
        print(f"{tree}: K8b B=12 {ms:.4f} ms", flush=True)


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
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
