"""Time the backward attention kernels of a source tree on one GPU.

For comparing two versions of the backward templates
(``mia_tpu_torch/csrc/attention_bwd_tc.cuh``, ``attention_bwd.cuh``) or of
``attention_rel.cu`` within one run: unpack the other
tree with ``git archive <commit> mia_tpu_torch | tar -x -C <dir>`` and name it
with ``--tree``; every tree builds its own kernel library. Prints the card,
then K3b (global, ``(12, 1024, 2304)`` packed qkv) and K2b (windows, ``(108,
196, 2304)``) at the ViT-B/512 training shape for batch 12 as medians of 7
blocks of 10 launches by CUDA events, twice each, K3b's and K2b's largest
errors against their plain VJPs, and K6b (global) and K8b where the tree has
them. With
``--kernels`` each tree also runs K3b, K2b and the library yardstick
(autograd through one ``scaled_dot_product_attention`` call with the dense
bias, as ``chip_smoke.py`` times it) under ``torch.profiler`` and prints the
device kernels each one launches, with their times. Needs a CUDA device.

    python scripts/profile_torch_attention_bwd.py [--tree DIR] [--tree DIR2 ...] [--kernels]

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


def kernel_table(torch, label, fn, runs=3):
    """The device kernels of ``fn`` under the profiler: name, calls and
    milliseconds per run, longest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / runs
    print(f"{label} under the profiler: {total:.4f} ms of device time per run")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / runs:9.4f} ms  x{e.count // runs}  {e.key[:150]}")


def library_backward(torch, qkv, rel_h, rel_w, scale, heads, g):
    """Autograd through one ``scaled_dot_product_attention`` call on K3b's
    operands with the dense bias (dq, dk, dv and the bias gradient)."""
    b, n, _ = qkv.shape
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4))
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, heads, n, n)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                                           scale=scale)
    g4 = g.view(b, n, heads, -1).transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)


def bench(tree: str, kernels: bool = False) -> None:
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
    want = attention.attention_rel_packed_ik_bwd(qkv2, rh, rw, out2, g2, scale, (ws, ws), heads,
                                                 False)
    err = float((k2b()[0] - want[0]).abs().max() / want[0].abs().max())
    print(f"{tree}: K2b within {err:.3g} of max |plain|")
    for _ in range(2):
        print(f"{tree}: K3b B=12 {time_ms(torch, k3b):.4f} ms, K2b B=12 "
              f"{time_ms(torch, k2b):.4f} ms", flush=True)
    if kernels:
        kernel_table(torch, f"{tree}: K3b B=12", k3b)
        kernel_table(torch, f"{tree}: K2b B=12", k2b)
        kernel_table(torch, f"{tree}: library backward at K3b's B=12 shape",
                     library_backward(torch, qkv3, rel_h, rel_w, scale, heads, g3))
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
    ap.add_argument("--kernels", action="store_true",
                    help="also list the device kernels of K3b, K2b and the library call")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process of one tree
    args = ap.parse_args(argv)
    if args.one:
        bench(args.one, args.kernels)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree]
                       + (["--kernels"] if args.kernels else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
