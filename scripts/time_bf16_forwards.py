"""Time the bfloat16 attention forwards of one or more source trees on one GPU,
queued, with the library call in turns.

For comparing two versions of the bfloat16 forwards (K2, K3, K6, K7, K8)
within one run: unpack the other tree with ``git archive <commit>
mia_tpu_torch | tar -x -C <dir>`` and name it with ``--tree``; each tree runs
in a process of its own and builds its own kernel library. For each tree it
prints the card, then each kernel's queued device time
(``chip_smoke.queued_ms``: a block of calls queued behind a spin kernel,
timed by CUDA events) at the shapes ``chip_smoke.py`` times: K3 at the
ViT-B/512 serving shapes B=1 and B=8 (packed qkv, 12 heads, 32 x 32 tokens),
K2 on the 9 and 72 windows of those images, K6 and K7 head-major on the B=1
windows (108, 196, 64) and global tokens (12, 1024, 64), K8 on the (1 and 8,
32, 32) token grids; beside one ``scaled_dot_product_attention`` call on the
same bfloat16 operands with the dense bias built beforehand (cuDNN), in
turns (library, kernel, kernel, library), and each output's distance from
the plain bfloat16 version by the forwards' ulp measure
(``chip_smoke.bf16_ulps``). For K2, K3, K6 and K7 it also prints the bound
(the function's 4 D flops a (query, key) pair at 989 TFLOP/s dense bfloat16,
or its bytes at 3.35 TB/s, as ``chip_smoke.bf16_bound``) and the warpgroup
design's floor: the flops and exponentials of the pairs it computes, at 989
TFLOP/s and at ~3.9e12 exponentials a second (16 a clock an SM, 132 SMs,
1.83 GHz), whichever is larger, and both a (query, key) pair of the
function. Rows are padded to 64-query tiles and keys to the products'
widths: two walks (K3, K6, and K7 on 1024 keys) compute S twice over
128-key steps at S's depth (128 on the 32 x 32 grid, 96 on 14 x 14 windows,
64 for K7) and P . V once, 2 exponentials a pair; one walk (K2 and K7 on
196-token windows) computes S once over 200 keys (depth 96; K7 64) and
P . V over 208, 1 exponential a pair. K2's rel terms (CUDA cores) are left
out of its floor. The floors are this script's designs, whichever tree it
times.

    python scripts/time_bf16_forwards.py [--tree DIR] [--tree DIR2 ...]

Several ``--tree`` arguments run in the given order (parent, change, change,
parent shows a drift of the card). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import functools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from mia_tpu_torch.ops import attention

    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(4)
    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention
    heads, d, ws = 12, 64, 14
    scale = d ** -0.5

    def randn(*shape, scale_=1.0, dtype=bf):
        return (scale_ * torch.randn(shape, generator=gen, device=device)).to(dtype)

    calls = []  # (label, kernel call, plain call, library call, per_block)
    floors = {}  # the bound and the design's floor, us

    def yardsticks(label, tensors, bh, n, depth, one_walk, flops=0):
        """The bound of bh grids of n x n (query, key) pairs (``flops``: any
        the function does besides 4 D a pair), and the floor of the design
        at S's depth, walking the keys once or twice."""
        pairs = bh * n * n
        bound = cs.bf16_bound(tensors, pairs * 4 * d + flops)
        rows = bh * -(-n // 64) * 64
        if one_walk:  # S once over 200 keys, P . V over 208
            work, exps = rows * (200 * 2 * depth + 208 * 2 * d), rows * 200
        else:  # S twice over 128-key steps, P . V once
            keys = -(-n // 128) * 128
            work, exps = rows * keys * (4 * depth + 2 * d), 2 * rows * keys
        floor = max(work / cs.BF16_TC_FLOPS_PER_S, exps / 3.9e12) * 1e6
        floors[label] = (f"bound {bound['bound_ms'] * 1e3:.2f} us ({bound['bound_by']}), "
                         f"design floor {floor:.2f} us ({work / pairs:.0f} flops, "
                         f"{exps / pairs:.2f} exponentials a pair)")

    for b in (1, 8):
        args = (randn(b, 1024, 3 * heads * d), randn(b * heads, 1024, 32),
                randn(b * heads, 1024, 32), scale, (32, 32), heads)
        q, k, v = cs.head_major(args[0], heads)
        bias = cs.dense_bias(args[1], args[2], b, heads)
        out = torch.empty(b, 1024, heads * d, dtype=bf)
        yardsticks(f"K3 B={b}", [*args[:3], out], b * heads, 1024, 128, False)
        calls.append((f"K3 B={b}", functools.partial(attention._launch_k3, *args),
                      functools.partial(attention.attention_rel_packed_bf16, *args),
                      functools.partial(sdpa, q, k, v, attn_mask=bias, scale=scale),
                      50 if b == 1 else 10))
        rh, rw = randn(ws * ws, d, scale_=0.1), randn(ws * ws, d, scale_=0.1)
        args2 = (randn(9 * b, ws * ws, 3 * heads * d), rh, rw, scale, (ws, ws), heads)
        r_h, r_w = attention.window_rel_terms(args2[0], rh, rw, (ws, ws), heads)
        q2, k2, v2 = cs.head_major(args2[0], heads)
        bias2 = cs.dense_bias(r_h, r_w, 9 * b, heads)
        out2 = torch.empty(9 * b, ws * ws, heads * d, dtype=bf)
        yardsticks(f"K2 B={b}", [*args2[:3], out2], 9 * b * heads, ws * ws, 96, True,
                   9 * b * heads * ws * ws * 2 * ws * 2 * d)  # the rel terms: 2 D a term
        calls.append((f"K2 B={b}", functools.partial(attention._launch_k2, *args2),
                      functools.partial(attention.attention_rel_packed_bf16, args2[0], r_h, r_w,
                                        scale, (ws, ws), heads),
                      functools.partial(sdpa, q2, k2, v2, attn_mask=bias2, scale=scale),
                      50 if b == 1 else 10))
    for label, bh, k_hw in (("windows", 108, (14, 14)), ("global", 12, (32, 32))):
        n = k_hw[0] * k_hw[1]
        qkv_ = (randn(bh, n, d), randn(bh, n, d), randn(bh, n, d))
        rel = (randn(bh, n, k_hw[0]), randn(bh, n, k_hw[1]))
        bias = cs.dense_bias(*rel, 1, bh)
        lib = functools.partial(sdpa, *(t[None] for t in qkv_), attn_mask=bias, scale=scale)
        depth = 96 if sum(k_hw) <= 32 else 128
        yardsticks(f"K6 {label}", [*qkv_, *rel, qkv_[0]], bh, n, depth, False)
        calls.append((f"K6 {label}", functools.partial(attention._launch_k6, *qkv_, *rel, scale,
                                                        k_hw),
                      functools.partial(attention.attention_rel_bf16, *qkv_, *rel, scale, k_hw),
                      lib, 20))
        dense = randn(bh, n, n, dtype=torch.float32)
        yardsticks(f"K7 {label}", [*qkv_, dense, qkv_[0]], bh, n, 64, n <= 200)
        calls.append((f"K7 {label}", functools.partial(attention._launch_k7, *qkv_, dense, scale),
                      functools.partial(attention.attention_dense_bf16, *qkv_, dense, scale),
                      functools.partial(sdpa, *(t[None] for t in qkv_),
                                        attn_mask=dense[None].to(bf), scale=scale), 20))
    for b in (1, 8):
        args8 = (randn(b, 32, 32, 3 * heads * d), randn(b * heads, 32, 32, ws),
                 randn(b * heads, 32, 32, ws), randn(3, heads * d, scale_=0.5), scale, ws, heads)
        lib_args = cs.windows_for_library(*args8[:4], ws, heads)
        calls.append((f"K8 B={b}", functools.partial(attention._launch_k8, *args8),
                      functools.partial(attention.attention_rel_win_bf16, *args8),
                      functools.partial(sdpa, *lib_args[:3], attn_mask=lib_args[3], scale=scale),
                      50 if b == 1 else 10))
    for label, kernel, plain, library, per_block in calls:
        got, want = kernel(), plain()
        want = want[0] if isinstance(want, tuple) else want
        torch.cuda.synchronize()
        ulps, equal = cs.bf16_ulps(torch, got, want)
        ms, lib_ms = cs.library_turns_ms(torch, f"{tree}: {label}", kernel, library, per_block)
        print(f"{tree}: {label}: kernel {ms * 1e3:.2f} us queued, library {lib_ms * 1e3:.2f} us "
              f"({ms / lib_ms:.2f}x); {ulps:.3g} ulps from plain, {equal:.5f} bit-equal"
              + (f"; {floors[label]}" if label in floors else ""), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="root of a tree that holds mia_tpu_torch/")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process of one tree
    args = ap.parse_args(argv)
    if args.one:
        one(args.one)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
