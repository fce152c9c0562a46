"""Time the bfloat16 attention forwards of one or more source trees on one GPU,
queued, with the library call in turns, and the two kernels next in line
behind their library calls.

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
(``chip_smoke.bf16_ulps``). Then, the same way, the backward kernels K8b·bf16
at training batch 12 (autograd through the library call on the partitioned
windows and their dense bias) and K10b·bf16 at the prompt-large 4 stage
(12, 256, 256, 16 -> 16; autograd through ``F.conv_transpose2d``), their
first output (dqkv, dx) read by the same ulp measure; K2b·bf16 on its
training windows (B·108, 196, 64) at batch 12 on K2's own output and lse,
without the tables' gradients (autograd through the library call on the
head-major windows and their dense bias); and K10b·bf16 at prompt-large 2
and 3 (12, 64, 64, 64 -> 32; 12, 128, 128, 32 -> 16), UNet 4 (12, 128, 128,
64 -> 32) and SAM 2 (1, 64, 64, 64 -> 32) as well, on the route the tree's
rule names (a parent tree without the one pass times the tile products
there: the timing behind the one pass's route rule). For K2, K3, K6, K7 and K8 it also prints the
bound (the function's 4 D flops a (query, key) pair at 989 TFLOP/s dense bfloat16,
or its bytes at 3.35 TB/s, as ``chip_smoke.bf16_bound``) and the warpgroup
design's floor: the flops and exponentials of the pairs it computes, at 989
TFLOP/s and at ~3.9e12 exponentials a second (16 a clock an SM, 132 SMs,
1.83 GHz), whichever is larger, and both a (query, key) pair of the
function. Rows are padded to 64-query tiles and keys to the products'
widths: two walks (K3, K6, and K7 on 1024 keys) compute S twice over
128-key steps at S's depth (128 on the 32 x 32 grid, 96 on 14 x 14 windows,
64 for K7) and P . V once, 2 exponentials a pair; one walk (K2 and K7 on
196-token windows) computes S once over 200 keys (depth 96; K7 64) and
P . V over 208, 1 exponential a pair; K8 computes only the query tiles that
hold a real query slot (25 a head of a 32 x 32 grid at ws 14), each over the
window's 196 slots, pad slots included. K2's rel terms (CUDA cores) are left
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
    from mia_tpu_torch.ops import upsample2x as up
    from mia_tpu_torch.ops.ln_window import window_partition

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

    def yardsticks(label, tensors, bh, n, depth, one_walk, flops=0, pairs=None, rows=None):
        """The bound of bh grids of n x n (query, key) pairs (``flops``: any
        the function does besides 4 D a pair), and the floor of the design
        at S's depth, walking the keys once or twice; ``pairs`` and ``rows``
        (the query rows of the tiles computed) where they are not bh n n and
        bh n padded to 64."""
        pairs = pairs or bh * n * n
        bound = cs.bf16_bound(tensors, pairs * 4 * d + flops)
        rows = rows or bh * -(-n // 64) * 64
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
    # K8's query tiles that hold a real query slot: of the 3 x 3 windows of a 32 x 32 grid,
    # 4 whole (4 tiles), 2 of 14 rows x 4 columns (slots to 186: 3), 2 of 4 rows x 14 columns
    # (56 slots: 1), the 4 x 4 corner (46 slots: 1)
    side_rows = [min(ws, 32 - y) for y in range(0, 32, ws)]
    k8_tiles = sum(-(-((hr - 1) * ws + wr) // 64) for hr in side_rows for wr in side_rows)
    for b in (1, 8):
        args8 = (randn(b, 32, 32, 3 * heads * d), randn(b * heads, 32, 32, ws),
                 randn(b * heads, 32, 32, ws), randn(3, heads * d, scale_=0.5), scale, ws, heads)
        lib_args = cs.windows_for_library(*args8[:4], ws, heads)
        out8 = torch.empty(b, 32, 32, heads * d, dtype=bf)
        yardsticks(f"K8 B={b}", [*args8[:4], out8], b * heads, ws * ws, 96, True,
                   pairs=b * heads * 1024 * ws * ws, rows=b * heads * k8_tiles * 64)
        calls.append((f"K8 B={b}", functools.partial(attention._launch_k8, *args8),
                      functools.partial(attention.attention_rel_win_bf16, *args8),
                      functools.partial(sdpa, *lib_args[:3], attn_mask=lib_args[3], scale=scale),
                      50 if b == 1 else 10))
    # the kernels next in line: K8b at training batch 12 on K8's own output and lse
    b = 12
    fwd8 = (randn(b, 32, 32, 3 * heads * d), randn(b * heads, 32, 32, ws),
            randn(b * heads, 32, 32, ws), randn(3, heads * d, scale_=0.5))
    out8, lse8 = attention._launch_k8(*fwd8, scale, ws, heads, with_lse=True)
    g8 = randn(b, 32, 32, heads * d)
    bargs8 = (*fwd8, out8, g8, lse8, scale, ws, heads)
    g_w = window_partition(g8, ws)[0].view(-1, ws * ws, heads, d).transpose(1, 2).contiguous()
    calls.append(("K8b B=12", functools.partial(attention._launch_k8_bwd, *bargs8),
                  functools.partial(attention.attention_rel_win_bwd_bf16, *bargs8),
                  cs.sdpa_backward_call(torch, *cs.windows_for_library(*fwd8, ws, heads), scale,
                                        g_w), 5))
    # K2b at training batch 12 on its windows (108 of 14 x 14 tokens, 12 heads) on K2's own
    # output and lse, without the tables' gradients (frozen in training, as the smoke times it)
    rh2, rw2 = randn(ws * ws, d, scale_=0.1), randn(ws * ws, d, scale_=0.1)
    qkv2 = randn(108, ws * ws, 3 * heads * d)
    out2, lse2 = attention._launch_k2(qkv2, rh2, rw2, scale, (ws, ws), heads, with_lse=True)
    g2 = randn(108, ws * ws, heads * d)
    bargs2 = (qkv2, rh2, rw2, out2, g2, lse2, scale, (ws, ws), heads, False)
    r_h2, r_w2 = attention.window_rel_terms(qkv2, rh2, rw2, (ws, ws), heads)
    g2_l = g2.view(108, ws * ws, heads, d).transpose(1, 2).contiguous()
    calls.append(("K2b B=12", functools.partial(attention._launch_k2_bwd, *bargs2),
                  functools.partial(attention.attention_rel_packed_ik_bwd_bf16, *bargs2),
                  cs.sdpa_backward_call(torch, *cs.head_major(qkv2, heads),
                                        cs.dense_bias(r_h2, r_w2, 108, heads), scale, g2_l), 5))
    # K10b at the prompt-large stages 2-4, UNet 4 and SAM 2 on the tree's own route, the library
    # on NCHW views of the same bfloat16 operands
    for stage, (b10, h10, cin, cout) in (("prompt-large 2", (12, 64, 64, 32)),
                                         ("prompt-large 3", (12, 128, 32, 16)),
                                         ("prompt-large 4", (12, 256, 16, 16)),
                                         ("UNet 4", (12, 128, 64, 32)), ("SAM 2", (1, 64, 64, 32))):
        x, wt = randn(b10, h10, h10, cin), randn(2, 2, cin, cout, scale_=cin ** -0.5)
        dy = randn(b10, 2 * h10, 2 * h10, cout)
        x_l = x.permute(0, 3, 1, 2).detach().requires_grad_()
        w_l = wt.permute(2, 3, 0, 1).contiguous().requires_grad_()
        b_l = torch.zeros(cout, device=device, dtype=bf, requires_grad=True)
        lib_out = torch.nn.functional.conv_transpose2d(x_l, w_l, b_l, stride=2)
        library = functools.partial(torch.autograd.grad, lib_out, [x_l, w_l, b_l],
                                    dy.permute(0, 3, 1, 2), retain_graph=True)
        plain = functools.partial(up.conv_transpose2x_bwd_plain_bf16, x, wt, dy)
        taken = up.k10_routes(tuple(x.shape), cout, bf)
        route = "/".join(sorted({taken["dx"], taken["dw"]}))
        calls.append((f"K10b {stage} ({route})", functools.partial(up._launch_k10_bwd, x, wt, dy),
                       plain, library, 5 if b10 * h10 * h10 > 100000 else 20))
    for label, kernel, plain, library, per_block in calls:
        got, want = kernel(), plain()
        if isinstance(got, tuple):  # a backward: its first output (dqkv, dx)
            got, want = got[0], want[0]
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
