#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``mia_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--out DIR]

1. Prints the card (``nvidia-smi`` name and power limit) and the CUDA version.
2. Builds the hand-written kernels from ``mia_tpu_torch/csrc`` with nvcc
   (one nvcc per source, in parallel, then one link).
3. Kernel phase: holds K1 (the affine-warp kernel) against its plain PyTorch
   version on the card — 60 recipe-range matrices at (12, 256, 256, 4), the
   identity, an all-out-of-source map and odd shapes — bit for bit; and K2,
   K3, K4 (windowed and global rel-pos attention, LayerNorm + window
   partition) against theirs at the ViT-B/512 serving shapes for batch 1 and
   8, a 20x27 token grid, 4096 global tokens and the ViT-H head dim 80 (16
   heads), within 1e-5 of max |plain|. K6, K7, K8, K9 (head-major rel-pos
   attention, dense-bias attention, grid-native windowed attention,
   unpartition + residual + LayerNorm) the same way at the serving shapes
   for batch 1 and 8, a 20x27 grid (K8, K9), a non-aligned token count (K6,
   K7) and head dim 80, through the public wrappers; K9's x_new bit for bit.
   Times each kernel and its plain version in turns with CUDA events, and,
   for the attention kernels, one ``scaled_dot_product_attention`` call on
   the same inputs with the dense bias built beforehand (``library_ms``;
   the port never calls it). Computes each kernel's bound from the timed
   tensors: bytes over 3.35 TB/s or operations over 67 TFLOP/s (float32
   outside the tensor cores, what every kernel here computes in).
   Training kernels: the backward kernels of K2, K3 and K4 against their
   plain VJPs at the ViT-B/512 training shapes for batch 12 and 6, within
   1e-4 of max |plain| for each output, and K5 (connected components, 16
   sweeps) bit for bit on 3 x 12 x 4 class masks of 64x64 pseudo-labels
   (blob, speckled, empty, full) and on a 512x512 stack; timed the same way.
   The backward kernels of K6, K8 and K9 the same way (K6b at the windowed
   and the global shapes, a non-aligned token count and head dim 80; K8b and
   K9b also on a 20x27 grid, K8b on a grid of whole windows, where dbias_kv
   is exactly zero; K9b's pad slots exactly zero), their library time
   autograd through one ``scaled_dot_product_attention`` call.
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
   CPC-SAM phase: runs ``cpcsam_train_torch``'s ``train_entry`` with the
   entry's defaults (LoRA-4 ViT-B/512 ``SamDualmask``, 3 decoders, batch 12,
   half labeled, ``--promptmode point``) for 2 phase-1 and 4 phase-2 steps
   on an in-memory synthetic ACDC set at 512x512 (the GPU machine has no
   h5py). Checks the kernel launches of every step against the derived
   counts, finite losses, that the LoRA tensors moved and every frozen
   parameter stayed bit-identical, the validation, real test and
   checkpoints, and one phase-1 loss and its LoRA gradients on the card
   against the CPU. Prints the step times and peak memory. Then two more
   runs of one phase-1 and one phase-2 step each: ``--use-contrastive-loss``
   (finite losses, loss3 non-zero exactly when a class holds two memory rows,
   the heads moved, frozen parameters bit-identical, a checkpoint with the
   training state) and ``--use-adv-loss --resume`` from that checkpoint
   (resumes at iteration 2 with the saved parameters, optimizer count and
   memory; VAT loss positive).
   Route-training phase: the trained CPC-SAM model with seeded rel-pos
   tables and, in its place, the encoder of each other route (K9 exit,
   grid-native by argument and by ``MIA_WINDOWED_ATTN=1``, head-major, no
   rel-pos) takes one phase-1 loss and backward at batch 12 (6 labeled):
   exact launch counts of the forward and backward kernels, the loss within
   1e-5 and the LoRA gradients within 1e-4 of max |grad| of the default
   route's (the no-rel-pos variant against the default with zeroed tables),
   its time and peak memory beside the default's, and one full
   ``CPCSAMTrainer.train_step``.
5. SAM phase: builds ``sam_model_registry["vit_b"](512, 3)`` with seeded
   random weights on ``cuda`` and serves a seeded 480x640 uint8 frame
   through ``SamPredictor``: ``set_image``, ``predict`` with a point, a box,
   and point + box + the previous low-res mask, ``predict_batch`` with 16
   point prompts. Checks shapes, finite values, 8 K2, 4 K3 and 8 K4 launches
   per ``set_image``, and the embedding, masks and iou on the card against
   the same weights on the CPU. Prints the latencies and the encoder's
   img/s at batch 8.
6. Encoder-route phase: loads the SAM phase's weights into an
   ``ImageEncoderViT`` of each other route (K9 exit; grid-native K8, once
   by argument and once by ``MIA_WINDOWED_ATTN=1``; head-major K6; no
   rel-pos K7), puts it in the model's place and runs ``set_image`` on the
   480x640 frame: exact launch counts, the embedding within 1e-4 of the
   default's (the no-rel-pos variant against the default with zeroed
   tables), and each variant's ``set_image`` median beside the default's.
   AMG phase: ``SamAutomaticMaskGenerator(predictor, points_per_side=32,
   points_per_batch=64)`` on a seeded 512x512 frame (16 chunks; median of 3
   ``generate`` calls, candidate masks per second), one ``generate`` with
   keep-everything thresholds at 16x16 points (gather, NMS, boxes, RLE:
   every record consistent), one chunk's scores on the card against the
   CPU, and one run on the grid-native encoder (K8 under AMG).
7. Prints one JSON line with the 15 kernels (K1-K9, forward, and the
   backward kernels K2b-K4b, K6b, K8b, K9b, with their launches in the paths
   that ran them, their bounds and library times), then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, when there is no CUDA device, when it is
not next to the package it tests, or when any phase fails. ``--out DIR``
also writes the trainers' logs and the JSON lines into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
# name, source, TPU kernel it replaces (function reaching pl.pallas_call)
KERNELS = {
    "K1": ("affine_warp_shift2pass (K1)", "mia_tpu_torch/csrc/affine_warp.cu",
           "mia_tpu/ops/warp.py:300"),
    "K2": ("fused_attention_rel_packed_ik (K2)", "mia_tpu_torch/csrc/attention_rel.cu",
           "mia_tpu/ops/attention.py:923"),
    "K2b": ("fused_attention_rel_packed_ik backward (K2)", "mia_tpu_torch/csrc/attention_rel.cu",
            "mia_tpu/ops/attention.py:1076"),
    "K3": ("fused_attention_rel_packed (K3)", "mia_tpu_torch/csrc/attention_rel.cu",
           "mia_tpu/ops/attention.py:605"),
    "K3b": ("fused_attention_rel_packed backward (K3)", "mia_tpu_torch/csrc/attention_rel.cu",
            "mia_tpu/ops/attention.py:712"),
    "K4": ("ln_window_partition (K4)", "mia_tpu_torch/csrc/ln_window.cu",
           "mia_tpu/ops/ln_window.py:230"),
    "K4b": ("ln_window_partition backward (K4)", "mia_tpu_torch/csrc/ln_window.cu",
            "mia_tpu/ops/ln_window.py:178"),
    "K5": ("connected_components_pallas (K5)", "mia_tpu_torch/csrc/connected_components.cu",
           "mia_tpu/ops/morphology.py:235"),
    "K6": ("fused_attention_rel (K6)", "mia_tpu_torch/csrc/attention_routes.cu",
           "mia_tpu/ops/attention.py:296"),
    "K6b": ("fused_attention_rel backward (K6)", "mia_tpu_torch/csrc/attention_routes.cu",
            "mia_tpu/ops/attention.py:429"),
    "K7": ("fused_attention (K7)", "mia_tpu_torch/csrc/attention_routes.cu",
           "mia_tpu/ops/attention.py:88"),
    "K8": ("fused_attention_rel_win (K8)", "mia_tpu_torch/csrc/attention_routes.cu",
           "mia_tpu/ops/attention.py:1334"),
    "K8b": ("fused_attention_rel_win backward (K8)", "mia_tpu_torch/csrc/attention_routes.cu",
            "mia_tpu/ops/attention.py:1509"),
    "K9": ("unpartition_add_ln (K9)", "mia_tpu_torch/csrc/unpartition_residual.cu",
           "mia_tpu/ops/unpartition_residual.py:221"),
    "K9b": ("unpartition_add_ln backward (K9)", "mia_tpu_torch/csrc/unpartition_residual.cu",
            "mia_tpu/ops/unpartition_residual.py:161"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores: what every kernel here computes in
KERNEL_TOL = 1e-5  # forward kernels: max |kernel - plain| over max |plain|, float32
BWD_TOL = 1e-4  # backward kernels, per output (float32; another summation order, p from the lse)


def counters():
    """Every kernel wrapper's launch counter, by kernel key."""
    from mia_tpu_torch.ops import attention, ln_window, morphology, unpartition_residual, warp

    return {"K6": attention.fused_attention_rel,
            "K6b": attention.fused_attention_rel_bwd,
            "K7": attention.fused_attention,
            "K8": attention.fused_attention_rel_win,
            "K8b": attention.fused_attention_rel_win_bwd,
            "K9": unpartition_residual.unpartition_add_ln,
            "K9b": unpartition_residual.unpartition_add_ln_fused_bwd,
            "K1": warp.affine_warp_shift2pass_fused,
            "K2": attention.fused_attention_rel_packed_ik,
            "K2b": attention.fused_attention_rel_packed_ik_bwd,
            "K3": attention.fused_attention_rel_packed,
            "K3b": attention.fused_attention_rel_packed_bwd,
            "K4": ln_window.ln_window_partition_fused,
            "K4b": ln_window.ln_window_partition_fused_bwd,
            "K5": morphology.connected_components_fused}


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


def turns_ms(torch, kernel, plain, per_block, plain_per_block=None):
    """Kernel and plain version timed in turns (plain, kernel, kernel, plain);
    a plain version of tens of milliseconds takes fewer calls a block."""
    per_plain = plain_per_block or per_block
    plain_a = time_ms(plain, torch, per_block=per_plain, warmup=min(10, per_plain))
    k_a = time_ms(kernel, torch, per_block=per_block)
    k_b = time_ms(kernel, torch, per_block=per_block)
    plain_b = time_ms(plain, torch, per_block=per_plain, warmup=min(10, per_plain))
    return (k_a, k_b), (plain_a, plain_b)


def bound(tensors, flops):
    """The least time (ms) the card could take: every tensor of ``tensors``
    (the inputs and the outputs) crossing device memory once at 3.35 TB/s, or
    ``flops`` float32 operations at 67 TFLOP/s, whichever is larger, and
    which of the two it is."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def attention_flops(batch_heads, queries, keys, d, backward=False):
    """q.kT and p.v (forward: 4·D a query-key pair); the backward recomputes
    the scores and adds dp, dv, dq, dk (10·D a pair)."""
    return batch_heads * queries * keys * (10 if backward else 4) * d


def describe_yardsticks(m):
    lib = "none" if m["library_ms"] is None else f"{m['library_ms'] * 1e3:.2f} us"
    return (f"bound {m['bound_ms'] * 1e3:.2f} us by {m['bound_by']}, library call {lib}")


def forward_holder(torch, worst):
    """``hold(name, label, got, want)``: fail unless the forward kernel's
    output is finite, of the plain version's shape and within ``KERNEL_TOL``
    of max |plain|; keeps the worst absolute and relative error by kernel."""

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        check(got.shape == want.shape, f"{name} {label}: shape {tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        check(err <= KERNEL_TOL * ref,
              f"{name} {label}: max |kernel - plain| {err} > {KERNEL_TOL} x max |plain| {ref}")
        worst[name] = [max(worst[name][0], err), max(worst[name][1], err / ref)]

    return hold


def backward_holder(torch, worst):
    """``hold(name, label, got, want)``: fail unless every output of the
    backward kernel is present where the plain VJP's is, finite, of its shape
    and within ``BWD_TOL`` of max |plain| (exactly zero where the plain one
    is); keeps the worst absolute and relative error by kernel."""

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        check(len(got) == len(want), f"{name} {label}: {len(got)} outputs, expected {len(want)}")
        for i, (a, b) in enumerate(zip(got, want)):
            check((a is None) == (b is None), f"{name} {label}: output {i} present in one version only")
            if b is None:
                continue
            check(a.shape == b.shape, f"{name} {label}: output {i} shape {tuple(a.shape)}")
            check(bool(torch.isfinite(a).all()), f"{name} {label}: output {i} not finite")
            err, ref = (a - b).abs().max().item(), b.abs().max().item()
            check(err <= BWD_TOL * ref,
                  f"{name} {label}: output {i} max |kernel - plain| {err} > {BWD_TOL} x {ref}")
            worst[name] = [max(worst[name][0], err), max(worst[name][1], err / ref if ref else 0.0)]

    return hold


def head_major(qkv, heads):
    """Packed (B, N, 3·H·D) qkv → contiguous q, k, v (B, H, N, D)."""
    b, n, _ = qkv.shape
    return tuple(t.contiguous() for t in qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4))


def dense_bias(rel_h, rel_w, batch, heads):
    """Factored rel terms (B·H, N, k_h), (B·H, N, k_w) → (B, H, N, N)."""
    n = rel_h.shape[1]
    return (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(batch, heads, n, n).contiguous()


def windows_for_library(qkv, rel_h, rel_w, bias_kv, ws, n_heads):
    """K8's operands partitioned ahead of the library call: (B·nW, H, ws², D)
    q, k, v with the pad slots filled, and the dense (B·nW, H, ws², ws²) bias."""
    from mia_tpu_torch.ops import attention

    windows, rel_h, rel_w = attention.partition_rel_win(qkv, rel_h, rel_w, bias_kv, ws, n_heads)
    return (*head_major(windows, n_heads), dense_bias(rel_h, rel_w, windows.shape[0], n_heads))


def sdpa_ms(torch, q, k, v, bias, scale, per_block):
    """One ``F.scaled_dot_product_attention`` call on (B, H, N, D) operands
    and a dense additive bias built beforehand: the library yardstick."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: sdpa(q, k, v, attn_mask=bias, scale=scale), torch, per_block=per_block)


def sdpa_backward_ms(torch, q, k, v, bias, scale, g, per_block):
    """Autograd through one ``scaled_dot_product_attention`` call (dq, dk, dv
    and the bias gradient) for the cotangent ``g``; the forward is outside
    the timed call."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                                           scale=scale)
    return time_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), torch,
                   per_block=per_block)


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
    (k1_a, k1_b), (plain_a, plain_b) = turns_ms(torch, lambda: warp._launch_k1(img, *idx),
                                                lambda: warp._shift2pass_gather(img, *idx), 50)
    k1_ms, plain_ms = min(k1_a, k1_b), min(plain_a, plain_b)
    print(f"K1 bit-exact vs plain on {len(cases)} cases (max |diff| {max_err})")
    print(f"K1 at (12, 256, 256, 4): kernel {k1_a * 1e3:.2f} / {k1_b * 1e3:.2f} us, "
          f"plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us (median of 11 x 50 launches)")
    # one gather per output element: no arithmetic to speak of
    return {"max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms, "library_ms": None,
            **bound([img, img, *idx], 0)}


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

# ---------------------------------------------------------------------------
# K2, K3, K4 against their plain versions
# ---------------------------------------------------------------------------


def sam_kernel_phase(torch, device):
    from mia_tpu_torch.ops import attention, ln_window

    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def randn(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(shape, generator=gen, device=device) + shift

    heads, d, ws, c = 12, 64, 14, 768
    scale = d ** -0.5
    worst = {k: [0.0, 0.0] for k in ("K2", "K3", "K4")}  # max abs err, max relative err

    hold = forward_holder(torch, worst)
    ln_scale, ln_bias = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.1, shift=0.5)
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    inputs = {}
    for label, grid_shape, n_win in (("B=1", (1, 32, 32, c), 9), ("B=8", (8, 32, 32, c), 72),
                                     ("grid 20x27", (2, 20, 27, c), 8)):
        x = randn(*grid_shape)
        got = ln_window._launch_k4(x, ln_scale, ln_bias, ws, 1e-6)
        want = ln_window.ln_window_partition(x, ln_scale, ln_bias, ws)
        hold("K4", label, got, want)
        check(not got[want == 0].any(), f"K4 {label}: pad slots are not zero")
        qkv = randn(n_win, ws * ws, 3 * heads * d)
        hold("K2", label, attention._launch_k2(qkv, rh, rw, scale, (ws, ws), heads),
             attention.attention_rel_packed_ik(qkv, rh, rw, scale, (ws, ws), heads))
        inputs[("K4", label)] = (x, ln_scale, ln_bias, ws, 1e-6)
        inputs[("K2", label)] = (qkv, rh, rw, scale, (ws, ws), heads)
    for label, b, side in (("B=1", 1, 32), ("B=8", 8, 32), ("4096 tokens", 1, 64)):
        n = side * side
        qkv = randn(b, n, 3 * heads * d)
        rel_h, rel_w = randn(b * heads, n, side), randn(b * heads, n, side)
        args = (qkv, rel_h, rel_w, scale, (side, side), heads)
        hold("K3", label, attention._launch_k3(*args), attention.attention_rel_packed(*args))
        inputs[("K3", label)] = args
    # the head-dim-80 instances of the template (ViT-H at 512²: 16 heads)
    h_heads, h_d = 16, 80
    qkv = randn(9, ws * ws, 3 * h_heads * h_d)
    rh80, rw80 = randn(ws * ws, h_d, scale=0.1), randn(ws * ws, h_d, scale=0.1)
    args = (qkv, rh80, rw80, h_d ** -0.5, (ws, ws), h_heads)
    hold("K2", "head dim 80", attention._launch_k2(*args), attention.attention_rel_packed_ik(*args))
    qkv = randn(1, 1024, 3 * h_heads * h_d)
    args = (qkv, randn(h_heads, 1024, 32), randn(h_heads, 1024, 32), h_d ** -0.5, (32, 32), h_heads)
    hold("K3", "head dim 80", attention._launch_k3(*args), attention.attention_rel_packed(*args))
    print("K2 and K3 at head dim 80 (16 heads; 9 windows of 196 tokens, 1024 global tokens) "
          f"within {KERNEL_TOL} of max |plain|")

    def bound_and_library(name):
        """The bound of the B=1 launch and, for K2 and K3, the library call
        on the same operands (the dense bias is built outside the timed call)."""
        args = inputs[(name, "B=1")]
        if name == "K4":
            x = args[0]
            out = ln_window.ln_window_partition(*args)
            # sum, sum of squares, normalise, scale and shift: ~8 operations an element;
            # no single PyTorch call normalises and partitions
            return {"library_ms": None, **bound([x, args[1], args[2], out], 8 * x.numel())}
        qkv, rel_a, rel_b, sc, k_hw, n_heads = args
        b, n, _ = qkv.shape
        flops = attention_flops(b * n_heads, n, n, d)
        if name == "K2":  # the rel terms are part of the function: 2·D a (query, k_h + k_w) pair
            flops += b * n_heads * n * sum(k_hw) * 2 * d
            rel_h, rel_w = attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, n_heads)
        else:
            rel_h, rel_w = rel_a, rel_b
        out = torch.empty(b, n, n_heads * d, device=device)
        lib = sdpa_ms(torch, *head_major(qkv, n_heads), dense_bias(rel_h, rel_w, b, n_heads), sc, 50)
        return {"library_ms": lib, **bound([qkv, rel_a, rel_b, out], flops)}

    fns = {"K2": (attention._launch_k2, attention.attention_rel_packed_ik),
           "K3": (attention._launch_k3, attention.attention_rel_packed),
           "K4": (ln_window._launch_k4, ln_window.ln_window_partition)}
    out = {}
    for name, (kernel, plain) in fns.items():
        for label in ("B=1", "B=8"):
            args = inputs[(name, label)]
            per_block = 50 if label == "B=1" else 10
            (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: kernel(*args),
                                                      lambda: plain(*args), per_block)
            print(f"{name} at ViT-B/512 {label}: kernel {k_a * 1e3:.2f} / {k_b * 1e3:.2f} us, "
                  f"plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us "
                  f"(median of 11 x {per_block} launches)")
            if label == "B=1":
                out[name] = {"max_abs_err": worst[name][0], "ms": min(k_a, k_b),
                             "plain_ms": min(plain_a, plain_b), **bound_and_library(name)}
                print(f"{name} at ViT-B/512 B=1: {describe_yardsticks(out[name])}")
        print(f"{name} within {KERNEL_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})")
    return out


# ---------------------------------------------------------------------------
# the backward kernels of K2, K3, K4 and K5 against their plain versions
# ---------------------------------------------------------------------------


def label_maps(torch, gen, n, size, device, classes=4):
    """Seeded (n, size, size) pseudo-labels, cycling through four kinds:
    ellipse blobs, speckle (per-pixel classes: not converged in 16 sweeps),
    a map of class 0 only (every other class mask empty) and one class
    covering the map (its mask full)."""
    yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device),
                            indexing="ij")
    maps = []
    for i in range(n):
        kind = i % 4
        if kind == 0:
            m = torch.zeros(size, size, dtype=torch.int64, device=device)
            for c in range(1, classes):
                cy, cx = (torch.rand(2, generator=gen, device=device) * size).tolist()
                ry, rx = (4 + torch.rand(2, generator=gen, device=device) * size / 5).tolist()
                m[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1] = c
        elif kind == 1:
            m = torch.randint(0, classes, (size, size), generator=gen, device=device)
        else:
            m = torch.full((size, size), 0 if kind == 2 else 1 + (i // 4) % (classes - 1),
                           device=device)
        maps.append(m)
    return torch.stack(maps)


def class_masks(torch, maps, classes=4):
    """(n, H, W) labels → (n·classes, H, W) int32 class masks, as prompt
    generation splits them."""
    cls = torch.arange(classes, device=maps.device)
    return (maps[:, None] == cls[None, :, None, None]).to(torch.int32).flatten(0, 1)


def train_kernel_phase(torch, device):
    from mia_tpu_torch.ops import attention, ln_window, morphology

    gen = torch.Generator(device=device)
    gen.manual_seed(3)

    def randn(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(shape, generator=gen, device=device) + shift

    heads, d, ws, c, side = 12, 64, 14, 768, 32
    scale = d ** -0.5
    worst = {k: [0.0, 0.0] for k in ("K2b", "K3b", "K4b")}

    hold = backward_holder(torch, worst)
    ln_scale, ln_bias = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.1, shift=0.5)
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    timed = {}
    for label, b in (("B=12", 12), ("B=6", 6)):
        x = randn(b, side, side, c)
        y, mu, rstd = ln_window._launch_k4(x, ln_scale, ln_bias, ws, 1e-6, with_stats=True)
        dy = randn(*y.shape)
        for params in (False, True):
            args = (x, dy, mu, rstd, ln_scale, ws, params)
            hold("K4b", f"{label} params={params}", ln_window._launch_k4_bwd(*args),
                 ln_window.ln_window_partition_bwd(*args))
        timed[("K4b", label)] = (x, dy, mu, rstd, ln_scale, ws, False)

        qkv = randn(b * 9, ws * ws, 3 * heads * d)
        out, lse = attention._launch_k2(qkv, rh, rw, scale, (ws, ws), heads, with_lse=True)
        g = randn(b * 9, ws * ws, heads * d)
        for tables in (False, True):
            hold("K2b", f"{label} tables={tables}",
                 attention._launch_k2_bwd(qkv, rh, rw, out, g, lse, scale, (ws, ws), heads, tables),
                 attention.attention_rel_packed_ik_bwd(qkv, rh, rw, out, g, scale, (ws, ws), heads,
                                                       tables))
        timed[("K2b", label)] = ((qkv, rh, rw, out, g, lse, scale, (ws, ws), heads, False),
                                 (qkv, rh, rw, out, g, scale, (ws, ws), heads, False))

        qkv = randn(b, side * side, 3 * heads * d)
        rel_h, rel_w = randn(b * heads, side * side, side), randn(b * heads, side * side, side)
        out, lse = attention._launch_k3(qkv, rel_h, rel_w, scale, (side, side), heads, with_lse=True)
        g = randn(b, side * side, heads * d)
        kernel_args = (qkv, rel_h, rel_w, out, g, lse, scale, (side, side), heads)
        plain_args = (qkv, rel_h, rel_w, out, g, scale, (side, side), heads)
        hold("K3b", label, attention._launch_k3_bwd(*kernel_args),
             attention.attention_rel_packed_bwd(*plain_args))
        timed[("K3b", label)] = (kernel_args, plain_args)

    # K5: 12 images x 3 decoders of 4-class pseudo-labels at the prompt
    # compute size, and one native-size stack through the global scratch path
    k5_cases = {"(144, 64, 64)": class_masks(torch, label_maps(torch, gen, 36, 64, device)),
                "(4, 512, 512)": label_maps(torch, gen, 4, 512, device).clamp(max=1).to(torch.int32)}
    for label, masks in k5_cases.items():
        got = morphology._launch_k5(masks)
        want = morphology.connected_components(masks)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and torch.equal(got, want),
              f"K5 {label}: labels differ from the plain version "
              f"({int((got != want).sum())} of {want.numel()})")
        unconverged = not torch.equal(want, morphology.connected_components(masks, max_iters=64))
        print(f"K5 bit-exact vs plain on {label}; 16 sweeps leave some mask unconverged: "
              f"{unconverged}")

    def bound_and_library(name, args):
        """The bound of the B=12 launch and, for K2b and K3b, autograd through
        the library call on the same operands."""
        if name == "K4b":
            x, dy, mu, rstd, ln_w = args[:5]
            # two row reductions and the VJP's combination: ~12 operations an element;
            # of the windowed cotangent only the real tokens' slots are needed (the pad
            # slots never reach dx), as many elements as x has; no single PyTorch call
            # is this VJP on the windowed cotangent
            check(dy.numel() > x.numel(), "K4b: the timed shape has no pad slots")
            return {"library_ms": None, **bound([x, x, mu, rstd, ln_w, x], 12 * x.numel())}
        qkv, rel_a, rel_b, o, g, _, sc, k_hw, n_heads = args[:9]
        b, n, _ = qkv.shape
        flops = attention_flops(b * n_heads, n, n, d, backward=True)
        if name == "K2b":  # the rel terms again, and their cotangent routed into dq
            flops += b * n_heads * n * sum(k_hw) * 4 * d
            rel_h, rel_w = attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, n_heads)
            moved = [qkv, rel_a, rel_b, o, g, qkv]  # lse is the forward's by-product
        else:
            rel_h, rel_w = rel_a, rel_b
            moved = [qkv, rel_a, rel_b, o, g, qkv, rel_a, rel_b]
        g4 = g.view(b, n, n_heads, d).transpose(1, 2).contiguous()
        lib = sdpa_backward_ms(torch, *head_major(qkv, n_heads),
                               dense_bias(rel_h, rel_w, b, n_heads), sc, g4, 10)
        return {"library_ms": lib, **bound(moved, flops)}

    fns = {"K2b": (attention._launch_k2_bwd, attention.attention_rel_packed_ik_bwd),
           "K3b": (attention._launch_k3_bwd, attention.attention_rel_packed_bwd),
           "K4b": (ln_window._launch_k4_bwd, ln_window.ln_window_partition_bwd)}
    out = {}
    for name, (kernel, plain) in fns.items():
        for label in ("B=12", "B=6"):
            args = timed[(name, label)]
            k_args, p_args = args if name != "K4b" else (args, args)
            per_block = 10 if label == "B=12" else 5
            (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: kernel(*k_args),
                                                      lambda: plain(*p_args), per_block)
            print(f"{name} at ViT-B/512 training {label}: kernel {k_a * 1e3:.2f} / "
                  f"{k_b * 1e3:.2f} us, plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us "
                  f"(median of 11 x {per_block} launches)")
            if label == "B=12":
                out[name] = {"max_abs_err": worst[name][0], "ms": min(k_a, k_b),
                             "plain_ms": min(plain_a, plain_b), **bound_and_library(name, k_args)}
                print(f"{name} at ViT-B/512 training B=12: {describe_yardsticks(out[name])}")
        print(f"{name} within {BWD_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})")
    masks = k5_cases["(144, 64, 64)"]
    (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: morphology._launch_k5(masks),
                                              lambda: morphology.connected_components(masks), 10,
                                              plain_per_block=2)
    print(f"K5 at (144, 64, 64): kernel {k_a * 1e3:.2f} / {k_b * 1e3:.2f} us (median of 11 x 10 "
          f"launches), plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us (median of 11 x 2 calls)")
    # 16 sweeps of four directional scans and a diagonal min: ~8 integer operations a
    # pixel and sweep, counted at the CUDA cores' float32 rate; no PyTorch call labels
    # connected components
    out["K5"] = {"max_abs_err": 0.0, "ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
                 "library_ms": None, **bound([masks, masks], 16 * 8 * masks.numel())}
    print(f"K5 at (144, 64, 64): {describe_yardsticks(out['K5'])}")
    return out


# ---------------------------------------------------------------------------
# K6, K7, K8, K9 against their plain versions
# ---------------------------------------------------------------------------


def route_kernel_phase(torch, device):
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops import unpartition_residual as upr

    gen = torch.Generator(device=device)
    gen.manual_seed(4)

    def randn(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(shape, generator=gen, device=device) + shift

    heads, ws, c = 12, 14, 768
    worst = {k: [0.0, 0.0] for k in ("K6", "K7", "K8", "K9")}
    hold = forward_holder(torch, worst)
    inputs = {}

    # K6 and K7: head-major operands of one ViT-B/512 image (9 windows x 12
    # heads of 196 tokens; 12 heads of 1024 global tokens), of 8 images, a
    # token count no tile divides, and the ViT-H head dim
    for label, bh, d, k_hw in (("B=1 windows", 108, 64, (14, 14)), ("B=1 global", 12, 64, (32, 32)),
                               ("B=8 windows", 864, 64, (14, 14)), ("B=8 global", 96, 64, (32, 32)),
                               ("N=120 (10x12)", 6, 64, (10, 12)),
                               ("head dim 80", 144, 80, (14, 14))):
        n = k_hw[0] * k_hw[1]
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        args = (q, k, v, randn(bh, n, k_hw[0]), randn(bh, n, k_hw[1]), d ** -0.5, k_hw)
        hold("K6", label, attention.fused_attention_rel(*args), attention.attention_rel(*args))
        inputs[("K6", label)] = args
        args = (q, k, v, randn(bh, n, n), d ** -0.5)
        hold("K7", label, attention.fused_attention(*args), attention.attention_dense(*args))
        inputs[("K7", label)] = args
    # K8: the unpartitioned qkv grid; 32x32 pads each edge window, 20x27 both ways
    for label, b, hw, n_heads, d in (("B=1", 1, (32, 32), heads, 64), ("B=8", 8, (32, 32), heads, 64),
                                     ("grid 20x27", 2, (20, 27), heads, 64),
                                     ("head dim 80", 1, (32, 32), 16, 80)):
        args = (randn(b, *hw, 3 * n_heads * d), randn(b * n_heads, *hw, ws),
                randn(b * n_heads, *hw, ws), randn(3, n_heads * d, scale=0.5), d ** -0.5, ws, n_heads)
        hold("K8", label, attention.fused_attention_rel_win(*args),
             attention.attention_rel_win(*args))
        inputs[("K8", label)] = args
    # K9: windows whose pad slots hold values that must not reach the output
    ln_scale, ln_bias = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.1, shift=0.5)
    for label, shape in (("B=1", (1, 32, 32, c)), ("B=8", (8, 32, 32, c)),
                         ("grid 20x27", (2, 20, 27, c))):
        n_win = shape[0] * -(-shape[1] // ws) * -(-shape[2] // ws)
        args = (randn(n_win, ws, ws, c), randn(*shape), ln_scale, ln_bias, ws, 1e-6)
        got_x, got_y = upr.unpartition_add_ln(*args)
        want_x, want_y = upr.unpartition_add_ln_plain(*args)
        hold("K9", label, got_y, want_y)
        check(torch.equal(got_x, want_x), f"K9 {label}: x_new is not bit-exact against the plain add")
        inputs[("K9", label)] = args

    def bound_and_library(name, args, per_block):
        """The launch's bound and the library call on the same operands (the
        dense bias, and K8's partition, are built outside the timed call)."""
        if name == "K9":
            x = args[1]
            # every real token: two reads, two writes; add, sum, sum of squares,
            # normalise, scale and shift: ~9 operations an element; no single
            # PyTorch call unpartitions, adds and normalises
            return {"library_ms": None, **bound([x, x, x, x, args[2], args[3]], 9 * x.numel())}
        if name == "K8":
            qkv, rel_h, rel_w, bias_kv, sc, _, n_heads = args
            b, hg, wg, three_hd = qkv.shape
            d = three_hd // (3 * n_heads)
            out = torch.empty(b, hg, wg, n_heads * d, device=device)
            # only the real queries are computed, against the ws² slots of their window
            flops = attention_flops(b * n_heads, hg * wg, ws * ws, d)
            lib = sdpa_ms(torch, *windows_for_library(qkv, rel_h, rel_w, bias_kv, ws, n_heads),
                          sc, per_block)
            return {"library_ms": lib, **bound([qkv, rel_h, rel_w, bias_kv, out], flops)}
        q, k, v = (t[None] for t in args[:3])
        bh, n, d = args[0].shape
        if name == "K6":
            bias, sc = dense_bias(args[3], args[4], 1, bh), args[5]
            moved = [*args[:5], args[0]]
        else:
            bias, sc = args[3][None], args[4]
            moved = [*args[:4], args[0]]
        lib = sdpa_ms(torch, q, k, v, bias, sc, per_block)
        return {"library_ms": lib, **bound(moved, attention_flops(bh, n, n, d))}

    fns = {"K6": (attention._launch_k6, attention.attention_rel),
           "K7": (attention._launch_k7, attention.attention_dense),
           "K8": (attention._launch_k8, attention.attention_rel_win),
           "K9": (upr._launch_k9, upr.unpartition_add_ln_plain)}
    out = {}
    for name, (kernel, plain) in fns.items():
        labels = (("B=1 windows", "B=1 global", "B=8 windows", "B=8 global") if name in ("K6", "K7")
                  else ("B=1", "B=8"))
        for label in labels:
            args = inputs[(name, label)]
            per_block = 50 if label.startswith("B=1") else 5
            (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: kernel(*args),
                                                      lambda: plain(*args), per_block)
            print(f"{name} at ViT-B/512 {label}: kernel {k_a * 1e3:.2f} / {k_b * 1e3:.2f} us, "
                  f"plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us "
                  f"(median of 11 x {per_block} launches)")
            if label.startswith("B=1"):
                m = {"ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
                     **bound_and_library(name, args, per_block)}
                print(f"{name} at ViT-B/512 {label}: {describe_yardsticks(m)}")
                if label == "B=1 global":  # the same kernel at the global blocks' shape
                    out[name]["global_tokens"] = m
                else:
                    out[name] = {"max_abs_err": worst[name][0], **m}
        print(f"{name} within {KERNEL_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})"
              + ("; x_new bit-exact" if name == "K9" else ""))
    return out


# ---------------------------------------------------------------------------
# the backward kernels of K6, K8, K9 against their plain VJPs
# ---------------------------------------------------------------------------


def route_bwd_kernel_phase(torch, device):
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops import unpartition_residual as upr
    from mia_tpu_torch.ops.ln_window import window_partition

    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    def randn(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(shape, generator=gen, device=device) + shift

    heads, ws, c, side = 12, 14, 768, 32
    worst = {k: [0.0, 0.0] for k in ("K6b", "K8b", "K9b")}
    hold = backward_holder(torch, worst)
    timed = {}

    # K6b: head-major operands of 12 and 6 ViT-B/512 images (9 windows x 12
    # heads of 196 tokens each; 12 heads of 1024 global tokens each), a token
    # count no tile divides, and the ViT-H head dim
    for label, bh, d, k_hw in (("B=12 windows", 1296, 64, (14, 14)), ("B=12 global", 144, 64, (32, 32)),
                               ("B=6 windows", 648, 64, (14, 14)), ("B=6 global", 72, 64, (32, 32)),
                               ("N=120 (10x12)", 6, 64, (10, 12)),
                               ("head dim 80", 144, 80, (14, 14))):
        n = k_hw[0] * k_hw[1]
        fwd = (randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, k_hw[0]),
               randn(bh, n, k_hw[1]))
        out, lse = attention._launch_k6(*fwd, d ** -0.5, k_hw, with_lse=True)
        g = randn(bh, n, d)
        kernel_args = (*fwd, out, g, lse, d ** -0.5, k_hw)
        plain_args = (*fwd, out, g, d ** -0.5, k_hw)
        hold("K6b", label, attention._launch_k6_bwd(*kernel_args),
             attention.attention_rel_bwd(*plain_args))
        timed[("K6b", label)] = (kernel_args, plain_args)
    # K8b: 32x32 pads each edge window, 20x27 both ways, 28x28 is whole windows
    # (dbias_kv exactly zero)
    for label, b, hw, n_heads, d in (("B=12", 12, (side, side), heads, 64),
                                     ("B=6", 6, (side, side), heads, 64),
                                     ("grid 20x27", 2, (20, 27), heads, 64),
                                     ("whole windows 28x28", 2, (28, 28), heads, 64),
                                     ("head dim 80", 1, (side, side), 16, 80)):
        fwd = (randn(b, *hw, 3 * n_heads * d), randn(b * n_heads, *hw, ws),
               randn(b * n_heads, *hw, ws), randn(3, n_heads * d, scale=0.5))
        out, lse = attention._launch_k8(*fwd, d ** -0.5, ws, n_heads, with_lse=True)
        g = randn(b, *hw, n_heads * d)
        kernel_args = (*fwd, out, g, lse, d ** -0.5, ws, n_heads)
        plain_args = (*fwd, out, g, d ** -0.5, ws, n_heads)
        got = attention._launch_k8_bwd(*kernel_args)
        hold("K8b", label, got, attention.attention_rel_win_bwd(*plain_args))
        check(not got[3][0].any(), f"K8b {label}: row 0 of dbias_kv is not zero")
        timed[("K8b", label)] = (kernel_args, plain_args)
    # K9b: the total in both layouts, the pad slots of the windows' cotangent exactly zero
    ln_scale, ln_bias = randn(c, scale=0.2, shift=1.0), randn(c, scale=0.1, shift=0.5)
    for label, shape in (("B=12", (12, side, side, c)), ("B=6", (6, side, side, c)),
                         ("grid 20x27", (2, 20, 27, c))):
        n_win = shape[0] * -(-shape[1] // ws) * -(-shape[2] // ws)
        x_new, _, mu, rstd = upr._launch_k9(randn(n_win, ws, ws, c), randn(*shape), ln_scale,
                                            ln_bias, ws, 1e-6, with_stats=True)
        dx_new, dy = randn(*shape), randn(*shape)
        pad = window_partition(torch.ones(*shape[:3], 1, device=device), ws)[0] == 0
        for params in (False, True):
            args = (x_new, dx_new, dy, mu, rstd, ln_scale, ws, params)
            got = upr._launch_k9_bwd(*args)
            hold("K9b", f"{label} params={params}", got, upr.unpartition_add_ln_bwd(*args))
            check(bool(pad.any()) and not got[0][pad.expand_as(got[0])].any(),
                  f"K9b {label}: pad slots of the windows' cotangent are not zero")
        timed[("K9b", label)] = ((x_new, dx_new, dy, mu, rstd, ln_scale, ws, False),) * 2

    def bound_and_library(name, args):
        """The launch's bound and, for K6b and K8b, autograd through the
        library call on the same operands."""
        if name == "K9b":
            x, _, _, mu, rstd, ln_w = args[:6]
            dwin = torch.empty(x.shape[0] * 9, ws, ws, c, device=device)
            # three reads and two writes of the real tokens (one of them with the pad
            # slots' zeros); two row reductions and the VJP's combination: ~13 operations
            # an element; no single PyTorch call is this VJP in two layouts
            return {"library_ms": None,
                    **bound([x, x, x, mu, rstd, ln_w, x, dwin], 13 * x.numel())}
        if name == "K8b":
            qkv, rel_h, rel_w, bias_kv, o, g, _, sc, _, n_heads = args
            b, hg, wg, three_hd = qkv.shape
            d = three_hd // (3 * n_heads)
            # only the real queries are computed, against the ws² slots of their window
            flops = attention_flops(b * n_heads, hg * wg, ws * ws, d, backward=True)
            g_w = window_partition(g, ws)[0].view(-1, ws * ws, n_heads, d).transpose(1, 2).contiguous()
            lib = sdpa_backward_ms(torch, *windows_for_library(qkv, rel_h, rel_w, bias_kv, ws, n_heads),
                                   sc, g_w, 5)
            # lse is the forward's by-product; dqkv, drel_h, drel_w and dbias_kv are written
            return {"library_ms": lib, **bound([qkv, rel_h, rel_w, bias_kv, o, g, qkv, rel_h, rel_w,
                                                bias_kv], flops)}
        q, k, v, rel_h, rel_w, o, g, _, sc, _ = args
        bh, n, d = q.shape
        lib = sdpa_backward_ms(torch, q[None], k[None], v[None], dense_bias(rel_h, rel_w, 1, bh), sc,
                               g[None], 5)
        return {"library_ms": lib, **bound([q, k, v, rel_h, rel_w, o, g, q, k, v, rel_h, rel_w],
                                           attention_flops(bh, n, n, d, backward=True))}

    fns = {"K6b": (attention._launch_k6_bwd, attention.attention_rel_bwd),
           "K8b": (attention._launch_k8_bwd, attention.attention_rel_win_bwd),
           "K9b": (upr._launch_k9_bwd, upr.unpartition_add_ln_bwd)}
    out = {}
    for name, (kernel, plain) in fns.items():
        labels = (("B=12 windows", "B=12 global", "B=6 windows", "B=6 global") if name == "K6b"
                  else ("B=12", "B=6"))
        for label in labels:
            k_args, p_args = timed[(name, label)]
            per_block = 20 if name == "K9b" else 5
            (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: kernel(*k_args),
                                                      lambda: plain(*p_args), per_block)
            print(f"{name} at ViT-B/512 training {label}: kernel {k_a * 1e3:.2f} / "
                  f"{k_b * 1e3:.2f} us, plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us "
                  f"(median of 11 x {per_block} launches)")
            if label.startswith("B=12"):
                m = {"ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
                     **bound_and_library(name, k_args)}
                print(f"{name} at ViT-B/512 training {label}: {describe_yardsticks(m)}")
                if label == "B=12 global":  # the same kernel at the global blocks' shape
                    out[name]["global_tokens"] = m
                else:
                    out[name] = {"max_abs_err": worst[name][0], **m}
        print(f"{name} within {BWD_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})"
              + ("; pad slots exactly zero" if name == "K9b" else ""))
    return out


# ---------------------------------------------------------------------------
# SAM phase
# ---------------------------------------------------------------------------


def sam_frame(np, seed=0, size=(480, 640)):
    """Seeded uint8 RGB frame: smooth shading, a bright ellipse, noise."""
    rng = np.random.default_rng(seed)
    h, w = size
    yy, xx = np.mgrid[0:h, 0:w]
    base = 90.0 + 50.0 * np.sin(xx / 37.0) * np.cos(yy / 29.0)
    blob = ((yy - 0.45 * h) / (0.2 * h)) ** 2 + ((xx - 0.55 * w) / (0.18 * w)) ** 2 <= 1.0
    img = base[..., None] + 90.0 * blob[..., None] + rng.normal(0.0, 12.0, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def median_s(fn, torch, n, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def sam_phase(torch, device):
    import copy

    import numpy as np

    from mia_tpu_torch.device import set_compute_precision
    from mia_tpu_torch.models.sam import SamPredictor, sam_model_registry
    from mia_tpu_torch.ops import attention, ln_window
    from mia_tpu_torch.ops.resize import _resize_matrix

    set_compute_precision("float32")
    torch.manual_seed(0)
    cpu_model, embed_size = sam_model_registry["vit_b"](512, 3)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # the reference initialises these at zero
        for name, p in cpu_model.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("pos_embed"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    model = copy.deepcopy(cpu_model).to(device)
    enc = model.image_encoder
    check(embed_size == 32 and len(enc.blocks) == 12 and enc.blocks[0].attn.qkv.in_features == 768,
          "not the ViT-B/512 SAM")
    check(all(p.device.type == "cuda" for p in model.parameters()), "SAM parameters not on CUDA")

    image = sam_frame(np)
    point, label = np.array([[352.0, 216.0]]), np.array([1])
    box = np.array([220.0, 110.0, 500.0, 330.0])
    coords16 = np.random.default_rng(5).uniform([0, 0], [640, 480], (16, 1, 2))
    labels16 = np.ones((16, 1), np.int64)
    counters = {"K2": attention.fused_attention_rel_packed_ik,
                "K3": attention.fused_attention_rel_packed,
                "K4": ln_window.ln_window_partition_fused}

    # --- the main path, counted --------------------------------------------
    predictor = SamPredictor(model)
    for fn in counters.values():
        fn.launches = 0
    predictor.set_image(image)
    torch.cuda.synchronize()
    per_set_image = {k: fn.launches for k, fn in counters.items()}
    outs = {"point": predictor.predict(point_coords=point, point_labels=label)}
    outs["box"] = predictor.predict(box=box)
    best = int(np.argmax(outs["point"][1]))
    outs["point+box+mask"] = predictor.predict(
        point_coords=point, point_labels=label, box=box, mask_input=outs["point"][2][best][None])
    batch = predictor.predict_batch(coords16, labels16)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    check(per_set_image == {"K2": 8, "K3": 4, "K4": 8},
          f"kernel launches per set_image {per_set_image}, expected 8 K2, 4 K3, 8 K4")
    check(launches == per_set_image, f"predict launched encoder kernels: {launches}")
    for name, (masks, iou, low) in outs.items():
        check(masks.shape == (3, 480, 640) and masks.dtype == bool, f"{name}: masks {masks.shape}")
        check(iou.shape == (3,) and low.shape == (3, 128, 128), f"{name}: iou/low-res shapes")
        check(bool(np.isfinite(iou).all() and np.isfinite(low).all()), f"{name}: non-finite")
    check(batch[0].shape == (16, 3, 480, 640) and batch[1].shape == (16, 3)
          and batch[2].shape == (16, 3, 128, 128), "predict_batch shapes")
    check(bool(np.isfinite(batch[1]).all() and np.isfinite(batch[2]).all()),
          "predict_batch: non-finite")
    emb = predictor.get_image_embedding()
    check(emb.device.type == "cuda" and emb.shape == (1, 32, 32, 256), "embedding not on the card")

    # --- the card against the CPU, same weights ----------------------------
    # the resized, uint8-truncated input may differ by one step where the
    # exact resize lies at an integer and float32 summation order decides
    cpu_predictor = SamPredictor(cpu_model)
    x_card = predictor._input_image(image).cpu()
    x_cpu = cpu_predictor._input_image(image)
    (h_in, w_in), (h0, w0) = predictor.input_size, image.shape[:2]
    exact = np.einsum("ow,hwc->hoc", _resize_matrix(w_in, w0, "bilinear", True).astype(np.float64),
                      np.einsum("oh,hwc->owc",
                                _resize_matrix(h_in, h0, "bilinear", True).astype(np.float64),
                                image.astype(np.float64)))
    differ = (x_card != x_cpu)[0].numpy()
    flips = int(differ.sum())
    at_integer = np.abs(exact - np.round(exact)) < 1e-3
    check((x_card - x_cpu).abs().max().item() <= 1 and not (differ & ~at_integer).any(),
          f"resized uint8 input: {flips} values differ between card and CPU, not all at "
          "an integer of the exact resize")
    cpu_predictor.set_image(image)  # features from x_cpu
    emb_cpu = cpu_predictor.get_image_embedding()
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False  # full float32: the math, not TF32
        with torch.inference_mode():
            emb_fp32 = model.get_image_embeddings(x_cpu.to(device))
        predictor.features = emb_fp32  # both predictors now decode from one input
        calls = {
            "point": lambda p, **k: p.predict(point_coords=point, point_labels=label, **k),
            "box": lambda p, **k: p.predict(box=box, **k),
            "predict_batch": lambda p, **k: p.predict_batch(coords16, labels16, **k),
        }
        logit_err, iou_err, bit_flips = 0.0, 0.0, 0
        for name, call in calls.items():
            want, want_iou, _ = call(cpu_predictor, return_logits=True)
            got, got_iou, _ = call(predictor, return_logits=True)
            ref = max(1.0, float(np.abs(want).max()))
            tol = 1e-4 * ref
            err = float(np.abs(got - want).max())
            ierr = float(np.abs(got_iou - want_iou).max())
            check(err <= tol, f"{name}: mask logits card vs CPU differ by {err} > {tol}")
            check(ierr <= 1e-4 * max(1.0, float(np.abs(want_iou).max())),
                  f"{name}: iou card vs CPU differ by {ierr}")
            bits_want, bits_got = call(cpu_predictor)[0], call(predictor)[0]
            confident = np.abs(want) > 2 * tol
            check(np.array_equal(bits_got[confident], bits_want[confident]),
                  f"{name}: mask bits differ where |logit| > {2 * tol}")
            logit_err, iou_err = max(logit_err, err / ref), max(iou_err, ierr)
            bit_flips += int((bits_got != bits_want).sum())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    with torch.inference_mode():
        emb_tf32 = model.get_image_embeddings(x_cpu.to(device))
    scale = emb_cpu.abs().max().item()
    fp32_err = (emb_fp32.cpu() - emb_cpu).abs().max().item()
    tf32_err = (emb_tf32.cpu() - emb_cpu).abs().max().item()
    check(bool(torch.isfinite(emb_tf32).all()), "embedding not finite")
    check(fp32_err <= 1e-4 * scale, f"float32 embedding card vs CPU differs by {fp32_err} (scale {scale})")
    check(tf32_err <= 2e-2 * scale, f"TF32 embedding card vs CPU differs by {tf32_err} (scale {scale})")

    # --- latency -----------------------------------------------------------
    set_s = median_s(lambda: predictor.set_image(image), torch, n=20)
    predict_s = median_s(lambda: predictor.predict(point_coords=point, point_labels=label),
                         torch, n=20)
    batch_s = median_s(lambda: predictor.predict_batch(coords16, labels16), torch, n=10)
    x8 = predictor._input_image(image).expand(8, -1, -1, -1).contiguous()
    with torch.inference_mode():
        enc_s = median_s(lambda: model.get_image_embeddings(x8), torch, n=5)

    print(f"sam: ViT-B/512 SamPredictor on {image.shape[1]}x{image.shape[0]} frames "
          f"(input 512x384, padded); launches per set_image {per_set_image}")
    print(f"sam: set_image median {set_s * 1e3:.2f} ms; predict (1 point) {predict_s * 1e3:.2f} ms; "
          f"predict_batch (16 points) {batch_s * 1e3:.2f} ms; encoder at batch 8 "
          f"{enc_s * 1e3:.2f} ms ({8 / enc_s:.1f} img/s); TF32 convolutions, float32 matmuls")
    print(f"sam: card vs CPU: embedding max |diff| {fp32_err:.3g} (float32), {tf32_err:.3g} "
          f"(TF32 convs), max |emb| {scale:.3g}; mask logits relative {logit_err:.3g}, iou "
          f"{iou_err:.3g}, {bit_flips} mask bits flipped near 0; resized input values "
          f"one step apart at an exact integer: {flips} of {differ.size}")
    return ({"launches": launches, "set_image_ms": set_s * 1e3, "predict_ms": predict_s * 1e3,
             "predict_batch_ms": batch_s * 1e3, "encoder_img_per_s_b8": 8 / enc_s},
            model, cpu_model)


# ---------------------------------------------------------------------------
# encoder-route phase: set_image through every other route of the encoder
# ---------------------------------------------------------------------------

# label, the encoder's options, whether MIA_WINDOWED_ATTN=1 is set around the
# call, kernel launches of one set_image (8 windowed and 4 global blocks)
ROUTE_VARIANTS = (
    ("K9 exit", dict(fuse_unpart_residual="always"), False, {"K4": 8, "K2": 8, "K9": 8, "K3": 4}),
    ("grid-native by argument", dict(fuse_ln_window="never", attn_route="grid_native"), False,
     {"K8": 8, "K3": 4}),
    ("grid-native by MIA_WINDOWED_ATTN=1", dict(fuse_ln_window="never"), True, {"K8": 8, "K3": 4}),
    ("head-major", dict(attn_route="head_major"), False, {"K6": 12, "K4": 8}),
    ("no rel-pos", dict(use_rel_pos=False), False, {"K7": 12, "K4": 8}),
)


def with_encoder(model, **options):
    """A copy of ``model`` whose image encoder has the same geometry and LoRA
    rank, is built with ``options`` and loaded with the same weights (bar the
    rel-pos tables of an encoder built without them); every parameter keeps
    its ``requires_grad`` and the copy the model's train/eval mode."""
    import copy

    from mia_tpu_torch.models.sam import ImageEncoderViT

    variant = copy.deepcopy(model)
    enc = model.image_encoder
    blocks = enc.blocks
    encoder = ImageEncoderViT(
        img_size=enc.img_size, patch_size=enc.patch_embed.patch,
        embed_dim=enc.pos_embed.shape[-1], depth=len(blocks), num_heads=blocks[0].attn.num_heads,
        out_chans=enc.neck[0].out_channels, window_size=max(b.window_size for b in blocks),
        global_attn_indexes=tuple(i for i, b in enumerate(blocks) if b.window_size == 0),
        lora_rank=blocks[0].attn.lora_rank, **options).to(enc.pos_embed.device)
    encoder.load_state_dict({k: v for k, v in enc.state_dict().items()
                             if options.get("use_rel_pos", True) or "rel_pos" not in k})
    source = dict(enc.named_parameters())
    for name, p in encoder.named_parameters():
        p.requires_grad_(source[name].requires_grad)
    variant.image_encoder = encoder
    return variant.train(model.training)


@contextlib.contextmanager
def windowed_attn_switch(on):
    """``MIA_WINDOWED_ATTN=1`` in the environment for the block, if ``on``."""
    before = os.environ.get("MIA_WINDOWED_ATTN")
    if on:
        os.environ["MIA_WINDOWED_ATTN"] = "1"
    try:
        yield
    finally:
        if before is None:
            os.environ.pop("MIA_WINDOWED_ATTN", None)
        else:
            os.environ["MIA_WINDOWED_ATTN"] = before


def route_phase(torch, device, model):
    import copy

    import numpy as np

    from mia_tpu_torch.models.sam import SamPredictor

    image = sam_frame(np)
    counts = counters()
    launches = {k: 0 for k in counts}

    def embed(predictor):
        """One ``set_image`` in full float32 (the math, not TF32) → embedding."""
        tf32 = torch.backends.cudnn.allow_tf32
        try:
            torch.backends.cudnn.allow_tf32 = False
            predictor.set_image(image)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        return predictor.get_image_embedding()

    default = SamPredictor(model)
    want = embed(default)
    zeroed = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in zeroed.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.zero_()
    want_zeroed = embed(SamPredictor(zeroed))
    del zeroed
    check((want_zeroed - want).abs().max().item() > 1e-3 * want.abs().max().item(),
          "the rel-pos tables do not reach the embedding")
    out = {}
    for label, options, switch, expect in ROUTE_VARIANTS:
        predictor = SamPredictor(with_encoder(model, **options))
        with windowed_attn_switch(switch):
            for fn in counts.values():
                fn.launches = 0
            got = embed(predictor)
            seen = {k: fn.launches for k, fn in counts.items() if fn.launches}
            # host-clock medians of 10, in turns: the host's share of set_image varies
            # from moment to moment, so each variant is read beside its own default
            base_a = median_s(lambda: default.set_image(image), torch, n=10) * 1e3
            ms_a = median_s(lambda: predictor.set_image(image), torch, n=10) * 1e3
            ms_b = median_s(lambda: predictor.set_image(image), torch, n=10) * 1e3
            base_b = median_s(lambda: default.set_image(image), torch, n=10) * 1e3
        check(seen == expect, f"{label}: launches of one set_image {seen}, expected {expect}")
        ref = want if options.get("use_rel_pos", True) else want_zeroed
        check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{label}: embedding {tuple(got.shape)} malformed")
        err = (got - ref).abs().max().item() / ref.abs().max().item()
        check(err <= 1e-4, f"{label}: embedding differs from the default's by {err} of max |emb|")
        for k, n in seen.items():
            launches[k] += n
        out[label] = {"set_image_ms": min(ms_a, ms_b), "default_ms": min(base_a, base_b)}
        against = "the default" if ref is want else "the default with zeroed rel-pos tables"
        print(f"routes: {label}: launches {seen}; embedding within {err:.3g} of {against} "
              f"(float32 convolutions); set_image median {ms_a:.2f} / {ms_b:.2f} ms, default "
              f"encoder {base_a:.2f} / {base_b:.2f} ms (480x640 frame, in turns)")
    return {"launches": launches, "set_image_ms": out}


# ---------------------------------------------------------------------------
# AMG phase
# ---------------------------------------------------------------------------


def amg_phase(torch, device, model, cpu_model):
    import numpy as np

    from mia_tpu_torch.models.sam import SamAutomaticMaskGenerator, SamPredictor, amg

    image = sam_frame(np, seed=3, size=(512, 512))
    counts = counters()

    def watched(generator):
        """Record the scores of every chunk ``generator`` dispatches."""
        chunks = []
        score_chunk = generator.score_chunk

        def score(batch_points):
            masks, iou, stability = score_chunk(batch_points)
            chunks.append((len(batch_points), tuple(masks.shape), iou, stability))
            return masks, iou, stability

        generator.score_chunk = score
        return chunks

    def counted_generate(generator, label, expect):
        """One ``generate`` with every count set to 0 just before → (records,
        launches); the scores of its chunks must be finite."""
        chunks = watched(generator)
        for fn in counts.values():
            fn.launches = 0
        records = generator.generate(image)
        torch.cuda.synchronize()
        seen = {k: fn.launches for k, fn in counts.items() if fn.launches}
        check(seen == expect, f"amg {label}: launches of one generate {seen}, expected {expect}")
        for n, shape, iou, stability in chunks:
            check(shape == (n, 3, 512, 512) and iou.shape == stability.shape == (n, 3),
                  f"amg {label}: chunk shapes {shape}, {tuple(iou.shape)}")
            check(bool(torch.isfinite(iou).all() and torch.isfinite(stability).all()
                       and (stability >= 0).all() and (stability <= 1).all()),
                  f"amg {label}: scores not finite or stability outside [0, 1]")
        del generator.score_chunk  # the class's method again
        return records, seen, chunks

    def well_formed(records, label):
        for r in records:
            seg = r["segmentation"]
            check(list(r) == ["segmentation", "rle", "area", "bbox", "predicted_iou"]
                  and seg.shape == (512, 512) and seg.dtype == bool, f"amg {label}: record malformed")
            check(np.array_equal(amg.rle_to_mask(r["rle"]), seg),
                  f"amg {label}: rle does not decode to its segmentation")
            check(r["area"] == int(seg.sum()) == amg.area_from_rle(r["rle"]),
                  f"amg {label}: area {r['area']} disagrees with the mask")
            check(r["bbox"] == amg.box_xyxy_to_xywh(amg.batched_mask_to_box(seg)).tolist(),
                  f"amg {label}: bbox {r['bbox']} disagrees with the mask")
            check(math.isfinite(r["predicted_iou"]), f"amg {label}: predicted_iou not finite")

    # --- the main path: the grid of bench_amg, default thresholds ------------
    predictor = SamPredictor(model)
    generator = SamAutomaticMaskGenerator(predictor, points_per_side=32, points_per_batch=64)
    encoder_launches = {"K4": 8, "K2": 8, "K3": 4}
    records, launches, chunks = counted_generate(generator, "32x32 points", encoder_launches)
    check([c[0] for c in chunks] == [64] * 16, f"amg: chunks {[c[0] for c in chunks]}")
    well_formed(records, "32x32 points")
    default_iou = torch.cat([c[2] for c in chunks])
    generate_s = median_s(lambda: generator.generate(image), torch, n=3, warmup=1)
    candidates = 32 * 32 * 3
    print(f"amg: ViT-B/512, 512x512 frame, 32x32 points in 16 chunks of 64, default thresholds: "
          f"{len(records)} records of {candidates} candidate masks; launches of one generate "
          f"{launches}; generate median of 3 {generate_s * 1e3:.2f} ms "
          f"({candidates / generate_s:.0f} candidate masks/s)")

    # --- thresholds that keep masks: gather, NMS, boxes, RLE -----------------
    keeper = SamAutomaticMaskGenerator(predictor, points_per_side=16, points_per_batch=64,
                                       pred_iou_thresh=-1e9, stability_score_thresh=-1.0)
    t0 = time.perf_counter()
    kept, seen, chunks = counted_generate(keeper, "16x16 points, keep all", encoder_launches)
    keep_s = time.perf_counter() - t0
    check([c[0] for c in chunks] == [64] * 4, f"amg keep all: chunks {[c[0] for c in chunks]}")
    check(0 < len(kept) <= 16 * 16 * 3, f"amg keep all: {len(kept)} records")
    well_formed(kept, "16x16 points, keep all")
    ious = [r["predicted_iou"] for r in kept]
    check(ious == sorted(ious, reverse=True), "amg keep all: records not in NMS (score) order")
    for k, n in seen.items():
        launches[k] += n
    print(f"amg: 16x16 points, keep-everything thresholds: {len(kept)} records after box NMS of "
          f"{16 * 16 * 3} survivors, every rle, area and bbox consistent; generate {keep_s * 1e3:.0f} ms")

    # --- one chunk's scores on the card against the CPU ----------------------
    points = generator.point_grids[:64] * np.array([512, 512])
    cpu_generator = SamAutomaticMaskGenerator(SamPredictor(cpu_model), points_per_side=32,
                                              points_per_batch=64)
    cpu_generator.predictor.set_image(image)
    _, want_iou, want_stab = cpu_generator.score_chunk(points)
    cpu_logits = cpu_generator.predictor.decode_on_device(
        points=cpu_generator.chunk_prompts(points))[0]
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False  # full float32: the math, not TF32
        predictor.set_image(image)
        _, got_iou, got_stab = generator.score_chunk(points)
        got_iou, got_stab = got_iou.cpu(), got_stab.cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    iou_err = (got_iou - want_iou).abs().max().item() / max(1.0, want_iou.abs().max().item())
    check(iou_err <= 1e-4, f"amg: one chunk's iou card vs CPU differs by {iou_err}")
    # a logit within tol of one of the two stability thresholds may fall either
    # side in float32; each such pixel moves a count by one
    thr, off = model.mask_threshold, generator.stability_score_offset
    tol = 1e-4 * max(1.0, cpu_logits.abs().max().item())
    near = (((cpu_logits - (thr + off)).abs() <= tol) | ((cpu_logits - (thr - off)).abs() <= tol))
    unions = (cpu_logits > (thr - off)).sum((-2, -1)).clamp(min=1)
    slack = 1e-4 + 2.0 * near.sum((-2, -1)) / unions
    stab_diff = (got_stab - want_stab).abs()
    check(bool((stab_diff <= slack).all()),
          f"amg: one chunk's stability card vs CPU differs by {stab_diff.max().item()}")
    print(f"amg: one chunk (64 points) card vs CPU, float32 convolutions: iou max |diff| "
          f"{iou_err:.3g}, stability max |diff| {stab_diff.max().item():.3g} "
          f"({int(near.sum())} logits within {tol:.3g} of a stability threshold)")

    # --- K8 under AMG ---------------------------------------------------------
    native = SamAutomaticMaskGenerator(
        SamPredictor(with_encoder(model, fuse_ln_window="never", attn_route="grid_native")),
        points_per_side=32, points_per_batch=64)
    records, seen, chunks = counted_generate(native, "grid-native encoder", {"K8": 8, "K3": 4})
    check([c[0] for c in chunks] == [64] * 16, f"amg grid-native: chunks {[c[0] for c in chunks]}")
    well_formed(records, "grid-native encoder")
    native_err = ((torch.cat([c[2] for c in chunks]) - default_iou).abs().max().item()
                  / max(1.0, default_iou.abs().max().item()))
    check(native_err <= 1e-3,
          f"amg grid-native: iou differs from the default encoder's by {native_err}")
    native_s = median_s(lambda: native.generate(image), torch, n=1, warmup=0)
    for k, n in seen.items():
        launches[k] = launches.get(k, 0) + n
    print(f"amg: grid-native encoder: launches of one generate {seen}; iou within "
          f"{native_err:.3g} of the default encoder's (TF32 convolutions, tolerance 1e-3); "
          f"a second generate {native_s * 1e3:.2f} ms")
    return {"launches": launches, "generate_ms": generate_s * 1e3,
            "candidate_masks_per_s": candidates / generate_s,
            "generate_grid_native_ms": native_s * 1e3, "keep_all_records": len(kept)}


# ---------------------------------------------------------------------------
# CPC-SAM phase
# ---------------------------------------------------------------------------

# kernel launches of one train step at ViT-B/512 (8 windowed, 4 global
# blocks): the encoder runs forward once, on the labeled half in phase 1 and
# on the whole batch in phase 2; its backward reaches every block's attention
# (LoRA on q and v) but not block 0's K4, whose input (patch embed +
# pos-embed, frozen) and LayerNorm parameters (frozen) need no gradient;
# phase 2 adds one batched connected-components call for all decoders
# (the default encoder takes none of the other routes: no K6-K9); with an
# auxiliary loss on, phase 1 runs the whole batch through the same launches
STEP_LAUNCHES = {
    1: {"K2": 8, "K2b": 8, "K3": 4, "K3b": 4, "K4": 8, "K4b": 7, "K5": 0},
    2: {"K2": 8, "K2b": 8, "K3": 4, "K3b": 4, "K4": 8, "K4b": 7, "K5": 1},
}
for _expected in STEP_LAUNCHES.values():
    _expected.update({k: 0 for k in ("K6", "K6b", "K7", "K8", "K8b", "K9", "K9b")})


def acdc_arrays(np, n, size, depth=None, seed=0):
    """Seeded ACDC-like slices (or volumes of ``depth`` slices) with blob
    labels in 4 classes (RV, Myo, LV as three overlapping ellipses) and
    intensities in 0-255, the units of SAM's pixel normalisation (at [0, 1]
    the tokens barely differ and a global block's LoRA gets next to no
    gradient in a few steps)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    count = n * (depth or 1)
    labels = np.zeros((count, size, size), np.int32)
    for i in range(count):
        for c in (1, 2, 3):
            cy, cx = rng.uniform(0.3, 0.7, 2) * size
            ry, rx = rng.uniform(0.05, 0.15, 2) * size
            labels[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = c
    images = np.clip(40.0 + 50.0 * labels + rng.normal(0.0, 12.0, labels.shape), 0, 255)
    images = images.astype(np.float32)
    if depth:
        return images.reshape(n, depth, size, size), labels.reshape(n, depth, size, size)
    return images, labels


def in_memory_acdc(np, ACDCDataset):
    """``ACDCDataset`` over arrays (the GPU machine has no h5py): 48 train
    slices (32 of them the labeled patient's), 2 validation and 2 test
    volumes of depth 4, all 512x512 from seed 0."""

    class InMemoryACDC(ACDCDataset):
        def __init__(self, split, images, labels, names):
            self.split, self.samples_list = split, names
            self.images, self.labels = images, labels
            self.image_channels, self.num = 3, None
            self.transform = self.normalize = self.image_size = None
            self.raw_spacing = {"_".join(n.split("_")[:2]): [10.0, 1.48, 1.48] for n in names}

        def get_sample(self, index, normalize=True):
            case = self.samples_list[index]
            return {"image": np.repeat(self.images[index][..., None], 3, -1),
                    "label": self.labels[index].copy(), "case_name": case,
                    "spacing": self._get_spacing("_".join(case.split("_")[:2]))}

    train = acdc_arrays(np, 48, 512, seed=0)
    vols = acdc_arrays(np, 4, 512, depth=4, seed=1)
    return {
        "train": InMemoryACDC("train", *train,
                              [f"patient{i // 16:03d}_frame01_slice_{i}" for i in range(48)]),
        "valid": InMemoryACDC("valid", vols[0][:2], vols[1][:2],
                              [f"patient{100 + i}_frame01" for i in range(2)]),
        "test": InMemoryACDC("test", vols[0][2:], vols[1][2:],
                             [f"patient{102 + i}_frame01" for i in range(2)]),
    }


def cpcsam_card_vs_cpu(torch, model, images, labels):
    """One phase-1 loss and its LoRA gradients (2 images, 1 labeled) on the
    card and on the CPU from the same weights → (loss relative diff, max
    |grad diff| over max |grad|) in full float32 and with TF32 convolutions."""
    import copy

    from mia_tpu_torch.training.cpcsam_trainer import CPCSAMTrainer

    config = dict(image_size=512, num_classes=3, batch_size=2, labeled_batch_ratio=0.5,
                  lora_rank=4, dice_weight=0.8, promptmode=["point"], optimizer_name="adam")

    def loss_and_grads(device, m, tf32=True):
        tr = CPCSAMTrainer(device=device, config=config)  # sets the run's precision
        torch.backends.cudnn.allow_tf32 = tf32
        tr.model = m
        tr._setup_loss()
        tr._setup_optimizer()
        total = tr.compute_losses(images.to(tr.device), labels.to(tr.device), 0, False)[0]
        names = [n for n, p in m.named_parameters() if "lora_" in n]
        grads = torch.autograd.grad(total, [dict(m.named_parameters())[n] for n in names])
        return total.item(), [g.cpu() for g in grads]

    t0 = time.perf_counter()
    want_loss, want = loss_and_grads("cpu", copy.deepcopy(model).cpu())
    cpu_s = time.perf_counter() - t0
    scale = max(g.abs().max().item() for g in want)
    errs = {}
    try:
        for mode, tf32 in (("float32", False), ("TF32 convs", True)):
            loss, got = loss_and_grads("cuda", model, tf32)
            errs[mode] = (abs(loss - want_loss) / abs(want_loss),
                          max((a - b).abs().max().item() for a, b in zip(got, want)) / scale)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    return want_loss, scale, errs, cpu_s


def run_cpcsam(torch, device, datasets, argv):
    """``train_entry(argv)`` on the in-memory ACDC set with every train step
    timed and counted → the trainer and what was recorded: ``steps`` (phase,
    seconds, launches by kernel, valid memory rows by class or None),
    ``losses``, ``snap`` (every parameter after ``on_train_start``),
    ``launches`` of the whole run and the peak memory."""
    from mia_tpu_torch.entry.cpcsam.train import train_entry
    from mia_tpu_torch.training import cpcsam_trainer

    counts = counters()
    rec = {"steps": [], "losses": [], "snap": {}}
    base = cpcsam_trainer.CPCSAMTrainer

    class SmokeTrainer(base):
        def _make_dataset(self, split):
            return datasets[split]

        def on_train_start(self):
            super().on_train_start()
            rec["snap"].update({n: p.detach().clone() for n, p in self.model.named_parameters()})
            rec["first_iter"] = self.current_iter

        def train_step(self, batch):
            phase = 2 if self.current_iter >= self.config.warmup_iter else 1
            torch.cuda.synchronize()
            before = {k: fn.launches for k, fn in counts.items()}
            t0 = time.perf_counter()
            super().train_step(batch)
            torch.cuda.synchronize()
            rows = None if self.memory is None else self.memory.valid.sum(1).tolist()
            rec["steps"].append((phase, time.perf_counter() - t0,
                                 {k: fn.launches - before[k] for k, fn in counts.items()
                                  if k != "K1"}, rows))

        def _log_train(self, step, lr, step_losses):
            rec["losses"].append([float(v) for v in step_losses.cpu()])
            return super()._log_train(step, lr, step_losses)

    cpcsam_trainer.CPCSAMTrainer = SmokeTrainer
    try:
        for fn in counts.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        trainer = train_entry(argv)
        torch.cuda.synchronize()
        rec["total_s"] = time.perf_counter() - t0
        rec["launches"] = {k: fn.launches for k, fn in counts.items()}
        rec["peak"] = torch.cuda.max_memory_allocated(device)
    finally:
        cpcsam_trainer.CPCSAMTrainer = base
    return trainer, rec


def check_cpcsam_steps(torch, trainer, rec, phases, moved_prefixes):
    """What every CPC-SAM run of the smoke must show: the phases of its
    steps, the derived launches in each, finite losses, the trainable tensors
    under ``moved_prefixes`` moved and the frozen encoder bit-identical."""
    check([s[0] for s in rec["steps"]] == phases, f"phases of the steps: {[s[0] for s in rec['steps']]}")
    for phase, _, per_step, _ in rec["steps"]:
        check(per_step == STEP_LAUNCHES[phase],
              f"phase-{phase} step launched {per_step}, expected {STEP_LAUNCHES[phase]}")
    losses = rec["losses"]
    check(len(losses) == len(phases) and all(math.isfinite(v) for row in losses for v in row),
          f"losses not all finite: {losses}")
    check(all((row[2] > 0) == (ph == 2) for row, ph in zip(losses, phases)),
          "loss2 must be zero in phase 1 and positive in phase 2")
    moved, frozen_changed = {}, []
    for n, p in trainer.model.named_parameters():
        same = torch.equal(p.detach(), rec["snap"][n])
        if "lora_" in n or n.startswith(moved_prefixes):
            moved[n] = not same
        elif n.startswith("image_encoder.") and not same:
            frozen_changed.append(n)
        check(p.requires_grad == ("lora_" in n or not n.startswith("image_encoder.")),
              f"{n}: requires_grad {p.requires_grad}")
    lora = [m for n, m in moved.items() if "lora_" in n]
    check(len(lora) == 48 and all(moved.values()),
          f"trainable tensors that did not move: {[n for n, m in moved.items() if not m][:5]}")
    check(not frozen_changed, f"frozen encoder parameters changed: {frozen_changed[:5]}")
    return moved


def cpcsam_phase(torch, device, workdir: Path):
    import numpy as np

    from mia_tpu_torch.data import ACDCDataset

    datasets = in_memory_acdc(np, ACDCDataset)
    warmup, iters, batch = 2, 6, 12
    common = ["--data-path", str(workdir / "acdc"), "--device", "cuda", "--lr-warmup-iter", "1",
              "--quiet"]
    argv = common + ["--work-path", str(workdir / "work"), "--warmup-iter", str(warmup),
                     "--min-iter", str(iters), "--max-iter", str(iters), "--valid-freq-iter", "3"]
    trainer, rec = run_cpcsam(torch, device, datasets, argv)
    steps, losses, launches, peak, total_s = (rec["steps"], rec["losses"], rec["launches"],
                                              rec["peak"], rec["total_s"])

    model, cfg = trainer.model, trainer.config
    enc = model.image_encoder
    check(len(enc.blocks) == 12 and enc.blocks[0].attn.qkv.in_features == 768
          and enc.blocks[0].attn.num_heads == 12 and model.num_decoders == 3
          and enc.blocks[0].attn.lora_a_q.weight.shape == (4, 768)
          and type(model.mask_decoder0).__name__ == "MaskDecoderPromptLarge",
          "not the LoRA ViT-B/512 SamDualmask with 3 MaskDecoderPromptLarge decoders")
    check(cfg.batch_size == batch and cfg.labeled_batch_size == 6 and cfg.promptmode == ["point"],
          f"batch {cfg.batch_size}, labeled {cfg.labeled_batch_size}, prompts {cfg.promptmode}")
    check(all(p.device.type == "cuda" for p in model.parameters()), "SamDualmask not on CUDA")
    check_cpcsam_steps(torch, trainer, rec, [1] * warmup + [2] * (iters - warmup), ())
    work = trainer.work_path
    for rel in ("best_model/lora.pth", "final_model/lora.pth", "test_mean.csv"):
        check((work / rel).is_file(), f"missing {rel}")
    rows = (work / "test_mean.csv").read_text().splitlines()
    check(len(rows) == 4 and rows[0].startswith("class,DSC"), "test_mean.csv malformed")
    log = (work / "log.txt").read_text()
    check(log.count("Valid results") == 2 and "Real test results" in log,
          "validation (iterations 3 and 6) or the real test did not run")
    for k in ("K2", "K2b", "K3", "K3b", "K4", "K4b", "K5"):
        check(launches[k] > 0, f"{k} was not launched on the CPC-SAM path")

    train_set = datasets["train"]
    images = torch.from_numpy(np.stack([np.repeat(train_set.images[i][..., None], 3, -1)
                                        for i in (0, 40)]))
    labels = torch.from_numpy(train_set.labels[[0, 40]]).long()
    want_loss, grad_scale, errs, cpu_s = cpcsam_card_vs_cpu(torch, model, images, labels)
    for mode, (loss_err, grad_err) in errs.items():
        check(loss_err <= 1e-4 and grad_err <= 1e-3,
              f"card vs CPU ({mode}): loss relative diff {loss_err}, LoRA grads {grad_err} "
              "of max |grad|")

    med = {ph: statistics.median(s[1] for s in steps if s[0] == ph) * 1e3 for ph in (1, 2)}
    print(f"cpcsam: LoRA-4 ViT-B/512 SamDualmask (3 decoders, 3 classes), batch {batch} (6 "
          f"labeled), --promptmode point; {warmup} phase-1 + {iters - warmup} phase-2 steps")
    print(f"cpcsam: step ms {[round(s[1] * 1e3, 2) for s in steps]}; median phase 1 "
          f"{med[1]:.2f} ms ({batch / med[1] * 1e3:.1f} img/s), phase 2 {med[2]:.2f} ms "
          f"({batch / med[2] * 1e3:.1f} img/s); run total {total_s:.1f} s incl. 2 validations "
          f"and the real test; max_memory_allocated {peak / 2**30:.2f} GiB")
    print(f"cpcsam: launches per phase-1 step {STEP_LAUNCHES[1]}, per phase-2 step "
          f"{STEP_LAUNCHES[2]}, as derived; in the whole run {launches}")
    print(f"cpcsam: losses [total, loss1, loss2, loss3] first {losses[0]} last {losses[-1]}")
    print(f"cpcsam: 48 LoRA tensors moved, frozen encoder bit-identical; validation x2, real "
          f"test and test_mean.csv written")
    print("cpcsam: card vs CPU, phase-1 loss (2 images, 1 labeled) "
          f"{want_loss:.6f}, max |LoRA grad| {grad_scale:.3g}: "
          + "; ".join(f"{m}: loss {a:.3g} relative, grads {b:.3g} of max" for m, (a, b)
                      in errs.items()) + f" (CPU side {cpu_s:.1f} s)")

    # --- the auxiliary losses and --resume: one step per phase each -----------
    # run A: the contrastive loss from a fresh model; run B: VAT, resumed from A's
    # final checkpoint (iterations 2 and 3 of the same run, phase 1 then phase 2)
    heads = ("projection_head", "prediction_head")
    selectors = "contrastive_class_selector"
    aux = {}
    no_valid = ["--valid-freq-iter", "1000"]
    argv_a = common + no_valid + ["--work-path", str(workdir / "work_contrastive"),
                                  "--use-contrastive-loss", "--warmup-iter", "1",
                                  "--min-iter", "2", "--max-iter", "2"]
    tr_a, rec_a = run_cpcsam(torch, device, datasets, argv_a)
    check_cpcsam_steps(torch, tr_a, rec_a, [1, 2], heads)
    for (_, _, _, rows), row in zip(rec_a["steps"], rec_a["losses"]):
        check(rows is not None and len(rows) == 4, f"feature memory rows by class: {rows}")
        check((row[3] > 0) == (max(rows) >= 2),
              f"loss3 {row[3]} with {rows} valid memory rows by class: it must be non-zero "
              "exactly when a class holds two rows")
    check(rec_a["losses"][-1][3] > 0, "the contrastive loss stayed zero: no class filled its memory")
    # a class selector moves only once its class holds two memory rows (never the background's)
    check(any(n.startswith(selectors) and not torch.equal(p.detach(), rec_a["snap"][n])
              for n, p in tr_a.model.named_parameters()), "no class selector moved")
    ckpt = tr_a.work_path / "final_model"
    for rel in ("lora.pth", "training_state.json", "training_state.pth"):
        check((ckpt / rel).is_file(), f"missing final_model/{rel}")
    aux["contrastive"] = rec_a

    argv_b = common + no_valid + ["--work-path", str(workdir / "work_adv"), "--use-adv-loss",
                                  "--resume", str(ckpt), "--warmup-iter", "3", "--min-iter", "4",
                                  "--max-iter", "4"]
    tr_b, rec_b = run_cpcsam(torch, device, datasets, argv_b)
    check(rec_b["first_iter"] == 2 and tr_b.current_iter == 4 and tr_b.optimizer.count == 4,
          f"resumed at iteration {rec_b['first_iter']}, ended at {tr_b.current_iter} with "
          f"{tr_b.optimizer.count} optimizer steps; expected 2, 4, 4")
    final_a = dict(tr_a.model.named_parameters())
    check(all(torch.equal(p, final_a[n]) for n, p in rec_b["snap"].items()),
          "the resumed run does not start from the saved parameters")
    check(all(torch.equal(a, b) for a, b in zip(tr_a.memory, tr_b.memory)),
          "the resumed run lost the feature memory")
    check_cpcsam_steps(torch, tr_b, rec_b, [1, 2], ())
    check(all(row[3] > 0 for row in rec_b["losses"]), f"VAT loss not positive: {rec_b['losses']}")
    aux["adv"] = rec_b
    for name, r in aux.items():
        print(f"cpcsam --use-{name}-loss: phase-1 / phase-2 step "
              + " / ".join(f"{s[1] * 1e3:.2f}" for s in r["steps"]) + " ms (first steps of a run, "
              f"whole batch of {batch} in both), max_memory_allocated {r['peak'] / 2**30:.2f} GiB; "
              f"losses {r['losses']}" + (f"; memory rows by class {[s[3] for s in r['steps']]}"
                                         if name == "contrastive" else ""))
    print("cpcsam: the contrastive run moved its heads and the LoRA tensors, the VAT run resumed "
          "from its checkpoint at iteration 2 (parameters, optimizer count, memory); frozen "
          "encoder bit-identical in both")
    return {"launches": launches, "phase1_step_ms": med[1], "phase2_step_ms": med[2],
            "max_memory_allocated": peak, "log": work / "log.txt",
            "card_vs_cpu": {m: list(v) for m, v in errs.items()},
            "aux": {name: {"step_ms": [s[1] * 1e3 for s in r["steps"]],
                           "max_memory_allocated": r["peak"], "losses": r["losses"]}
                    for name, r in aux.items()}}, trainer, datasets


# ---------------------------------------------------------------------------
# route-training phase: a phase-1 step through every other route of the encoder
# ---------------------------------------------------------------------------

# label, the encoder's options, MIA_WINDOWED_ATTN=1 around the calls, launches of
# one phase-1 loss and backward (6 labeled images, LoRA on q and v: every block's
# attention and exit need a gradient, block 0's K4 does not)
ROUTE_TRAIN_VARIANTS = (
    ("K9 exit", dict(fuse_unpart_residual="always"), False,
     {"K4": 8, "K4b": 7, "K2": 8, "K2b": 8, "K3": 4, "K3b": 4, "K9": 8, "K9b": 8}),
    ("grid-native by argument", dict(fuse_ln_window="never", attn_route="grid_native"), False,
     {"K8": 8, "K8b": 8, "K3": 4, "K3b": 4}),
    ("grid-native by MIA_WINDOWED_ATTN=1", dict(fuse_ln_window="never"), True,
     {"K8": 8, "K8b": 8, "K3": 4, "K3b": 4}),
    ("head-major", dict(attn_route="head_major"), False,
     {"K6": 12, "K6b": 12, "K4": 8, "K4b": 7}),
    ("no rel-pos", dict(use_rel_pos=False), False, {"K7": 12, "K4": 8, "K4b": 7}),
)
ROUTE_LOSS_TOL = 1e-5  # relative, float32 convolutions
ROUTE_GRAD_TOL = 1e-4  # of the default route's largest LoRA gradient


def route_train_phase(torch, device, trainer, datasets):
    import copy

    import numpy as np

    from mia_tpu_torch.training.cpcsam_trainer import CPCSAMTrainer

    counts = counters()
    launches = {k: 0 for k in counts}
    train_set = datasets["train"]
    picks = list(range(6)) + list(range(32, 38))  # 6 labeled, 6 unlabeled slices
    images = torch.from_numpy(np.stack([np.repeat(train_set.images[i][..., None], 3, -1)
                                        for i in picks])).to(device)
    labels = torch.from_numpy(train_set.labels[picks]).long().to(device)
    # the trained model of the CPC-SAM phase (LoRA B no longer zero) with seeded rel-pos
    # tables: the reference initialises them at zero and the run has no checkpoint
    base = copy.deepcopy(trainer.model)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    zeroed = copy.deepcopy(base)
    with torch.no_grad():
        for name, p in zeroed.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.zero_()
    config = dict(image_size=trainer.config.image_size, num_classes=3, batch_size=12,
                  labeled_batch_ratio=0.5, lora_rank=4, dice_weight=0.8, promptmode=["point"],
                  optimizer_name="adam")

    def stepper(model):
        tr = CPCSAMTrainer(device=device, config=config)
        tr.model, tr.logger, tr.epoch_train_outputs = model, trainer.logger, []
        tr._setup_loss()
        tr._setup_optimizer()
        return tr

    def loss_and_grads(tr, tf32):
        """One phase-1 loss and its LoRA gradients, counted → (loss, grads,
        launches, peak bytes)."""
        lora = [p for n, p in tr.model.named_parameters() if "lora_" in n]
        for fn in counts.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            total = tr.compute_losses(images, labels, 0, False)[0]
            grads = torch.autograd.grad(total, lora)
            torch.cuda.synchronize()
        finally:
            torch.backends.cudnn.allow_tf32 = True
        seen = {k: fn.launches for k, fn in counts.items() if fn.launches}
        return total.item(), grads, seen, torch.cuda.max_memory_allocated(device)

    def timed(tr):
        return median_s(lambda: loss_and_grads(tr, True), torch, n=2, warmup=0) * 1e3

    default = stepper(base)
    want = {"default": loss_and_grads(default, False), "zeroed": loss_and_grads(stepper(zeroed), False)}
    check(want["default"][2] == {k: v for k, v in STEP_LAUNCHES[1].items() if v},
          f"default route: launches of a phase-1 loss and backward {want['default'][2]}")
    tables_reach = (max((a - b).abs().max().item() for a, b in zip(want["default"][1], want["zeroed"][1]))
                    / max(g.abs().max().item() for g in want["default"][1]))
    check(tables_reach > 10 * ROUTE_GRAD_TOL,
          f"the rel-pos tables move the LoRA gradients by only {tables_reach} of max |grad|")
    print(f"route training: default route: phase-1 loss {want['default'][0]:.6f}; zeroing the "
          f"seeded rel-pos tables moves its LoRA gradients by {tables_reach:.3g} of max |grad|")
    del zeroed
    out = {}
    for label, options, switch, expect in ROUTE_TRAIN_VARIANTS:
        tr = stepper(with_encoder(base, **options))
        check(tr.model.training and tr.model.image_encoder.blocks[0].attn.lora_rank == 4,
              f"{label}: the variant is not the LoRA-4 model in train mode")
        with windowed_attn_switch(switch):
            loss, grads, seen, peak = loss_and_grads(tr, False)
            # in turns beside the default (TF32 convolutions, as a run)
            base_a, ms_a = timed(default), timed(tr)
            ms_b, base_b = timed(tr), timed(default)
            # a full optimizer step through the trainer
            before = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
            tr.train_step({"image": images, "label": labels})
            tr._flush_train_logs()
            torch.cuda.synchronize()
        check(seen == expect, f"{label}: launches of a phase-1 loss and backward {seen}, "
              f"expected {expect}")
        ref_loss, ref_grads, _, ref_peak = want["default" if options.get("use_rel_pos", True)
                                                else "zeroed"]
        loss_err = abs(loss - ref_loss) / abs(ref_loss)
        scale = max(g.abs().max().item() for g in ref_grads)
        grad_err = max((a - b).abs().max().item() for a, b in zip(grads, ref_grads)) / scale
        check(math.isfinite(loss) and loss_err <= ROUTE_LOSS_TOL,
              f"{label}: phase-1 loss {loss} differs from the default route's by {loss_err}")
        check(len(grads) == 48 and scale > 0 and grad_err <= ROUTE_GRAD_TOL,
              f"{label}: LoRA gradients differ from the default route's by {grad_err} of max |grad|")
        step_loss = tr.epoch_train_outputs[-1]["loss"]
        changed = {n for n, p in tr.model.named_parameters() if not torch.equal(p.detach(), before[n])}
        check(all(math.isfinite(v) for v in step_loss) and tr.optimizer.count == 1,
              f"{label}: train_step losses {step_loss}, optimizer steps {tr.optimizer.count}")
        check(sum("lora_" in n for n in changed) == 48
              and not [n for n in changed if n.startswith("image_encoder.") and "lora_" not in n],
              f"{label}: one train_step must move the 48 LoRA tensors and no frozen one")
        for k, n in seen.items():
            launches[k] += n
        out[label] = {"step_ms": min(ms_a, ms_b), "default_ms": min(base_a, base_b),
                      "max_memory_allocated": peak, "default_max_memory_allocated": ref_peak}
        against = ("the default route" if options.get("use_rel_pos", True)
                   else "the default route with zeroed rel-pos tables")
        print(f"route training: {label}: launches {seen}; loss within {loss_err:.3g}, LoRA "
              f"gradients within {grad_err:.3g} of max |grad| of {against} (float32 "
              f"convolutions); phase-1 loss + backward {ms_a:.2f} / {ms_b:.2f} ms, default "
              f"{base_a:.2f} / {base_b:.2f} ms (batch 12, 6 labeled, means of 2 after a first call, in "
              f"turns); "
              f"peak {peak / 2**30:.2f} GiB, default {ref_peak / 2**30:.2f} GiB; one train_step "
              f"moved the LoRA tensors")
    return {"launches": launches, "routes": out}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, default=None, help="also write logs here")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA GPU is required",
              file=sys.stderr)
        return 2
    missing = [src for _, src, _ in KERNELS.values() if not (HERE / src).is_file()]
    if missing:
        print(f"chip_smoke: {missing} not found next to this script; run it from a "
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

    seconds = {}

    def timed(label, phase, *phase_args):
        t0 = time.perf_counter()
        result = phase(*phase_args)
        seconds[label] = round(time.perf_counter() - t0, 1)
        return result

    measured = {"K1": timed("K1", kernel_phase, torch, device),
                **timed("K2-K4", sam_kernel_phase, torch, device),
                **timed("K2b-K4b, K5", train_kernel_phase, torch, device),
                **timed("K6-K9", route_kernel_phase, torch, device),
                **timed("K6b, K8b, K9b", route_bwd_kernel_phase, torch, device)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = timed("AL slice", slice_phase, torch, Path(tmp))
        cpc, cpc_trainer, acdc = timed("CPC-SAM", cpcsam_phase, torch, device, Path(tmp))
        route_train = timed("route training", route_train_phase, torch, device, cpc_trainer, acdc)
        del cpc_trainer, acdc
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            shutil.copy(sl["log"], args.out / "chip_smoke_train_log.txt")
            shutil.copy(cpc["log"], args.out / "chip_smoke_cpcsam_log.txt")
    sam, model, cpu_model = timed("SAM serving", sam_phase, torch, device)
    routes = timed("encoder routes", route_phase, torch, device, model)
    amg = timed("AMG", amg_phase, torch, device, model, cpu_model)
    print(f"seconds by phase: build {build_s:.1f}, {seconds}")
    # each path ran with every count set to 0 just before it: K1 from the
    # AL slice, K2-K4 forward from SAM serving, CPC-SAM training, the encoder
    # routes and AMG, the backward kernels of K2-K4 and K5 from CPC-SAM
    # training, K6-K9 from the encoder routes and, with K6b, K8b and K9b, from
    # route training, K8 from AMG on the grid-native encoder too
    launches = {k: sum(path["launches"].get(k, 0) for path in (sam, cpc, route_train, routes, amg))
                for k in KERNELS}
    launches["K1"] = sl["launches"]
    for k in KERNELS:
        check(launches[k] > 0, f"{k} was launched on no path")
    imported = sorted(m for m in sys.modules if m in ("jax", "mia_tpu")
                      or m.startswith(("jax.", "mia_tpu.")))
    check(not imported, f"JAX or the JAX package was imported: {imported}")

    kernels = {"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[key],
        **measured[key],
    } for key, (name, source, replaces) in KERNELS.items()]}
    keys = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for entry in kernels["kernels"]:
        check(keys <= set(entry), f"{entry['name']}: kernels line lacks {keys - set(entry)}")
    result = {"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(
            json.dumps({"card": card, "host_decode": sl["host_decode"],
                        "sam": {k: v for k, v in sam.items() if k != "launches"},
                        "routes": routes["set_image_ms"],
                        "amg": {k: v for k, v in amg.items() if k != "launches"},
                        "cpcsam": {k: v for k, v in cpc.items() if k not in ("launches", "log")},
                        "route_training": route_train["routes"],
                        **kernels, **result}, indent=1))
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
