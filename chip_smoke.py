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
   heads), within 1e-5 of max |plain|; K2 and K3 (3xTF32 on the tensor
   cores) also with their log-sum-exp within 1e-5 of the plain one, two
   launches bit-identical, the library call and the tensor-core bound
   (``tc_bound_ms``, 495/3 TFLOP/s) at batch 1 and 8. K6, K7, K8, K9 (head-major rel-pos
   attention, dense-bias attention, grid-native windowed attention,
   unpartition + residual + LayerNorm) the same way at the serving shapes
   for batch 1 and 8, a 20x27 grid (K8, K9), a non-aligned token count (K6,
   K7) and head dim 80, through the public wrappers; K9's x_new bit for bit.
   K6 and K7 (3xTF32 on the tensor cores, like K6b) also at odd token
   counts (35; K6 at 5x7 and 10x12) and K7 with -inf over the first key
   tile of every other row, two launches bit-identical on every case, and
   with ``tc_bound_ms``; K8 (3xTF32 too) with its log-sum-exp by token
   within 1e-5 of the plain one, two launches bit-identical on every case,
   with ``tc_bound_ms`` and its batch-8 numbers.
   Times each kernel and its plain version in turns with CUDA events and,
   for K1, K4, K4b, K5, K8, K9 and K9b, also reads the kernels' device time under
   ``torch.profiler`` over a block of the same calls (``device_ms``: the
   event time of a short kernel includes the host's dispatch), and,
   for the attention kernels, one ``scaled_dot_product_attention`` call on
   the same inputs with the dense bias built beforehand (``library_ms``;
   the port never calls it). Computes each kernel's bound from the timed
   tensors: bytes over 3.35 TB/s or operations over 67 TFLOP/s (float32
   outside the tensor cores, what most kernels here compute in).
   Training kernels: the backward kernels of K2, K3 and K4 against their
   plain VJPs at the ViT-B/512 training shapes for batch 12 and 6, within
   1e-4 of max |plain| for each output, K2b and K3b (3xTF32 on the tensor
   cores) also bit-identical over two launches and with a second bound,
   ``tc_bound_ms``, at 495/3 TFLOP/s; and K5 (connected components, at
   most 16 sweeps, each mask's loop ending at its first sweep that changes
   nothing) bit for bit on 3 x 12 x 4 class masks of 64x64 pseudo-labels
   (blob, speckled, empty, full) and on a 512x512 stack, two launches
   bit-identical, with the most sweeps any 64x64 mask takes; timed the same
   way.
   The backward kernels of K6, K8 and K9 the same way (K6b at the windowed
   and the global shapes, a non-aligned token count and head dim 80, two
   launches bit-identical, with ``tc_bound_ms``; K8b and
   K9b also on a 20x27 grid, K8b (3xTF32, like K6b) on 32x28 and 28x32
   grids (pad windows only at the bottom, only at the right) and on a grid
   of whole windows, where dbias_kv is exactly zero, two launches
   bit-identical on every case, with ``tc_bound_ms``; K9b's pad slots
   exactly zero), their library time autograd through one
   ``scaled_dot_product_attention`` call.
   K10 and K10b (the k2/s2 transposed convolution and its backward) at the
   four stages of CPC-SAM's prompt-large upscaler (batch 12), the two of the
   plain SAM upscaler, the UNet decoder's four (batch 12 and 32, 256²) and
   ragged grids on both routes (3xTF32 tensor cores, float32 CUDA cores):
   forward within 1e-5, ``dx``, ``dw``, ``db`` within 1e-4 of max |plain|, two
   backward launches bit-identical, ``dx`` alone equal to the full backward's;
   each timed stage with its route, its float32 and 3xTF32 bounds and one
   ``F.conv_transpose2d`` call on channels-last views of the same operands
   (autograd through it for K10b) with TF32 and with full float32
   convolutions.
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
   Selector phase: with the trained UNet and the slice's active set (16
   labeled, 32 in the pool), each selector the JAX package has beyond random
   and entropy (confidence, margin, coreset-l2/-cosine, kmean-l2/-cosine,
   badge) picks 8 cases on the card (timed, sweep included, with the TF32
   convolutions) and, with float32 convolutions, against the CPU: the same
   ids unless the closest decision lies within 1e-4 of a tie (printed);
   confidence and margin scores, ``enc_feature`` and the BADGE embeddings
   within 1e-4 of max |value|; ``kcenter_greedy`` on one distance matrix and
   the k-means++ core on the same draws pick the same on both devices. Then
   ``al_train_torch``'s ``train_entry`` on ``cuda`` at full width, 6
   iterations a round: 2 rounds of ``--active-selector badge``; ``--resume``
   from its round 0 (restored round, iteration, parameters and optimizer
   count checked); ``--init-round-path`` at the slice's round 0 with
   coreset-cosine (starts at round 1, first logits equal to round 0's best
   model's); ``--dataset busi --num-classes 1`` with kmean-cosine on 48/8
   synthetic 448x560 PNGs. Each run: one K1 launch a train step, finite
   losses, the round files (``model.msgpack``; with the training state
   ``opt_state.msgpack`` and ``training_state.json``, the JAX package's
   files), the labeled set growing by the budget; ``--resume`` restores
   every parameter and moment of those files with |diff| 0.
   Demo and checkpoint phase: every ``best_model`` and ``final_model`` that
   the slice run wrote holds, bit for bit, what its trainer held when it
   wrote it (``model.msgpack``, ``opt_state.msgpack`` read back through
   ``load_optax_state``). A grayscale ``al_train_torch`` run (one round of 6
   iterations, 32..512) writes the ``model.msgpack`` that a card
   ``DemoSession`` (``demo_serve_torch``: UNet 32..512, 3 classes, 256²)
   loads: its class maps equal the trainer's model's on the same
   preprocessed frames; then the session loop on 80 synthetic 480x640 PNGs
   (16 labeled, 64 in the pool, budget 10, batch 4): ``active_select`` on
   the specialist features, ``editor_value``, ``accept`` of two picks and
   ``create_download_dataset`` (the zip holds exactly the accepted images
   and masks). Card against CPU with float32 convolutions: the specialist
   features within 1e-5 of max |feature|, the same 10 picks (or a differing
   pick within 1e-4 of a tie), equal class maps except where the top-2
   logits lie within 1e-4. Times ``predict_batch`` at batch 1, 16 and 64,
   ``predict_pseudo_label`` on one 480x640 PNG and ``active_select``
   (medians of 11 after a warm-up, TF32 convolutions); the demo launches no
   hand kernel.
   FUGC K-fold phase: ``fugc2025_train_torch``'s ``train_entry`` on the same
   set with the entry's defaults (UNet 32..512, batch 32, adam with L2 decay
   0.1) at 256²: 2 folds of 8 iterations. Checks one K1 launch a step, the
   no-leak splits, each fold's files and ``model.msgpack``, finite falling
   losses. Then the same trainer with ``einsum_upsample`` and the decoder's
   stages on ``use_kernel="always"`` and ``--postprocess-mask``: 4 K10 and 4
   K10b launches a step, and one loss and its gradients held against the
   default decoder's from the same weights (float32 convolutions: 1e-5 and
   1e-4 of max |grad|; TF32: 1e-3 and 2e-2). Then
   ``fugc2025_predict_torch``'s ``predict_entry`` on two seeded full-width
   ``LegacyUNet`` folds (``checkpoint_best.pth``) and three frames at their
   own size: class maps in {0, 1, 2}, and ``model.predict`` on the card
   against the CPU (fraction of differing pixels at most 1e-3 with float32
   convolutions, 1e-2 with TF32).
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
   training state: ``lora.msgpack``, ``training_state.json`` and
   ``training_state.pth``) and ``--use-adv-loss --resume`` from that
   checkpoint (resumes at iteration 2 with the saved parameters, optimizer
   count and memory; VAT loss positive); a ``--test-only --lora-ckpt
   lora.msgpack`` run restores that checkpoint bit for bit.
   Route-training phase: the trained CPC-SAM model with seeded rel-pos
   tables and, in its place, the encoder of each other route (K9 exit,
   grid-native by argument and by ``MIA_WINDOWED_ATTN=1``, head-major, no
   rel-pos) takes one phase-1 loss and backward at batch 12 (6 labeled):
   exact launch counts of the forward and backward kernels, the loss within
   1e-5 and the LoRA gradients within 1e-4 of max |grad| of the default
   route's (the no-rel-pos variant against the default with zeroed tables),
   its time and peak memory beside the default's, and one full
   ``CPCSAMTrainer.train_step``. The same for the default encoder with the 12
   stages of the three prompt-large upscalers on K10/K10b (12 launches each).
5. SAM phase: builds ``sam_model_registry["vit_b"](512, 3)`` with seeded
   random weights on ``cuda`` and serves a seeded 480x640 uint8 frame
   through ``SamPredictor``: ``set_image``, ``predict`` with a point, a box,
   and point + box + the previous low-res mask, ``predict_batch`` with 16
   point prompts. Checks shapes, finite values, 8 K2, 4 K3 and 8 K4 launches
   per ``set_image``, and the embedding, masks and iou on the card against
   the same weights on the CPU. Prints the latencies, the encoder's img/s
   at batch 8 and how far the embedding with the default TF32 convolutions
   lies from the one with full float32 convolutions on the card. Then
   ``predict`` and ``predict_batch`` with the mask decoder's upscaler on
   K10: 2 launches a decode, mask logits within 1e-4 of max |logit| of the
   default's.
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
7. Prints one JSON line with the 17 kernels (K1-K10, forward, and the
   backward kernels K2b-K4b, K6b, K8b, K9b, K10b, with their launches in the
   paths that ran them, their bounds and library times; K2, K3, K6, K7, K8,
   K2b, K3b, K6b and K8b also their tensor-core bound, K2, K3 and K8 their
   batch-8 numbers under ``b8``, K1, K4, K4b, K5, K8, K9 and K9b their ``device_ms``),
   then the result line
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
    "K2": ("fused_attention_rel_packed_ik (K2)", "mia_tpu_torch/csrc/attention_fwd_tc.cuh",
           "mia_tpu/ops/attention.py:923"),
    "K2b": ("fused_attention_rel_packed_ik backward (K2)",
            "mia_tpu_torch/csrc/attention_bwd_tc.cuh", "mia_tpu/ops/attention.py:1076"),
    "K3": ("fused_attention_rel_packed (K3)", "mia_tpu_torch/csrc/attention_fwd_tc.cuh",
           "mia_tpu/ops/attention.py:605"),
    "K3b": ("fused_attention_rel_packed backward (K3)", "mia_tpu_torch/csrc/attention_bwd_tc.cuh",
            "mia_tpu/ops/attention.py:712"),
    "K4": ("ln_window_partition (K4)", "mia_tpu_torch/csrc/ln_window.cu",
           "mia_tpu/ops/ln_window.py:230"),
    "K4b": ("ln_window_partition backward (K4)", "mia_tpu_torch/csrc/ln_window.cu",
            "mia_tpu/ops/ln_window.py:178"),
    "K5": ("connected_components_pallas (K5)", "mia_tpu_torch/csrc/connected_components.cu",
           "mia_tpu/ops/morphology.py:235"),
    "K6": ("fused_attention_rel (K6)", "mia_tpu_torch/csrc/attention_fwd_tc.cuh",
           "mia_tpu/ops/attention.py:296"),
    "K6b": ("fused_attention_rel backward (K6)", "mia_tpu_torch/csrc/attention_bwd_tc.cuh",
            "mia_tpu/ops/attention.py:429"),
    "K7": ("fused_attention (K7)", "mia_tpu_torch/csrc/attention_fwd_tc.cuh",
           "mia_tpu/ops/attention.py:88"),
    "K8": ("fused_attention_rel_win (K8)", "mia_tpu_torch/csrc/attention_fwd_tc.cuh",
           "mia_tpu/ops/attention.py:1334"),
    "K8b": ("fused_attention_rel_win backward (K8)", "mia_tpu_torch/csrc/attention_bwd_tc.cuh",
            "mia_tpu/ops/attention.py:1509"),
    "K9": ("unpartition_add_ln (K9)", "mia_tpu_torch/csrc/unpartition_residual.cu",
           "mia_tpu/ops/unpartition_residual.py:221"),
    "K9b": ("unpartition_add_ln backward (K9)", "mia_tpu_torch/csrc/unpartition_residual.cu",
            "mia_tpu/ops/unpartition_residual.py:161"),
    "K10": ("conv_transpose2x_p (K10)", "mia_tpu_torch/csrc/upsample2x.cu",
            "mia_tpu/ops/upsample2x.py:171"),
    "K10b": ("conv_transpose2x_p backward (K10)", "mia_tpu_torch/csrc/upsample2x.cu",
             "mia_tpu/ops/upsample2x.py:137"),
}
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores: what most kernels here compute in
# K2, K3, K6, K7, K8, K2b, K3b, K6b and K8b run 3xTF32 on the tensor cores: the card's dense
# TF32 rate, three MMAs a product
TC_3XTF32_FLOPS_PER_S = 495e12 / 3
KERNEL_TOL = 1e-5  # forward kernels: max |kernel - plain| over max |plain|, float32
LSE_TOL = 1e-5  # K2's, K3's and K8's log-sum-exp against the plain one, absolute (values ~10)
BWD_TOL = 1e-4  # backward kernels, per output (float32; another summation order, p from the lse)


def counters():
    """Every kernel wrapper's launch counter, by kernel key."""
    from mia_tpu_torch.ops import (attention, ln_window, morphology, unpartition_residual,
                                   upsample2x, warp)

    return {"K10": upsample2x.conv_transpose2x,
            "K10b": upsample2x.conv_transpose2x_fused_bwd,
            "K6": attention.fused_attention_rel,
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


def device_ms(torch, fn, kernel, per_block=50):
    """The device time (ms) of one launch of the device kernel whose name
    holds ``kernel``, from its durations under ``torch.profiler`` over one
    block of ``per_block`` calls of ``fn`` (without the host's dispatch that
    the CUDA-event time of a short kernel includes); and the device time of
    the call's other kernels (the wrapper's conversions) a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(per_block):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in events if kernel in e.key]
    check(mine, f"the profiler recorded no {kernel} launch")
    others = sum(e.self_device_time_total for e in events if kernel not in e.key)
    return (sum(e.self_device_time_total for e in mine) / 1e3 / sum(e.count for e in mine),
            others / 1e3 / per_block)


def with_device_ms(torch, name, fn, kernel, m, per_block=50):
    """``m`` with ``device_ms`` of ``kernel`` in ``fn`` added, printed beside
    its CUDA-event time."""
    ms, others = device_ms(torch, fn, kernel, per_block)
    print(f"{name}: device time {ms * 1e3:.2f} us a launch of {kernel} under the profiler "
          f"(other device kernels of the call {others * 1e3:.2f} us), CUDA-event time of the "
          f"call {m['ms'] * 1e3:.2f} us")
    return {**m, "device_ms": ms}


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


def tc_bound_ms(tensors, flops):
    """``bound``'s least time with ``flops`` at the 3xTF32 tensor-core rate
    (495/3 TFLOP/s) in place of the float32 one."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    return max(nbytes / HBM_BYTES_PER_S, flops / TC_3XTF32_FLOPS_PER_S) * 1e3


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


def bit_identical(torch, name, label, first, second):
    """Fail unless two launches gave the same outputs, bit for bit."""
    torch.cuda.synchronize()
    check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(first, second)),
          f"{name} {label}: two launches differ")


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
    m = {"max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms, "library_ms": None,
         **bound([img, img, *idx], 0)}
    return with_device_ms(torch, "K1 at (12, 256, 256, 4)", lambda: warp._launch_k1(img, *idx),
                          "affine_warp_shift2pass_kernel", m)


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
    saved = {}  # best_model / final_model path → what the trainer held when it wrote it
    orig_step = ALTrainer.train_step
    orig_record = ALTrainer._record_train_loss
    orig_start, orig_end = ALTrainer.on_round_start, ALTrainer.on_round_end
    orig_save = ALTrainer.save_state_dict

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

    def save(self, save_path, save_training_state=False, model_state=None):
        orig_save(self, save_path, save_training_state, model_state)
        if Path(save_path).name in ("best_model", "final_model"):
            state = self.model.state_dict() if model_state is None else model_state
            opt = self.state.optimizer
            saved[Path(save_path)] = (
                {k: v.detach().cpu().clone() for k, v in state.items()},
                (opt.count, [t.cpu().clone() for t in opt.mu], [t.cpu().clone() for t in opt.nu])
                if save_training_state else None)

    def round_end(self):
        out = orig_end(self)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - self._smoke_t0)
        return out

    ALTrainer.train_step, ALTrainer._record_train_loss = timed_step, record
    ALTrainer.on_round_start, ALTrainer.on_round_end = round_start, round_end
    ALTrainer.save_state_dict = save
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
        ALTrainer.save_state_dict = orig_save

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
        for rel in ("data_list.json", "best_model/model.msgpack", "final_model/model.msgpack"):
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
    return {"launches": launches, "log": work / "log.txt", "host_decode": decode_path(),
            "trainer": trainer, "data": data, "work": work, "saved": saved}

# ---------------------------------------------------------------------------
# selector phase: every AL selector on the card against the CPU, then
# al_train_torch with BADGE, --resume, --init-round-path and BUSI
# ---------------------------------------------------------------------------

NEW_SELECTORS = ("confidence", "margin", "coreset-l2", "coreset-cosine", "kmean-l2",
                 "kmean-cosine", "badge")
SELECT_TOL = 1e-4  # card (float32 convolutions) against CPU, of the largest |value|


class CachedScorer:
    """The CPU's ``ModelScorer`` with each image's outputs kept: the holds
    and the seven selectors ask it for the same images again and again (an
    image's probabilities, bottleneck features and BADGE embedding do not
    depend on the other images of its batch)."""

    def __init__(self, torch, scorer):
        self.torch, self.scorer, self.device, self.cache = torch, scorer, scorer.device, {}

    def _rows(self, name, fn, images):
        import hashlib

        keys = [(name, hashlib.blake2b(img.numpy().tobytes(), digest_size=16).digest())
                for img in images.cpu()]
        missing = [i for i, k in enumerate(keys) if k not in self.cache]
        if missing:
            for i, row in zip(missing, fn(images[missing])):
                self.cache[keys[i]] = row
        return self.torch.stack([self.cache[k] for k in keys])

    def uncertainty(self, images, kind):
        from mia_tpu_torch.activelearning.scorers import _SCORES

        return _SCORES[kind](self._rows("probs", self.scorer.probs, images))

    def enc_feature(self, images):
        return self._rows("enc", self.scorer.enc_feature, images)

    def badge_grad_embedding(self, images):
        return self._rows("badge", self.scorer.badge_grad_embedding, images)


def kcenter_margin(torch, dist, n_core, budget, criteria="min"):
    """The least gap, over the greedy steps, between the best and the
    second-best score, over the best: how far the k-center picks are from a
    tie (replayed on the CPU)."""
    mask = torch.arange(dist.shape[0]) < n_core
    margins = []
    for _ in range(budget):
        if criteria == "min":
            d = torch.where(mask[None, :], dist, torch.tensor(float("inf"))).amin(1)
        else:
            d = (dist * mask[None, :].float()).sum(1) / mask.sum().clamp_min(1)
        top = torch.topk(torch.where(mask, torch.tensor(-float("inf")), d), 2).values
        margins.append(((top[0] - top[1]) / top[0].abs()).item())
        mask[torch.argmax(torch.where(mask, torch.tensor(-float("inf")), d))] = True
    return min(margins)


def kmeans_margin(torch, x, seed, k, weight=None):
    """How far the k-means++ picks of ``x`` (the selectors' draws from
    ``Generator().manual_seed(seed)``) are from a flip: the least, over the
    steps, of the distance of a draw to a boundary of the running potential's
    cumsum and of the gap between the best and the second-best candidate's
    potential, each relative (replayed on the CPU)."""
    from mia_tpu_torch.activelearning.selection import n_local_trials_for
    from mia_tpu_torch.ops.distance import pairwise_distances

    gen = torch.Generator().manual_seed(seed)
    u_first, uniforms = torch.rand((), generator=gen), torch.rand(
        (k - 1, n_local_trials_for(k)), generator=gen)
    w = torch.ones(x.shape[0]) if weight is None else weight.float()
    w = w / w.sum()
    cum = torch.cumsum(w, 0)
    margins = [((cum - u_first * cum[-1]).abs().min() / cum[-1]).item()]
    first = torch.searchsorted(cum, u_first * cum[-1]).clamp(0, x.shape[0] - 1)
    d2 = pairwise_distances(x, x, "l2").square()
    closest = d2[first]
    for u in uniforms:
        pot = w * closest
        cum = torch.cumsum(pot, 0)
        vals = u * pot.sum()
        margins.append(((cum[None, :] - vals[:, None]).abs().min() / pot.sum()).item())
        cand = torch.searchsorted(cum, vals).clamp(0, x.shape[0] - 1)
        new_pot = (w[None, :] * torch.minimum(closest[None, :], d2[cand])).sum(1)
        ranked = torch.sort(torch.unique(new_pot)).values
        if ranked.numel() > 1:
            margins.append(((ranked[1] - ranked[0]) / ranked[0]).item())
        closest = torch.minimum(closest, d2[cand[torch.argmin(new_pot)]])
    return min(margins)


def decision_margin(torch, key, active, scorer, budget, seed):
    """How far ``key``'s picks with ``scorer`` (the CPU's) are from a tie."""
    import numpy as np

    from mia_tpu_torch.activelearning import sweep_pool
    from mia_tpu_torch.ops.distance import pairwise_distances

    cpu = torch.device("cpu")
    pool, labeled = active.get_pool_dataset(), active.get_train_dataset()
    metric = "l2" if key.endswith("l2") else "cosine"
    if key in ("confidence", "margin"):
        scores, _ = sweep_pool(pool, 12, lambda im: scorer.uncertainty(im, key), cpu)
        s = np.sort(scores)[::-1]
        return float((s[budget - 1] - s[budget]) / np.abs(s).max())
    if key == "badge":
        emb, _ = sweep_pool(pool, 8, scorer.badge_grad_embedding, cpu)
        return kmeans_margin(torch, torch.from_numpy(emb), seed, budget)
    feats_l = torch.from_numpy(sweep_pool(labeled, 12, scorer.enc_feature, cpu)[0])
    feats_p = torch.from_numpy(sweep_pool(pool, 12, scorer.enc_feature, cpu)[0])
    if key.startswith("coreset"):
        dist = pairwise_distances(torch.cat([feats_l, feats_p]), metric=metric)
        return kcenter_margin(torch, dist / dist.sum(), len(feats_l), budget)
    z = [(f - f.mean(1, keepdim=True)) / f.std(1, keepdim=True, unbiased=False)
         for f in (feats_p, feats_l)]
    weight = pairwise_distances(z[0], z[1], metric).amin(1)
    return kmeans_margin(torch, z[0], seed, budget, weight)


def write_busi(root: Path, n_train=48, n_valid=8, size=(448, 560), seed=0):
    """BUSI-layout PNGs as ``tests/synth_data.py::make_busi`` writes them:
    noise images, random 0/1 labels, ``split.json`` (test = valid)."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    (root / "images").mkdir(parents=True, exist_ok=True)
    (root / "labels").mkdir(parents=True, exist_ok=True)
    ids = list(range(n_train + n_valid))
    for i in ids:
        Image.fromarray(rng.integers(0, 256, size).astype(np.uint8)).save(
            root / "images" / f"{i:04}.png")
        Image.fromarray(rng.integers(0, 2, size).astype(np.uint8)).save(
            root / "labels" / f"{i:04}.png")
    split = {"train": ids[:n_train], "valid": ids[n_train:], "test": ids[n_train:]}
    (root / "split.json").write_text(json.dumps(split))


def run_al(torch, argv, hooks=None):
    """``al_train_torch``'s ``train_entry(argv)`` with each train step's K1
    launches and each train loss recorded; ``hooks`` maps ALTrainer method
    names to wrappers ``(orig) -> method`` for this run."""
    from mia_tpu_torch.entry.activelearning.train import train_entry
    from mia_tpu_torch.ops import warp
    from mia_tpu_torch.training import ALTrainer

    rec = {"k1": [], "losses": []}

    def train_step(orig):
        def step(self, batch):
            before = warp.affine_warp_shift2pass_fused.launches
            orig(self, batch)
            rec["k1"].append(warp.affine_warp_shift2pass_fused.launches - before)
        return step

    def record_loss(orig):
        def record(self, step_index, lr, loss):
            rec["losses"].append(loss)
            return orig(self, step_index, lr, loss)
        return record

    wrappers = {"train_step": train_step, "_record_train_loss": record_loss, **(hooks or {})}
    originals = {name: getattr(ALTrainer, name) for name in wrappers}
    for name, wrap in wrappers.items():
        setattr(ALTrainer, name, wrap(originals[name]))
    try:
        trainer = train_entry(argv)
        torch.cuda.synchronize()
    finally:
        for name, orig in originals.items():
            setattr(ALTrainer, name, orig)
    return trainer, rec


def check_al_run(label, trainer, rec, rounds, sizes, iters):
    """One K1 launch a train step, finite losses, each round's files and the
    labeled set of each round."""
    work = trainer.work_path
    check(len(rec["k1"]) == len(rounds) * iters and all(k == 1 for k in rec["k1"]),
          f"{label}: K1 launches per train step {rec['k1']}")
    check(len(rec["losses"]) == len(rounds) * iters
          and all(math.isfinite(x) for x in rec["losses"]), f"{label}: losses {rec['losses']}")
    for r, size in zip(rounds, sizes):
        for rel in ("data_list.json", "best_model/model.msgpack", "final_model/model.msgpack",
                    "final_model/training_state.json", "final_model/opt_state.msgpack"):
            check((work / f"round_{r}" / rel).is_file(), f"{label}: missing round_{r}/{rel}")
        check((work / f"test_mean_round_{r}.csv").is_file(), f"{label}: no test CSV of round {r}")
        got = len(json.loads((work / f"round_{r}/data_list.json").read_text())["labeled_image_idx"])
        check(got == size, f"{label}: round {r} holds {got} labeled cases, expected {size}")


def max_diff(torch, a, b) -> float:
    """max |a - b| of two tensors (on any devices), 0.0 for empty ones."""
    return (a.detach().cpu() - b.detach().cpu()).abs().max().item() if a.numel() else 0.0


def read_al_checkpoint(torch, trainer, path: Path):
    """An ``al_train_torch`` checkpoint directory read back: the state dict of
    its ``model.msgpack`` and, when it holds one, an optimizer of ``trainer``'s
    kind over a CPU UNet restored from its ``opt_state.msgpack`` (else None)."""
    from mia_tpu_torch.models import UNet, unet_state_dict_from_flax
    from mia_tpu_torch.training import load_optax_state, make_optimizer
    from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack

    model_sd = unet_state_dict_from_flax(read_flax_msgpack(path / "model.msgpack"))
    if not (path / "opt_state.msgpack").is_file():
        return model_sd, None
    config, opt = trainer.config, trainer.state.optimizer
    model = UNet(trainer.model.cfg)
    fresh = make_optimizer(config.optimizer_name, model.parameters(),
                           opt.lr if opt.scheduled else config.start_lr, opt.grad_clip,
                           **config.optimizer_kwargs)
    load_optax_state(fresh, model, read_flax_msgpack(path / "opt_state.msgpack"))
    return model_sd, fresh


def selector_phase(torch, device, workdir: Path, sl):
    import numpy as np

    from mia_tpu_torch.activelearning import SELECTORS, ModelScorer, kcenter_greedy, sweep_pool
    from mia_tpu_torch.activelearning.selection import (kmeans_plusplus_from_draws,
                                                        n_local_trials_for)
    from mia_tpu_torch.models import UNet
    from mia_tpu_torch.ops import warp
    from mia_tpu_torch.ops.distance import pairwise_distances

    budget, seed = 8, 1338
    trainer = sl["trainer"]
    active = trainer.active_dataset
    pool, labeled = active.get_pool_dataset(), active.get_train_dataset()
    cpu = torch.device("cpu")
    cpu_model = UNet(trainer.model.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
    card = ModelScorer(trainer.model, device, normalize=True)
    host = CachedScorer(torch, ModelScorer(cpu_model, cpu, normalize=True))

    # (a) each selector on the card (its default TF32 convolutions: the time; float32:
    # the picks) against the CPU
    warp.affine_warp_shift2pass_fused.launches = 0
    select_ms, differ = {}, []
    tf32 = torch.backends.cudnn.allow_tf32
    for key in NEW_SELECTORS:
        selector = SELECTORS[key](batch_size=12 if key != "badge" else 8)
        selector.select_next_batch(active, budget, card, seed=seed)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        selector.select_next_batch(active, budget, card, seed=seed)
        torch.cuda.synchronize()
        select_ms[key] = (time.perf_counter() - t0) * 1e3
        try:
            torch.backends.cudnn.allow_tf32 = False
            got = selector.select_next_batch(active, budget, card, seed=seed)
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        want = selector.select_next_batch(active, budget, host, seed=seed)
        check(len(set(got)) == len(got) == budget and set(got) <= set(pool.image_idx),
              f"{key}: picked {got} from the pool of {len(pool)}")
        if got != want:
            margin = decision_margin(torch, key, active, host, budget, seed)
            check(margin <= SELECT_TOL, f"{key}: card picked {got}, CPU {want}, though the "
                  f"closest decision is {margin:.3g} from a tie")
            differ.append(f"{key} (closest decision {margin:.3g} from a tie)")
    check(warp.affine_warp_shift2pass_fused.launches == 0, "selection launched K1")

    torch.backends.cudnn.allow_tf32 = False
    try:
        holds = {}
        for name, fn_card, fn_host, ds, bs in (
                ("confidence", lambda im: card.uncertainty(im, "confidence"),
                 lambda im: host.uncertainty(im, "confidence"), pool, 12),
                ("margin", lambda im: card.uncertainty(im, "margin"),
                 lambda im: host.uncertainty(im, "margin"), pool, 12),
                ("enc_feature", card.enc_feature, host.enc_feature, pool, 12),
                ("badge", card.badge_grad_embedding, host.badge_grad_embedding, pool, 8)):
            got, names_card = sweep_pool(ds, bs, fn_card, device)
            want, names_host = sweep_pool(ds, bs, fn_host, cpu)
            check(names_card == names_host and got.shape == want.shape,
                  f"{name}: the sweeps differ in shape or order")
            scale = float(np.abs(want).max())
            holds[name] = float(np.abs(got - want).max()) / scale
            check(np.isfinite(got).all() and holds[name] <= SELECT_TOL,
                  f"{name} on the card vs the CPU: {holds[name]:.3g} of max |value| {scale:.3g}")
        feats = torch.from_numpy(np.concatenate([
            sweep_pool(labeled, 12, host.enc_feature, cpu)[0],
            sweep_pool(pool, 12, host.enc_feature, cpu)[0]]))
        emb = torch.from_numpy(sweep_pool(pool, 8, host.badge_grad_embedding, cpu)[0])
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    # the selection algorithms on the same inputs: the same picks on both devices
    dist = pairwise_distances(feats, metric="cosine")
    init = torch.arange(len(feats)) < len(labeled)
    for criteria in ("min", "mean"):
        a = kcenter_greedy(dist, init, budget, criteria)
        b = kcenter_greedy(dist.to(device), init.to(device), budget, criteria).cpu()
        check(torch.equal(a, b), f"kcenter_greedy ({criteria}): CPU {a.tolist()}, card {b.tolist()}")
    uniforms = torch.rand((budget - 1, n_local_trials_for(budget)),
                          generator=torch.Generator().manual_seed(seed))
    weight = dist[len(labeled):, :len(labeled)].amin(1)
    for x, w in ((emb, None), (feats[len(labeled):], weight)):
        a = kmeans_plusplus_from_draws(x, 3, uniforms, w)
        b = kmeans_plusplus_from_draws(x.to(device), 3, uniforms,
                                       None if w is None else w.to(device)).cpu()
        check(torch.equal(a, b), f"k-means++ core: CPU {a.tolist()}, card {b.tolist()}")
    print(f"selectors: card vs CPU (float32 convolutions) of max |value|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in holds.items())
          + f" (limit {SELECT_TOL}); kcenter_greedy and the k-means++ core pick the same on "
          f"both devices; picks equal on both devices for every selector"
          + (f" but {', '.join(differ)}" if differ else ""))
    print(f"selectors: selection ms on the card, pool {len(pool)}, labeled {len(labeled)}, "
          f"budget {budget}, sweep included (TF32 convolutions): "
          + ", ".join(f"{k} {v:.2f}" for k, v in select_ms.items()))

    # (b) through the entry point at full width, 256², batch 12
    iters = 6

    def al_argv(data, dataset, classes, work, selector, *extra):
        return ["--work-path", str(workdir / work), "--data-path", str(data), "--device", "cuda",
                "--dataset", dataset, "--in-channels", "3", "--num-classes", classes,
                "--image-size", "256", "--batch-size", "12", "--valid-mode", "slice",
                "--do-augment", "--do-normalize", "--lr-warmup-iter", "2", "--num-rounds", "2",
                "--budget", str(budget), "--num-iters", str(iters), "--valid-freq-iter", "3",
                "--do-oversample", "--quiet", "--active-selector", selector, *extra]

    runs = {}

    def timed_run(label, argv, hooks=None):
        t0 = time.perf_counter()
        out = run_al(torch, argv, hooks)
        runs[label] = round(time.perf_counter() - t0, 1)
        return out

    warp.affine_warp_shift2pass_fused.launches = 0

    badge_argv = al_argv(sl["data"], "fugc", "2", "sel_badge", "badge")
    t_badge, rec = timed_run("badge", badge_argv)
    check_al_run("badge", t_badge, rec, (0, 1), (budget, 2 * budget), iters)

    # --resume from round 0's final model: round 1 runs again from the saved state
    final = t_badge.work_path / "round_0" / "final_model"
    saved = json.loads((final / "training_state.json").read_text())
    saved_model, saved_opt = read_al_checkpoint(torch, t_badge, final)
    restored = {}

    def capture_resume(orig):
        def load(self, path):
            orig(self, path)
            opt = self.state.optimizer
            restored.update(round=self.current_round, iter=self.current_iter, count=opt.count,
                            diff=max(max_diff(torch, v, saved_model[k])
                                     for k, v in self.model.state_dict().items()
                                     if not k.endswith("num_batches_tracked")),
                            moments_diff=max(max_diff(torch, a, b) for a, b in zip(
                                opt.mu + opt.nu, saved_opt.mu + saved_opt.nu)))
        return load

    t_resume, rec = timed_run("--resume", badge_argv + ["--resume", str(final)],
                              {"load_state_dict": capture_resume})
    check(restored == {"round": saved["current_round"] + 1, "iter": saved["current_iter"] + 1,
                       "count": saved_opt.count, "diff": 0.0, "moments_diff": 0.0},
          f"--resume from opt_state.msgpack restored {restored}; saved round "
          f"{saved['current_round']}, iteration {saved['current_iter']}, optimizer count "
          f"{saved_opt.count}")
    check_al_run("--resume", t_resume, rec, (1,), (2 * budget,), iters)

    # --init-round-path from the slice phase's round 0: the run starts at round 1 with
    # that round's best model (a failed load would only warn and train on)
    round_0 = sl["work"] / "round_0"
    best = UNet(trainer.model.cfg).to(device)
    best.load_state_dict(read_al_checkpoint(torch, trainer, round_0 / "best_model")[0])
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(2)).to(device)
    first = []

    def capture_start(orig):
        def start(self):
            if not first:
                self.model.eval()
                best.eval()
                torch.backends.cudnn.allow_tf32 = False
                try:
                    with torch.no_grad():
                        first.append((self.current_round, self.model(x), best(x)))
                finally:
                    torch.backends.cudnn.allow_tf32 = tf32
            return orig(self)
        return start

    t_init, rec = timed_run("--init-round-path", al_argv(
        sl["data"], "fugc", "2", "sel_init", "coreset-cosine", "--init-round-path", str(round_0)),
        {"on_round_start": capture_start})
    start_round, got, want = first[0]
    err = (got - want).abs().max().item()
    check(start_round == 1 and err <= 1e-5 * want.abs().max().item(),
          f"--init-round-path: started at round {start_round}, first logits {err:.3g} from "
          f"round 0's best model")
    check(not (t_init.work_path / "round_0").exists(), "--init-round-path ran round 0")
    round0_labeled = json.loads((round_0 / "data_list.json").read_text())["labeled_image_idx"]
    check_al_run("--init-round-path", t_init, rec, (1,), (len(round0_labeled) + budget,), iters)

    busi = workdir / "busi"
    write_busi(busi)
    t_busi, rec = timed_run("busi", al_argv(busi, "busi", "1", "sel_busi", "kmean-cosine"))
    check(t_busi.model.decoder.seg_output.weight.shape[0] == 2, "BUSI: not two output classes")
    check_al_run("busi", t_busi, rec, (0, 1), (budget, 2 * budget), iters)
    launches = warp.affine_warp_shift2pass_fused.launches
    header = (t_busi.work_path / "test_mean_round_1.csv").read_text().splitlines()[0]
    check(header.startswith("all-DSC") and "tumor-DSC" in header, f"BUSI test CSV: {header}")
    print(f"selectors: al_train_torch at 32..512, 256^2, batch 12, {iters} iterations a round: "
          f"badge 2 rounds, --resume from round 0 at round {restored['round']} iteration "
          f"{restored['iter']} (optimizer count {restored['count']}; every parameter and "
          f"moment |diff| 0 from model.msgpack and opt_state.msgpack), --init-round-path "
          f"(coreset-cosine) from round {start_round} with round 0's best model (first logits "
          f"max |diff| {err:.3g}), BUSI 448x560 kmean-cosine 2 rounds; seconds {runs}; "
          f"K1 launches {launches}, one a train step")
    return {"launches": launches, "select_ms": select_ms, "holds": holds, "runs_s": runs,
            "differ": differ}


# ---------------------------------------------------------------------------
# demo and checkpoint phase: the files the AL trainer wrote, then demo_serve_torch
# serving a model.msgpack of al_train_torch
# ---------------------------------------------------------------------------

DEMO_GAP = 1e-4  # card (float32 convolutions) vs CPU: a class may differ below this top-2 gap
DEMO_FEATURE_TOL = 1e-5  # specialist features, of the largest |feature|
DEMO_RUNS = 11


def same_tree(a, b) -> bool:
    """Two flax state dicts with the same keys, dtypes and bits."""
    import numpy as np

    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys()
                and all(same_tree(a[k], b[k]) for k in a))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def write_frames(root: Path, n, size=(480, 640), seed=0):
    """Grayscale frames with two lip-like ellipses, as the demo's users send them."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    hh, ww = size
    yy, xx = np.mgrid[0:hh, 0:ww]
    paths = []
    for i in range(n):
        image = 60.0 + rng.normal(0.0, 20.0, size)
        for level in (70.0, 140.0):
            cy, cx = rng.uniform(0.25, 0.75) * hh, rng.uniform(0.25, 0.75) * ww
            ry, rx = rng.uniform(0.05, 0.15) * hh, rng.uniform(0.05, 0.15) * ww
            image[((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] += level
        paths.append(str(root / f"frame_{i:03d}.png"))
        Image.fromarray(np.clip(image, 0, 255).astype(np.uint8)).save(paths[-1])
    return paths


def demo_phase(torch, device, workdir: Path, sl):
    import zipfile

    import numpy as np
    from PIL import Image

    from mia_tpu_torch.activelearning import KMeanSelector, ModelScorer
    from mia_tpu_torch.data import ImageDataset
    from mia_tpu_torch.entry.demo.serve import (CLASS_COLOR_MAP, DemoSession, hex_to_rgb,
                                                specialist_feature_provider)
    from mia_tpu_torch.models import unet_state_dict_to_flax
    from mia_tpu_torch.ops.distance import pairwise_distances
    from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack

    # (a) the slice run's best_model and final_model files against what its trainer held
    # when it wrote them, bit for bit
    slice_trainer = sl["trainer"]
    for path, (model_sd, opt) in sorted(sl["saved"].items()):
        names = {"model.msgpack"} | ({"opt_state.msgpack", "training_state.json"} if opt else set())
        label = f"{path.parent.name}/{path.name}"
        check({q.name for q in path.iterdir()} == names,
              f"{label} holds {sorted(q.name for q in path.iterdir())}, expected {sorted(names)}")
        check(same_tree(read_flax_msgpack(path / "model.msgpack"), unet_state_dict_to_flax(model_sd)),
              f"{label}/model.msgpack differs from the weights the trainer held")
        if opt:
            _, read = read_al_checkpoint(torch, slice_trainer, path)
            check(read.count == opt[0] and all(torch.equal(a, b) for a, b in zip(
                read.mu + read.nu, opt[1] + opt[2])) and len(read.mu) == len(opt[1]),
                f"{label}/opt_state.msgpack differs from the optimizer the trainer held")
            state = json.loads((path / "training_state.json").read_text())
            check(set(state) == {"current_iter", "current_epoch", "current_round", "data_list"},
                  f"{label}/training_state.json keys {sorted(state)}")
    checked = sorted(f"{q.parent.name}/{q.name}" for q in sl["saved"])

    # a grayscale specialist for the demo (its UNet takes one channel): al_train_torch at
    # full width, one round, without z-scoring (the demo feeds the model x / 255)
    counts = counters()
    for fn in counts.values():
        fn.launches = 0
    iters = 6
    al, rec = run_al(torch, [
        "--work-path", str(workdir / "demo_al"), "--data-path", str(sl["data"]),
        "--device", "cuda", "--dataset", "fugc", "--in-channels", "1", "--num-classes", "2",
        "--image-size", "256", "--batch-size", "12", "--valid-mode", "slice", "--do-augment",
        "--lr-warmup-iter", "2", "--num-rounds", "1", "--budget", "12", "--num-iters",
        str(iters), "--valid-freq-iter", "3", "--do-oversample", "--quiet",
        "--active-selector", "entropy"])
    check_al_run("grayscale specialist", al, rec, (0,), (12,), iters)
    launches = {k: fn.launches for k, fn in counts.items() if fn.launches}
    ckpt = al.work_path / "round_0" / "best_model" / "model.msgpack"

    # (c) the card session serves that model.msgpack: its class maps are the trainer's
    paths = write_frames(workdir / "demo_frames", 80)
    train_paths, pool_paths = paths[:16], paths[16:]
    for fn in counts.values():
        fn.launches = 0
    session = DemoSession(data_dir=workdir / "demo_card", budget=10, batch_size=4,
                          model_ckpt=ckpt, device="cuda")
    check(session.device.type == "cuda" and next(session.model.parameters()).is_cuda
          and session.model.encoder.levels[4][1].all[0].weight.shape[0] == 512
          and session.model.decoder.seg_output.weight.shape[0] == 3,
          "the demo's UNet is not the 32..512, 3-class model on CUDA")
    frames = np.stack([np.asarray(Image.open(q), np.float32)[..., None] / 255.0
                       for q in paths[:8]])
    x = session.processor.preprocess(torch.from_numpy(frames).to(device))
    held = {k: v for k, v in al.model.state_dict().items() if not k.endswith("num_batches_tracked")}
    check(all(torch.equal(v, session.model.state_dict()[k]) for k, v in held.items()),
          "the session's weights differ from the trainer's model's")
    al.model.eval()
    with torch.no_grad():
        want = al.model(x).argmax(-1).to(torch.int32)
    got = session._predict(x)
    check(x.shape == (8, 256, 256, 1) and torch.equal(got, want),
          f"the session's class maps differ from the trainer's model's at "
          f"{int((got != want).sum())} pixels")
    served_classes = sorted(torch.unique(got).tolist())

    # (d) card against CPU, float32 convolutions: features, picks, class maps
    cpu_session = DemoSession(data_dir=workdir / "demo_cpu", budget=10, batch_size=4,
                              model_ckpt=ckpt, device="cpu")
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        feats = {}
        for key, s in (("card", session), ("cpu", cpu_session)):
            provider = specialist_feature_provider(s.model, s.device, s.batch_size)
            feats[key] = {}
            for group in (train_paths, pool_paths):
                feats[key].update(provider(ImageDataset(group, image_channels=1, image_size=256)))
        scale = max(float(np.abs(v).max()) for v in feats["cpu"].values())
        feature_err = max(float(np.abs(feats["card"][k] - feats["cpu"][k]).max())
                          for k in feats["cpu"]) / scale
        check(list(feats["card"]) == list(feats["cpu"]) == paths
              and feature_err <= DEMO_FEATURE_TOL,
              f"specialist features card vs CPU: {feature_err:.3g} of max |feature|")
        picks = {}
        for key, s in (("card", session), ("cpu", cpu_session)):
            s.train_set, s.pool_set = train_paths, pool_paths
            s.feature_provider = lambda ds, f=feats["cpu"]: {n: f[n] for n in ds.case_names()}
            picks[key] = [str(q) for q in s.active_select()]
        pick_margin = None
        if picks["card"] != picks["cpu"]:
            # how far the CPU's k-means++ picks are from a flip, on the features it picked from
            sel = KMeanSelector(batch_size=4, metric="l2", feature_dict=cpu_session.feature_dict)
            cpu = torch.device("cpu")
            scorer = ModelScorer(cpu_session.model, cpu)
            pool_f, _ = sel._get_features(ImageDataset(pool_paths, image_channels=1,
                                                       image_size=256), scorer, cpu)
            train_f, _ = sel._get_features(ImageDataset(train_paths, image_channels=1,
                                                        image_size=256), scorer, cpu)
            weight = pairwise_distances(pool_f, train_f, "l2").amin(1)
            pick_margin = kmeans_margin(torch, pool_f, 0, 10, weight)
            check(pick_margin <= SELECT_TOL, f"demo picks: card {picks['card']}, CPU "
                  f"{picks['cpu']}, though the closest decision is {pick_margin:.3g} from a tie")
        batch = frames[:4]
        card_maps = session.predict_batch(batch)
        cpu_maps = cpu_session.predict_batch(batch)
        cpu_x = cpu_session.processor.preprocess(torch.from_numpy(batch))
        with torch.no_grad():
            top2 = torch.topk(cpu_session.model(cpu_x), 2, dim=-1).values
        near_tie = (top2[..., 0] - top2[..., 1] < DEMO_GAP).numpy()
        differ = card_maps != cpu_maps
        check(card_maps.shape == (4, 256, 256) and not differ[~near_tie].any(),
              f"class maps card vs CPU differ at {int(differ[~near_tie].sum())} pixels whose "
              f"top-2 logits lie {DEMO_GAP} apart or more")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check(len(set(picks["card"])) == 10 and set(picks["card"]) <= set(pool_paths),
          f"the session picked {picks['card']}")

    # the session loop on the card at its default TF32 convolutions: select, edit, accept
    # two picks, download
    session.feature_dict, session.feature_provider = None, None  # the specialist features
    session.train_set, session.pool_set = train_paths, pool_paths
    selected = [str(q) for q in session.active_select()]
    check(len(set(selected)) == 10 and set(selected) <= set(pool_paths),
          f"active_select picked {selected}")
    accepted = {}
    for k, pick in enumerate(selected[:2]):
        value = session.editor_value(pick)
        check(value["background"].shape == value["layers"][0].shape == (480, 640, 4),
              "editor value malformed")
        layer = np.zeros((480, 640, 4), np.uint8)
        layer[100 + k:180, 200:320] = hex_to_rgb(CLASS_COLOR_MAP[1]) + [255]
        layer[300:380, 350 + k:500] = hex_to_rgb(CLASS_COLOR_MAP[2]) + [255]
        entry = session.accept(pick, value["background"], layer)
        check(int((entry["mask"] == 1).sum()) == (80 - k) * 120
              and int((entry["mask"] == 2).sum()) == 80 * (150 - k), "accepted mask malformed")
        accepted[Path(pick).stem] = (value["background"], entry["mask"])
    check(len(session.selected_set) == 8, "accept left the picks in the selected set")
    zip_path = session.create_download_dataset()
    with zipfile.ZipFile(zip_path) as archive:
        names = sorted(archive.namelist())
        check(names == sorted(f"{d}/{stem}.png" for d in ("images", "labels") for stem in accepted),
              f"the zip holds {names}")
        for stem, (background, mask) in accepted.items():
            with archive.open(f"images/{stem}.png") as f:
                image_ok = np.array_equal(np.asarray(Image.open(f)), background)
            with archive.open(f"labels/{stem}.png") as f:
                mask_ok = np.array_equal(np.asarray(Image.open(f)), mask)
            check(image_ok and mask_ok, f"the zip's {stem}.png differs from what was accepted")

    # (e) the endpoint's times on the card (TF32 convolutions): medians after a warm-up
    rng = np.random.default_rng(5)
    times = {}
    for n in (1, 16, 64):
        batch = rng.random((n, 480, 640, 1)).astype(np.float32)
        times[f"predict_batch_{n}_ms"] = median_s(
            lambda b=batch: session.predict_batch(b), torch, DEMO_RUNS) * 1e3
    frame = Image.open(paths[0])
    times["predict_pseudo_label_ms"] = median_s(
        lambda: session.predict_pseudo_label(frame), torch, DEMO_RUNS) * 1e3
    times["active_select_ms"] = median_s(session.active_select, torch, DEMO_RUNS, warmup=1) * 1e3
    demo_launches = {k: fn.launches for k, fn in counts.items() if fn.launches}
    check(not demo_launches, f"the demo path launched hand kernels: {demo_launches}")

    print(f"demo: checkpoint files of the AL slice equal what its trainer held, bit for bit: "
          f"{', '.join(checked)} (model.msgpack; opt_state.msgpack and training_state.json "
          f"with the training state)")
    print(f"demo: DemoSession (UNet 32..512, 3 classes, 256^2) on the card served "
          f"round_0/best_model/model.msgpack of a grayscale al_train_torch run ({iters} "
          f"iterations); "
          f"class maps equal the trainer's model's on 8 preprocessed 480x640 frames "
          f"(classes {served_classes}); picks {len(selected)} of {len(pool_paths)} "
          f"({len(train_paths)} labeled), accepted 2, zip of {len(names)} PNGs as accepted")
    print(f"demo: card vs CPU (float32 convolutions): specialist features {feature_err:.3g} of "
          f"max |feature| (limit {DEMO_FEATURE_TOL}); picks "
          + ("equal" if pick_margin is None else f"differ (closest decision {pick_margin:.3g} "
             "from a tie)")
          + f"; class maps equal but at {int(differ.sum())} pixels within {DEMO_GAP} of a tie "
          f"({int(near_tie.sum())} such pixels)")
    print("demo: ms on the card (TF32 convolutions, median of "
          f"{DEMO_RUNS} after a warm-up, host arrays in, class maps out): "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + "; no hand kernel launched by the demo")
    return {"launches": launches, "times_ms": times, "feature_err": feature_err,
            "picks_equal": pick_margin is None, "checked": checked}


# ---------------------------------------------------------------------------
# FUGC K-fold phase: fugc2025_train_torch, then fugc2025_predict_torch
# ---------------------------------------------------------------------------


def fugc_phase(torch, device, workdir: Path):
    import dataclasses

    import numpy as np
    from PIL import Image

    from mia_tpu_torch.entry.fugc2025.predict import model as PredictModel
    from mia_tpu_torch.entry.fugc2025.predict import predict_entry
    from mia_tpu_torch.entry.fugc2025.train import train_entry
    from mia_tpu_torch.models import LegacyUNet, LegacyUNetConfig, UNet, UnetProcessor
    from mia_tpu_torch.training import UNetTrainer

    data = workdir / "fugc"
    if not data.is_dir():
        write_fugc(data)
    counts = {k: fn for k, fn in counters().items() if k in ("K1", "K10", "K10b")}
    # the entry's defaults (batch 32, adam, L2 0.1) at 256²; cut: 2 folds of 8 iterations
    # on the synthetic set (48 train PNGs: 39 train / 9 held out a fold, one batch an epoch)
    folds, epochs, batch = 2, 8, 32
    argv = ["--work-dir", str(workdir / "kfold"), "--data-dir", str(data), "--device", "cuda",
            "--num-folds", str(folds), "--num-epochs", str(epochs), "--batch-size", str(batch),
            "--image-size", "256", "--valid-freq-iter", "4", "--weight-decay", "0.1"]

    steps, losses, denoised = [], [], []
    orig_init, orig_step = UNetTrainer.__init__, UNetTrainer.train_step
    orig_record, orig_denoise = UNetTrainer._record_train_loss, UnetProcessor.denoise_one_mask

    def quiet_init(self, **kwargs):
        orig_init(self, **{**kwargs, "verbose": False})

    def timed_step(self, batch_):
        torch.cuda.synchronize()
        before = {k: fn.launches for k, fn in counts.items()}
        t0 = time.perf_counter()
        orig_step(self, batch_)
        torch.cuda.synchronize()
        steps.append((type(self).__name__, self._fold_index, time.perf_counter() - t0,
                      {k: fn.launches - before[k] for k, fn in counts.items()}))

    def record(self, step_index, lr, loss):
        losses.append((type(self).__name__, self._fold_index, loss))
        return orig_record(self, step_index, lr, loss)

    def watched_denoise(self, mask):
        denoised.append(tuple(mask.shape))
        return orig_denoise(self, mask)

    class KernelDecoderTrainer(UNetTrainer):
        """The same trainer with the decoder's upsampling on K10/K10b."""

        def _unet_config(self):
            return dataclasses.replace(super()._unet_config(), einsum_upsample=True)

        def _build_model(self, round_key=0):
            super()._build_model(round_key)
            check(set_upsample_kernel(self.model, "always") == 4, "the decoder has not 4 upsamplings")

    UNetTrainer.__init__, UNetTrainer.train_step = quiet_init, timed_step
    UNetTrainer._record_train_loss, UnetProcessor.denoise_one_mask = record, watched_denoise
    try:
        for fn in counts.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer = train_entry(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        check(not denoised, "the entry's run denoised its predictions")
        # the kernel decoder: one fold of 4 iterations, --postprocess-mask on its validations
        config = {**{k: getattr(trainer.config, k) for k in (
            "seed", "dataset", "data_path", "in_channels", "num_classes", "image_size", "batch_size",
            "valid_mode", "do_augment", "do_normalize", "do_oversample", "optimizer_name",
            "optimizer_kwargs", "start_lr", "lr_warmup_iter")},
            "active_learning": False, "valid_freq_iter": 2, "postprocess_mask": True}
        kernel_trainer = KernelDecoderTrainer(
            work_path=workdir / "kfold_k10", device="cuda", config=config, num_folds=folds, fold=0,
            valid_rate=0.2, num_epochs=4)
        kernel_trainer.initialize()
        t0 = time.perf_counter()
        kernel_trainer.run_training()
        torch.cuda.synchronize()
        kernel_s = time.perf_counter() - t0
        launches = {k: fn.launches for k, fn in counts.items()}
    finally:
        UNetTrainer.__init__, UNetTrainer.train_step = orig_init, orig_step
        UNetTrainer._record_train_loss, UnetProcessor.denoise_one_mask = orig_record, orig_denoise

    # --- the entry's run --------------------------------------------------------
    work = trainer.work_path
    check(trainer.model.encoder.levels[4][1].all[0].weight.shape[0] == 512
          and all(p.device.type == "cuda" for p in trainer.model.parameters()),
          "the fold's UNet is not at full width on CUDA")
    opt = trainer.state.optimizer
    check(opt.weight_decay == 0.1 and not opt.decoupled and trainer.config.batch_size == batch,
          "not adam with L2 decay 0.1 at the entry's batch size")
    entry_steps = [s for s in steps if s[0] == "UNetTrainer"]
    check([s[1] for s in entry_steps] == [f for f in range(folds) for _ in range(epochs)],
          f"train steps by fold: {[s[1] for s in entry_steps]}")
    check(all(s[3] == {"K1": 1, "K10": 0, "K10b": 0} for s in entry_steps),
          f"launches of the entry's train steps: {[s[3] for s in entry_steps]}")
    splits = trainer._get_split_dicts(trainer.get_dataset("train").case_names())
    for f in range(folds):
        base = work / f"fold_{f}"
        for rel in ("model.msgpack", "round_0/best_model/model.msgpack",
                    "round_0/final_model/model.msgpack", "round_0/data_list.json",
                    "test_mean_round_0.csv"):
            check((base / rel).is_file(), f"missing fold_{f}/{rel}")
        check((base / "model.msgpack").read_bytes()
              == (base / "round_0/best_model/model.msgpack").read_bytes(),
              f"fold_{f}/model.msgpack is not the fold's best checkpoint")
        labeled = set(json.loads((base / "round_0/data_list.json").read_text())["labeled_image_idx"])
        check(labeled == set(splits[f]["train"]) and not labeled & set(splits[f]["valid"])
              and len(splits[f]["valid"]) == 9 and len(labeled) == 39,
              f"fold {f}: the labeled set is not the split's train side")
        fold_losses = [v for name, fold, v in losses if name == "UNetTrainer" and fold == f]
        check(len(fold_losses) == epochs and all(math.isfinite(v) for v in fold_losses)
              and fold_losses[-1] < fold_losses[0],
              f"fold {f}: losses not finite and falling: {fold_losses}")
    check(not set(splits[0]["valid"]) & set(splits[1]["valid"]), "the folds hold out the same cases")

    # --- the kernel decoder's run -------------------------------------------------
    kernel_steps = [s for s in steps if s[0] == "KernelDecoderTrainer"]
    check(len(kernel_steps) == 4 and all(s[3] == {"K1": 1, "K10": 4, "K10b": 4} for s in kernel_steps),
          f"launches of the kernel decoder's train steps: {[s[3] for s in kernel_steps]}")
    kernel_losses = [v for name, _, v in losses if name == "KernelDecoderTrainer"]
    check(len(kernel_losses) == 4 and all(math.isfinite(v) for v in kernel_losses),
          f"kernel decoder: losses {kernel_losses}")
    # 2 validations of 9 held-out slices and the real test's 8, one slice a batch
    check(len(denoised) == 2 * 9 + 8 and all(len(shape) == 3 for shape in denoised),
          f"--postprocess-mask denoised {len(denoised)} predictions")
    check((kernel_trainer.work_path / "fold_0/model.msgpack").is_file(),
          "kernel decoder: no fold_0/model.msgpack")

    # one loss and its gradients through the kernel decoder against the default decoder
    # (nn.ConvTranspose2d) from the same weights: in full float32 (the math) and with the
    # run's TF32 convolutions, where the default's upsampling is TF32 and K10 is float32
    kernel_model = kernel_trainer.model.eval()
    default_model = UNet(trainer.model.cfg).to(device, memory_format=torch.channels_last).eval()
    default_model.load_state_dict(kernel_model.state_dict())
    gen = torch.Generator(device=device).manual_seed(8)
    x = torch.rand((batch, 256, 256, 3), generator=gen, device=device)
    y = torch.randint(0, 3, (batch, 256, 256), generator=gen, device=device)

    def loss_and_grads(model):
        loss = kernel_trainer.supervised_loss(model(x), y)[0]
        return loss, torch.autograd.grad(loss, list(model.parameters()))

    errs = {}
    try:
        for mode, tf32, loss_tol, grad_tol in (("float32", False, 1e-5, 1e-4),
                                               ("TF32 convs", True, 1e-3, 2e-2)):
            torch.backends.cudnn.allow_tf32 = tf32
            for fn in counts.values():
                fn.launches = 0
            (want_loss, want), (loss, got) = loss_and_grads(default_model), loss_and_grads(kernel_model)
            torch.cuda.synchronize()
            check(counts["K10"].launches == 4 and counts["K10b"].launches == 4,
                  "the kernel decoder's loss and backward did not launch K10 and K10b 4 times each")
            scale = max(g.abs().max().item() for g in want)
            loss_err = abs(loss.item() - want_loss.item()) / abs(want_loss.item())
            grad_err = max((a - b).abs().max().item() for a, b in zip(got, want)) / scale
            check(loss_err <= loss_tol and grad_err <= grad_tol,
                  f"kernel decoder vs default ({mode}): loss differs by {loss_err} (limit {loss_tol}), "
                  f"gradients by {grad_err} of max |grad| (limit {grad_tol})")
            errs[mode] = (loss_err, grad_err)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    base_a = median_s(lambda: loss_and_grads(default_model), torch, n=5) * 1e3
    ms_a = median_s(lambda: loss_and_grads(kernel_model), torch, n=5) * 1e3
    ms_b = median_s(lambda: loss_and_grads(kernel_model), torch, n=5) * 1e3
    base_b = median_s(lambda: loss_and_grads(default_model), torch, n=5) * 1e3

    step_ms = statistics.median(s[2] for s in entry_steps[3:]) * 1e3
    fold_losses = [[round(v, 4) for name, fold, v in losses if name == "UNetTrainer" and fold == f]
                   for f in range(folds)]
    print(f"fugc: fugc2025_train_torch, UNet 32..512 at 256^2, batch {batch}, adam + L2 0.1, "
          f"{folds} folds x {epochs} iterations (39 train / 9 held out of 48): losses first/last "
          f"{[(l[0], l[-1]) for l in fold_losses]}; train step median {step_ms:.2f} ms "
          f"({batch / step_ms * 1e3:.1f} img/s) after 3 warm-up steps; total {total_s:.1f} s")
    print(f"fugc: decoder on K10/K10b (einsum_upsample, use_kernel=always), --postprocess-mask: "
          f"4 iterations, launches a step {kernel_steps[0][3]}, losses "
          f"{[round(v, 4) for v in kernel_losses]}, {len(denoised)} predictions denoised; "
          f"total {kernel_s:.1f} s")
    print("fugc: kernel decoder vs default decoder, same weights, batch 32: "
          + "; ".join(f"{m}: loss {a:.3g} relative, gradients {b:.3g} of max |grad|"
                      for m, (a, b) in errs.items())
          + f"; loss + backward {ms_a:.2f} / {ms_b:.2f} ms, default {base_a:.2f} / {base_b:.2f} ms "
          "(medians of 5, in turns)")

    # --- fugc2025_predict_torch: two seeded full-width LegacyUNet folds -----------------
    legacy = workdir / "legacy_folds"
    frames = sorted((data / "test" / "images").glob("*.png"))[:3]
    first = torch.from_numpy(np.array(Image.open(frames[0]).convert("RGB"))).float()[None] / 255.0
    for fold in range(2):
        torch.manual_seed(100 + fold)
        net = LegacyUNet(LegacyUNetConfig(n_channels=3, n_classes=3)).eval()
        sd = net.state_dict()
        for k in sd:  # running statistics with some signal
            if k.endswith("running_mean"):
                sd[k] = 0.1 * torch.randn(sd[k].shape)
            elif k.endswith("running_var"):
                sd[k] = 0.5 + torch.rand(sd[k].shape)
        # random weights give one class everywhere: centre the head's logits on the first
        # frame, so that the classes follow the image and the denoise has regions to clean
        net.load_state_dict(sd)
        with torch.inference_mode():
            sd["outc.conv.bias"] = -net.to(device)(first.to(device)).mean((0, 1, 2)).cpu()
        sd = {k: v.cpu() for k, v in sd.items()}
        (legacy / f"fold_{fold}").mkdir(parents=True)
        # the legacy file, with and without the "model" key
        torch.save({"model": sd} if fold == 0 else sd, legacy / f"fold_{fold}/checkpoint_best.pth")
    (workdir / "frames").mkdir()
    for f in frames:
        shutil.copy(f, workdir / "frames" / f.name)
    t0 = time.perf_counter()
    ensemble = predict_entry(["--work-dir", str(legacy), "--device", "cuda",
                              "--images", str(workdir / "frames"), "--run-model", "--folds", "0", "1",
                              "--output-dir", str(workdir / "preds"),
                              "--visualize-dir", str(workdir / "vis")])
    entry_s = time.perf_counter() - t0
    check(len(ensemble.nets) == 2 and ensemble.nets[0].down4.maxpool_conv[1].double_conv[3]
          .weight.shape[0] == 1024 and all(p.device.type == "cuda" for n in ensemble.nets
                                           for p in n.parameters()) and ensemble.image_size is None,
          "not two full-width LegacyUNet folds on CUDA at the frame's own size")
    seen = set()
    for f in frames:
        pred = np.array(Image.open(workdir / "preds" / f.name))
        check(pred.shape == (336, 544) and set(np.unique(pred)) <= {0, 1, 2},
              f"{f.name}: class map {pred.shape} with values {np.unique(pred)}")
        check(np.array(Image.open(workdir / "vis" / f.name)).shape == (336, 544, 3),
              f"{f.name}: no overlay")
        seen |= set(np.unique(pred).tolist())
    check(len(seen) >= 2, f"the class maps hold one class only: {seen}")
    frame = np.array(Image.open(frames[0]).convert("RGB")).transpose(2, 0, 1)
    cpu_ensemble = PredictModel(None, folds=(0, 1), device="cpu").load(legacy)
    t0 = time.perf_counter()
    want = cpu_ensemble.predict(frame)
    cpu_s = time.perf_counter() - t0
    differing = {}
    try:
        # a flipped argmax moves its neighbourhood through the morphology: fractions, not bits
        for mode, tf32, limit in (("float32", False, 1e-3), ("TF32 convs", True, 1e-2)):
            torch.backends.cudnn.allow_tf32 = tf32
            differing[mode] = float((ensemble.predict(frame) != want).mean())
            check(differing[mode] <= limit, f"model.predict card vs CPU ({mode}): "
                  f"{differing[mode]} of the pixels differ (limit {limit})")
    finally:
        torch.backends.cudnn.allow_tf32 = True
    predict_s = median_s(lambda: ensemble.predict(frame), torch, n=10)
    print(f"fugc: fugc2025_predict_torch, 2 LegacyUNet 64..1024 folds (checkpoint_best.pth), "
          f"{len(frames)} frames of 544x336 at their own size: classes seen {sorted(seen)}; "
          f"model.predict median {predict_s * 1e3:.2f} ms a frame; the entry (load, 3 frames, "
          f"overlays) {entry_s:.1f} s")
    print("fugc: model.predict card vs CPU, fraction of differing pixels: "
          + "; ".join(f"{m}: {v:.3g}" for m, v in differing.items()) + f" (CPU side {cpu_s:.1f} s)")
    return {"launches": launches, "train_step_ms": step_ms, "predict_ms": predict_s * 1e3,
            "k10_decoder_step_ms": min(ms_a, ms_b), "default_decoder_step_ms": min(base_a, base_b),
            "card_vs_cpu_differing": differing, "log": trainer.log_path}


# ---------------------------------------------------------------------------
# K2, K3, K4 against their plain versions
# ---------------------------------------------------------------------------


def plain_lse(torch, qkv, rel_h, rel_w, scale, k_hw, heads):
    """The per-row log-sum-exp (B·H, N) of the packed rel-pos attention."""
    b, n, _ = qkv.shape
    q, k, _ = qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    bias = rel_h.reshape(b, heads, n, k_hw[0], 1) + rel_w.reshape(b, heads, n, 1, k_hw[1])
    return torch.logsumexp((q * scale) @ k.transpose(-2, -1) + bias.reshape(b, heads, n, n),
                           -1).reshape(b * heads, n)


def window_lse(torch, qkv, rel_h, rel_w, bias_kv, scale, ws, heads):
    """K8's log-sum-exp of every real query by token, (B·H, Hg·Wg), from the
    plain one of the partitioned windows."""
    from mia_tpu_torch.ops import attention

    b, hg, wg, _ = qkv.shape
    lse = plain_lse(torch, *attention.partition_rel_win(qkv, rel_h, rel_w, bias_kv, ws, heads),
                    scale, (ws, ws), heads)
    hp, wp = -(-hg // ws) * ws, -(-wg // ws) * ws
    return (lse.reshape(b, hp // ws, wp // ws, heads, ws, ws).permute(0, 3, 1, 4, 2, 5)
            .reshape(b, heads, hp, wp)[:, :, :hg, :wg].reshape(b * heads, hg * wg))


def sam_kernel_phase(torch, device):
    from mia_tpu_torch.ops import attention, ln_window

    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def randn(*shape, scale=1.0, shift=0.0):
        return scale * torch.randn(shape, generator=gen, device=device) + shift

    heads, d, ws, c = 12, 64, 14, 768
    scale = d ** -0.5
    worst = {k: [0.0, 0.0] for k in ("K2", "K3", "K4")}  # max abs err, max relative err
    worst_lse = {"K2": 0.0, "K3": 0.0}

    hold = forward_holder(torch, worst)

    def hold_attention(name, label, args):
        """K2 or K3 against its plain version, its log-sum-exp against the
        plain one, and a second launch bit-identical to the first."""
        launch, plain = ((attention._launch_k2, attention.attention_rel_packed_ik) if name == "K2"
                         else (attention._launch_k3, attention.attention_rel_packed))
        out, lse = launch(*args, with_lse=True)
        hold(name, label, out, plain(*args))
        qkv, rel_a, rel_b, sc, k_hw, n_heads = args
        rel_h, rel_w = (attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, n_heads)
                        if name == "K2" else (rel_a, rel_b))
        err = (lse - plain_lse(torch, qkv, rel_h, rel_w, sc, k_hw, n_heads)).abs().max().item()
        check(err <= LSE_TOL, f"{name} {label}: log-sum-exp off by {err} > {LSE_TOL}")
        worst_lse[name] = max(worst_lse[name], err)
        again, lse_again = launch(*args, with_lse=True)
        torch.cuda.synchronize()
        check(torch.equal(out, again) and torch.equal(lse, lse_again),
              f"{name} {label}: two launches differ")

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
        hold_attention("K2", label, (qkv, rh, rw, scale, (ws, ws), heads))
        inputs[("K4", label)] = (x, ln_scale, ln_bias, ws, 1e-6)
        inputs[("K2", label)] = (qkv, rh, rw, scale, (ws, ws), heads)
    for label, b, k_hw in (("B=1", 1, (32, 32)), ("B=8", 8, (32, 32)),
                           ("4096 tokens", 1, (64, 64)), ("grid 20x27", 2, (20, 27))):
        n = k_hw[0] * k_hw[1]
        qkv = randn(b, n, 3 * heads * d)
        rel_h, rel_w = randn(b * heads, n, k_hw[0]), randn(b * heads, n, k_hw[1])
        args = (qkv, rel_h, rel_w, scale, k_hw, heads)
        hold_attention("K3", label, args)
        inputs[("K3", label)] = args
    # the head-dim-80 instances of the template (ViT-H at 512²: 16 heads)
    h_heads, h_d = 16, 80
    qkv = randn(9, ws * ws, 3 * h_heads * h_d)
    rh80, rw80 = randn(ws * ws, h_d, scale=0.1), randn(ws * ws, h_d, scale=0.1)
    hold_attention("K2", "head dim 80", (qkv, rh80, rw80, h_d ** -0.5, (ws, ws), h_heads))
    qkv = randn(1, 1024, 3 * h_heads * h_d)
    hold_attention("K3", "head dim 80", (qkv, randn(h_heads, 1024, 32), randn(h_heads, 1024, 32),
                                         h_d ** -0.5, (32, 32), h_heads))
    print("K2 and K3 at head dim 80 (16 heads; 9 windows of 196 tokens, 1024 global tokens) "
          f"within {KERNEL_TOL} of max |plain|")
    print(f"K2 and K3 log-sum-exp within {worst_lse['K2']:.3g} / {worst_lse['K3']:.3g} of the "
          f"plain one (limit {LSE_TOL}), two launches bit-identical on every case")

    def bound_and_library(name, label):
        """The bound of the launch and, for K2 and K3, the library call on the
        same operands (the dense bias is built outside the timed call) and
        the 3xTF32 tensor-core bound."""
        args = inputs[(name, label)]
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
        per_block = 50 if label == "B=1" else 10
        lib = sdpa_ms(torch, *head_major(qkv, n_heads), dense_bias(rel_h, rel_w, b, n_heads), sc,
                      per_block)
        moved = [qkv, rel_a, rel_b, out]
        return {"library_ms": lib, **bound(moved, flops), "tc_bound_ms": tc_bound_ms(moved, flops)}

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
            m = {"ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
                 **bound_and_library(name, label)}
            tc = (f", 3xTF32 tensor-core bound {m['tc_bound_ms'] * 1e3:.2f} us"
                  if "tc_bound_ms" in m else "")
            print(f"{name} at ViT-B/512 {label}: {describe_yardsticks(m)}{tc}")
            if label == "B=1":
                if name == "K4":
                    m = with_device_ms(torch, f"{name} at ViT-B/512 {label}",
                                       lambda: kernel(*args), "ln_window_partition_kernel", m)
                out[name] = {"max_abs_err": worst[name][0], **m}
            elif name != "K4":  # the forward attention kernels also report batch 8
                out[name]["b8"] = m
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


def cc_sweeps(torch, morphology, masks, max_iters=16):
    """The sweeps K5 runs on each mask of ``masks``: the first sweep whose
    labels equal those before it (the plain version's), or ``max_iters``."""
    labels = [morphology.connected_components(masks, max_iters=k) for k in range(max_iters + 1)]
    n = masks.shape[0]
    sweeps = torch.full((n,), max_iters, dtype=torch.int64, device=masks.device)
    for k in range(max_iters, 0, -1):
        same = (labels[k] == labels[k - 1]).reshape(n, -1).all(1)
        sweeps = torch.where(same, k, sweeps)
    return sweeps


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
            k2b_args = (qkv, rh, rw, out, g, lse, scale, (ws, ws), heads, tables)
            got = attention._launch_k2_bwd(*k2b_args)
            hold("K2b", f"{label} tables={tables}", got,
                 attention.attention_rel_packed_ik_bwd(qkv, rh, rw, out, g, scale, (ws, ws), heads,
                                                       tables))
            bit_identical(torch, "K2b", f"{label} tables={tables}", got,
                          attention._launch_k2_bwd(*k2b_args))
        timed[("K2b", label)] = ((qkv, rh, rw, out, g, lse, scale, (ws, ws), heads, False),
                                 (qkv, rh, rw, out, g, scale, (ws, ws), heads, False))

        qkv = randn(b, side * side, 3 * heads * d)
        rel_h, rel_w = randn(b * heads, side * side, side), randn(b * heads, side * side, side)
        out, lse = attention._launch_k3(qkv, rel_h, rel_w, scale, (side, side), heads, with_lse=True)
        g = randn(b, side * side, heads * d)
        kernel_args = (qkv, rel_h, rel_w, out, g, lse, scale, (side, side), heads)
        plain_args = (qkv, rel_h, rel_w, out, g, scale, (side, side), heads)
        got = attention._launch_k3_bwd(*kernel_args)
        hold("K3b", label, got, attention.attention_rel_packed_bwd(*plain_args))
        bit_identical(torch, "K3b", label, got, attention._launch_k3_bwd(*kernel_args))
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
        bit_identical(torch, "K5", label, (got,), (morphology._launch_k5(masks),))
        unconverged = not torch.equal(want, morphology.connected_components(masks, max_iters=64))
        print(f"K5 bit-exact vs plain on {label}, two launches bit-identical; 16 sweeps leave "
              f"some mask unconverged: {unconverged}")
    k5_sweeps = cc_sweeps(torch, morphology, k5_cases["(144, 64, 64)"])
    print(f"K5 at (144, 64, 64): sweeps a mask runs before its early stop (the plain version's "
          f"first sweep that changes nothing, at most 16): most {int(k5_sweeps.max())}, "
          f"fewest {int(k5_sweeps.min())}, {int(k5_sweeps.sum())} in all")

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
        # the 3xTF32 kernels' own bound: the same operations on the tensor cores
        return {"library_ms": lib, **bound(moved, flops), "tc_bound_ms": tc_bound_ms(moved, flops)}

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
                if name == "K4b":  # a short kernel: its event time includes the dispatch
                    out[name] = with_device_ms(torch, "K4b at ViT-B/512 training B=12",
                                               lambda: kernel(*k_args),
                                               "ln_window_partition_bwd_kernel", out[name], 10)
                tc = (f", 3xTF32 tensor-core bound {out[name]['tc_bound_ms'] * 1e3:.2f} us"
                      if "tc_bound_ms" in out[name] else "")
                print(f"{name} at ViT-B/512 training B=12: {describe_yardsticks(out[name])}{tc}")
        print(f"{name} within {BWD_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})")
    masks = k5_cases["(144, 64, 64)"]
    (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: morphology._launch_k5(masks),
                                              lambda: morphology.connected_components(masks), 10,
                                              plain_per_block=2)
    print(f"K5 at (144, 64, 64): kernel {k_a * 1e3:.2f} / {k_b * 1e3:.2f} us (median of 11 x 10 "
          f"launches), plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us (median of 11 x 2 calls)")
    # the sweeps each mask runs, of four directional scans and a diagonal min: ~8
    # integer operations a pixel and sweep, counted at the CUDA cores' float32 rate; no
    # PyTorch call labels connected components
    pixels = masks[0].numel()
    out["K5"] = with_device_ms(torch, "K5 at (144, 64, 64)", lambda: morphology._launch_k5(masks),
                               "connected_components_kernel", {
        "max_abs_err": 0.0, "ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
        "library_ms": None, "sweeps_max": int(k5_sweeps.max()),
        **bound([masks, masks], 8 * pixels * int(k5_sweeps.sum()))}, per_block=10)
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
    # heads of 196 tokens; 12 heads of 1024 global tokens), of 8 images, token
    # counts no tile divides (35 is odd: K7 copies its bias 4 bytes at a
    # time, K6 its 5- and 7-wide rel rows), and the ViT-H head dim; both
    # (3xTF32) two launches bit-identical on every case, K7 also with -inf
    # over the first key tile of every other row (64 keys, the wider of its
    # two tile widths)
    for label, bh, d, k_hw in (("B=1 windows", 108, 64, (14, 14)), ("B=1 global", 12, 64, (32, 32)),
                               ("B=8 windows", 864, 64, (14, 14)), ("B=8 global", 96, 64, (32, 32)),
                               ("N=120 (10x12)", 6, 64, (10, 12)), ("N=35 (5x7)", 4, 64, (5, 7)),
                               ("head dim 80", 144, 80, (14, 14))):
        n = k_hw[0] * k_hw[1]
        q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        args = (q, k, v, randn(bh, n, k_hw[0]), randn(bh, n, k_hw[1]), d ** -0.5, k_hw)
        got = attention.fused_attention_rel(*args)
        hold("K6", label, got, attention.attention_rel(*args))
        bit_identical(torch, "K6", label, (got,), (attention.fused_attention_rel(*args),))
        inputs[("K6", label)] = args
        cases = {label: (q, k, v, randn(bh, n, n), d ** -0.5)}
        if label == "B=1 windows":
            masked = randn(bh, n, n)
            masked[:, ::2, :64] = -math.inf
            cases["-inf over the first key tile of every other row"] = (q, k, v, masked, d ** -0.5)
        for case, args in cases.items():
            got = attention.fused_attention(*args)
            hold("K7", case, got, attention.attention_dense(*args))
            bit_identical(torch, "K7", case, (got,), (attention.fused_attention(*args),))
        inputs[("K7", label)] = cases[label]
    # K8: the unpartitioned qkv grid; 32x32 pads each edge window, 20x27 both
    # ways; (3xTF32) its log-sum-exp by token against the plain one, two launches
    # bit-identical on every case
    k8_lse_err = 0.0
    for label, b, hw, n_heads, d in (("B=1", 1, (32, 32), heads, 64), ("B=8", 8, (32, 32), heads, 64),
                                     ("grid 20x27", 2, (20, 27), heads, 64),
                                     ("head dim 80", 1, (32, 32), 16, 80)):
        args = (randn(b, *hw, 3 * n_heads * d), randn(b * n_heads, *hw, ws),
                randn(b * n_heads, *hw, ws), randn(3, n_heads * d, scale=0.5), d ** -0.5, ws, n_heads)
        got = attention.fused_attention_rel_win(*args)
        hold("K8", label, got, attention.attention_rel_win(*args))
        again, lse = attention._launch_k8(*args, with_lse=True)
        bit_identical(torch, "K8", label, (got,), (again,))
        err = (lse - window_lse(torch, *args)).abs().max().item()
        check(err <= LSE_TOL, f"K8 {label}: log-sum-exp off by {err} > {LSE_TOL}")
        k8_lse_err = max(k8_lse_err, err)
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
            moved = [qkv, rel_h, rel_w, bias_kv, out]
            # K8 runs 3xTF32 on the tensor cores: its own bound beside the float32 one
            return {"library_ms": lib, **bound(moved, flops), "tc_bound_ms": tc_bound_ms(moved, flops)}
        q, k, v = (t[None] for t in args[:3])
        bh, n, d = args[0].shape
        flops = attention_flops(bh, n, n, d)
        if name == "K6":
            bias, sc = dense_bias(args[3], args[4], 1, bh), args[5]
            moved = [*args[:5], args[0]]
        else:
            bias, sc = args[3][None], args[4]
            moved = [*args[:4], args[0]]
        lib = sdpa_ms(torch, q, k, v, bias, sc, per_block)
        # K6 and K7 run 3xTF32 on the tensor cores: their own bound beside the float32 one
        return {"library_ms": lib, **bound(moved, flops), "tc_bound_ms": tc_bound_ms(moved, flops)}

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
                tc = (f", 3xTF32 tensor-core bound {m['tc_bound_ms'] * 1e3:.2f} us"
                      if "tc_bound_ms" in m else "")
                print(f"{name} at ViT-B/512 {label}: {describe_yardsticks(m)}{tc}")
                if label == "B=1 global":  # the same kernel at the global blocks' shape
                    out[name]["global_tokens"] = m
                else:
                    if name in ("K8", "K9"):
                        m = with_device_ms(torch, f"{name} at ViT-B/512 {label}",
                                           lambda: kernel(*args),
                                           "attention_fwd_tc_kernel" if name == "K8"
                                           else "unpartition_add_ln_kernel", m)
                    out[name] = {"max_abs_err": worst[name][0], **m}
            elif name == "K8":  # the forward attention kernels also report batch 8
                out[name]["b8"] = {"ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
                                   **bound_and_library(name, args, per_block)}
        print(f"{name} within {KERNEL_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})"
              + ("; x_new bit-exact" if name == "K9" else "")
              + (f"; log-sum-exp within {k8_lse_err:.3g} of the plain one (limit {LSE_TOL})"
                 if name == "K8" else "")
              + ("; two launches bit-identical on every case" if name in ("K6", "K7", "K8")
                 else ""))
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
    # count no tile divides, and the ViT-H head dim; 3xTF32 on the tensor
    # cores, so also two launches bit-identical
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
        got = attention._launch_k6_bwd(*kernel_args)
        hold("K6b", label, got, attention.attention_rel_bwd(*plain_args))
        bit_identical(torch, "K6b", label, got, attention._launch_k6_bwd(*kernel_args))
        timed[("K6b", label)] = (kernel_args, plain_args)
    # K8b (3xTF32): 32x32 pads each edge window, 32x28 only the bottom ones,
    # 28x32 only the right ones, 20x27 both ways, 28x28 is whole windows
    # (dbias_kv exactly zero); two launches bit-identical on every case
    for label, b, hw, n_heads, d in (("B=12", 12, (side, side), heads, 64),
                                     ("B=6", 6, (side, side), heads, 64),
                                     ("grid 32x28", 2, (32, 28), heads, 64),
                                     ("grid 28x32", 2, (28, 32), heads, 64),
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
        bit_identical(torch, "K8b", label, got, attention._launch_k8_bwd(*kernel_args))
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
            # lse is the forward's by-product; dqkv, drel_h, drel_w and dbias_kv are written;
            # 3xTF32 on the tensor cores: its own bound beside the float32 one
            moved = [qkv, rel_h, rel_w, bias_kv, o, g, qkv, rel_h, rel_w, bias_kv]
            return {"library_ms": lib, **bound(moved, flops),
                    "tc_bound_ms": tc_bound_ms(moved, flops)}
        q, k, v, rel_h, rel_w, o, g, _, sc, _ = args
        bh, n, d = q.shape
        lib = sdpa_backward_ms(torch, q[None], k[None], v[None], dense_bias(rel_h, rel_w, 1, bh), sc,
                               g[None], 5)
        moved = [q, k, v, rel_h, rel_w, o, g, q, k, v, rel_h, rel_w]
        flops = attention_flops(bh, n, n, d, backward=True)
        # K6b runs 3xTF32 on the tensor cores: its own bound beside the float32 one
        return {"library_ms": lib, **bound(moved, flops), "tc_bound_ms": tc_bound_ms(moved, flops)}

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
                tc = (f", 3xTF32 tensor-core bound {m['tc_bound_ms'] * 1e3:.2f} us"
                      if "tc_bound_ms" in m else "")
                print(f"{name} at ViT-B/512 training {label}: {describe_yardsticks(m)}{tc}")
                if label == "B=12 global":  # the same kernel at the global blocks' shape
                    out[name]["global_tokens"] = m
                else:
                    out[name] = {"max_abs_err": worst[name][0], **m}
                if name == "K9b":  # a short kernel: its event time includes the dispatch
                    out[name] = with_device_ms(torch, "K9b at ViT-B/512 training B=12",
                                               lambda: kernel(*k_args),
                                               "unpartition_add_ln_bwd_kernel", out[name], 20)
        print(f"{name} within {BWD_TOL} of max |plain| on every case: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})"
              + ("; pad slots exactly zero" if name == "K9b" else "")
              + ("; two launches bit-identical on every case" if name in ("K6b", "K8b") else ""))
    return out


# ---------------------------------------------------------------------------
# K10 and K10b (k2/s2 transposed convolution) against their plain versions
# ---------------------------------------------------------------------------

# label, (B, H, W, Cin, Cout), timed: the four stages of CPC-SAM's prompt-large
# upscaler at batch 12, the two of the plain SAM upscaler for one prompt (a
# 512² frame gives a 32² embedding), the UNet decoder's four at 256² for batch
# 12 (al_train) and batch 32 (fugc2025_train), and ragged grids on the CUDA-core
# route (the first two) and the tensor-core route (the last two)
UPSAMPLE_STAGES = (
    ("prompt-large 1", (12, 32, 32, 256, 64), True),
    ("prompt-large 2", (12, 64, 64, 64, 32), True),
    ("prompt-large 3", (12, 128, 128, 32, 16), True),
    ("prompt-large 4", (12, 256, 256, 16, 16), True),
    ("SAM 1", (1, 32, 32, 256, 64), True),
    ("SAM 2", (1, 64, 64, 64, 32), True),
    ("UNet 1", (12, 16, 16, 512, 256), True),
    ("UNet 2", (12, 32, 32, 256, 128), True),
    ("UNet 3", (12, 64, 64, 128, 64), True),
    ("UNet 4", (12, 128, 128, 64, 32), True),
    ("UNet 1 B=32", (32, 16, 16, 512, 256), False),
    ("UNet 4 B=32", (32, 128, 128, 64, 32), False),
    ("ragged 5x12", (2, 5, 12, 16, 16), False),
    ("ragged 7x3", (3, 7, 3, 48, 20), False),
    ("ragged 12x13, Cin 520", (1, 12, 13, 520, 20), False),
    ("ragged 21x22", (6, 21, 22, 256, 64), False),
)


def upsample_kernel_phase(torch, device):
    from mia_tpu_torch.ops import upsample2x as up

    gen = torch.Generator(device=device)
    gen.manual_seed(7)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    worst = {"K10": [0.0, 0.0], "K10b": [0.0, 0.0]}
    hold_fwd, hold_bwd = forward_holder(torch, worst), backward_holder(torch, worst)
    conv_t = torch.nn.functional.conv_transpose2d
    stages = {"K10": {}, "K10b": {}}
    for label, (b, h, w, cin, cout), is_timed in UPSAMPLE_STAGES:
        x, wt, bias = randn(b, h, w, cin), randn(2, 2, cin, cout, scale=cin ** -0.5), randn(cout)
        dy = randn(b, 2 * h, 2 * w, cout)
        got = up.conv_transpose2x(x, wt, bias)
        want = up.conv_transpose2x_plain(x, wt, bias)
        hold_fwd("K10", label, got, want)
        first = up._launch_k10_bwd(x, wt, dy)
        hold_bwd("K10b", label, first, up.conv_transpose2x_bwd_plain(x, wt, dy))
        again = up._launch_k10_bwd(x, wt, dy)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(first, again)),
              f"K10b {label}: two launches are not bit-identical")
        only_dx = up._launch_k10_bwd(x, wt, dy, need_dw=False)
        check(only_dx[1] is None and only_dx[2] is None and torch.equal(only_dx[0], first[0]),
              f"K10b {label}: dx alone differs")
        # the library call on NCHW channels-last views of the same operands
        x_l = x.permute(0, 3, 1, 2).detach().requires_grad_()
        w_l = wt.permute(2, 3, 0, 1).contiguous().requires_grad_()
        b_l = bias.detach().clone().requires_grad_()
        lib_out = conv_t(x_l, w_l, b_l, stride=2)
        lib_err = (lib_out.permute(0, 2, 3, 1) - want).abs().max().item() / want.abs().max().item()
        check(lib_err <= 2e-3, f"K10 {label}: the library call differs from the plain version by "
              f"{lib_err} (TF32 convolution)")
        routes = up.k10_routes((b, h, w, cin), cout)
        if not is_timed:
            continue
        pixels = b * h * w
        per_block = 20 if pixels * cout < 2 ** 22 else 5
        fwd_flops = 2 * pixels * cin * 4 * cout
        g_l = dy.permute(0, 3, 1, 2)
        for name, kernel, plain, library, moved, flops, route in (
            ("K10", lambda: up._launch_k10(x, wt, bias),
             lambda: up.conv_transpose2x_plain(x, wt, bias),
             lambda: conv_t(x_l, w_l, b_l, stride=2), [x, wt, bias, got], fwd_flops,
             routes["forward"]),
            ("K10b", lambda: up._launch_k10_bwd(x, wt, dy),
             lambda: up.conv_transpose2x_bwd_plain(x, wt, dy),
             lambda: torch.autograd.grad(lib_out, [x_l, w_l, b_l], g_l, retain_graph=True),
             # dx and dw are a product of the forward's size each; db adds every cotangent
             [x, wt, dy, x, wt, bias], 2 * fwd_flops + dy.numel(),
             "/".join(sorted({routes["dx"], routes["dw"]}))),
        ):
            (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, kernel, plain, per_block)
            # the library call with TF32 convolutions (the port's setting), then in full
            # float32 (like for like with the kernel's float32 accuracy)
            lib, tf32_before = {}, torch.backends.cudnn.allow_tf32
            for tf32 in (True, False):
                torch.backends.cudnn.allow_tf32 = tf32
                try:
                    if name == "K10b":
                        lib_out = conv_t(x_l, w_l, b_l, stride=2)
                    with torch.no_grad() if name == "K10" else contextlib.nullcontext():
                        lib[tf32] = time_ms(library, torch, per_block=per_block)
                finally:
                    torch.backends.cudnn.allow_tf32 = tf32_before
            m = {"shape": [b, h, w, cin, cout], "path": route, "ms": min(k_a, k_b),
                 "plain_ms": min(plain_a, plain_b), "library_ms": lib[True],
                 "library_fp32_ms": lib[False], **bound(moved, flops),
                 "tc_bound_ms": tc_bound_ms(moved, flops)}
            stages[name][label] = m
            print(f"{name} at {label} (B={b}, {h}x{w}, {cin}->{cout}) on the {route}: kernel "
                  f"{k_a * 1e3:.2f} / {k_b * 1e3:.2f} us, plain {plain_a * 1e3:.2f} / "
                  f"{plain_b * 1e3:.2f} us (median of 11 x {per_block} launches); "
                  f"{describe_yardsticks(m)} (TF32), {lib[False] * 1e3:.2f} us (float32); "
                  f"3xTF32 bound {m['tc_bound_ms'] * 1e3:.2f} us")
    out = {}
    for name, tol in (("K10", KERNEL_TOL), ("K10b", BWD_TOL)):
        # the line's entry is the prompt-large chain's slowest stage; every timed stage beside it
        slowest = max((m for label, m in stages[name].items() if label.startswith("prompt-large")),
                      key=lambda m: m["ms"])
        out[name] = {"max_abs_err": worst[name][0], **slowest, "stages": stages[name]}
        print(f"{name} within {tol} of max |plain| on {len(UPSAMPLE_STAGES)} shapes: max |diff| "
              f"{worst[name][0]:.3g} (relative {worst[name][1]:.3g})"
              + ("; two launches bit-identical" if name == "K10b" else ""))
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
    # the default TF32 convolutions against full float32 ones on the card, same input
    fp32_scale = emb_fp32.abs().max().item()
    tf32_dev = (emb_tf32 - emb_fp32).abs().max().item()

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
    print(f"sam: set_image embedding with the default TF32 convolutions against float32 ones "
          f"(cudnn.allow_tf32 = False), same input on the card: max |diff| {tf32_dev:.3g}, "
          f"relative to max |emb| {tf32_dev / fp32_scale:.3g}")
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


def set_upsample_kernel(module, use_kernel):
    """Set ``use_kernel`` on every 2D ``EinsumConvTranspose2x`` under ``module``
    (``"always"``: K10 and K10b; ``"never"``: the plain GEMM) → their number."""
    from mia_tpu_torch.models import EinsumConvTranspose2x

    stages = [m for m in module.modules()
              if isinstance(m, EinsumConvTranspose2x) and m.dimension == 2]
    for m in stages:
        m.use_kernel = use_kernel
    return len(stages)


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
# K10 under SAM serving: the mask decoder's upscaler on the kernel
# ---------------------------------------------------------------------------


def upscaler_serving_phase(torch, device, model):
    import numpy as np

    from mia_tpu_torch.models.sam import SamPredictor

    image = sam_frame(np)
    point, label = np.array([[352.0, 216.0]]), np.array([1])
    coords16 = np.random.default_rng(5).uniform([0, 0], [640, 480], (16, 1, 2))
    labels16 = np.ones((16, 1), np.int64)
    counts = counters()
    predictor = SamPredictor(model)
    predictor.set_image(image)
    calls = {"predict": lambda **k: predictor.predict(point_coords=point, point_labels=label, **k),
             "predict_batch": lambda **k: predictor.predict_batch(coords16, labels16, **k)}
    want = {name: call(return_logits=True) for name, call in calls.items()}
    check(set_upsample_kernel(model.mask_decoder, "always") == 2, "the plain SAM upscaler has not 2 stages")
    launches = {k: 0 for k in counts}
    try:
        worst = 0.0
        for name, call in calls.items():
            for fn in counts.values():
                fn.launches = 0
            got = call(return_logits=True)
            torch.cuda.synchronize()
            seen = {k: fn.launches for k, fn in counts.items() if fn.launches}
            check(seen == {"K10": 2}, f"{name} with the upscaler on K10 launched {seen}, expected 2 K10")
            launches["K10"] += seen.get("K10", 0)
            ref = max(1.0, float(np.abs(want[name][0]).max()))
            err = float(np.abs(got[0] - want[name][0]).max()) / ref
            check(got[0].shape == want[name][0].shape and err <= 1e-4,
                  f"{name}: mask logits with K10 differ from the default's by {err} of max |logit|")
            check(np.allclose(got[1], want[name][1], rtol=0, atol=1e-6),
                  f"{name}: iou changed with the upscaler's route")
            confident = np.abs(want[name][0]) > 2e-4 * ref
            check(np.array_equal((got[0] > model.mask_threshold)[confident],
                                 (want[name][0] > model.mask_threshold)[confident]),
                  f"{name}: mask bits differ away from the threshold")
            worst = max(worst, err)
        k10_a = median_s(calls["predict"], torch, n=20) * 1e3
        set_upsample_kernel(model.mask_decoder, "never")
        base_a = median_s(calls["predict"], torch, n=20) * 1e3
        base_b = median_s(calls["predict"], torch, n=20) * 1e3
        set_upsample_kernel(model.mask_decoder, "always")
        k10_b = median_s(calls["predict"], torch, n=20) * 1e3
    finally:
        set_upsample_kernel(model.mask_decoder, "never")
    print(f"sam: upscaler on K10: 2 launches a decode (predict, predict_batch of 16); mask logits "
          f"within {worst:.3g} of max |logit| of the default's; predict (1 point) median "
          f"{k10_a:.2f} / {k10_b:.2f} ms, default {base_a:.2f} / {base_b:.2f} ms (in turns)")
    return {"launches": launches, "predict_ms": min(k10_a, k10_b), "default_predict_ms": min(base_a, base_b)}


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
    _expected.update({k: 0 for k in ("K6", "K6b", "K7", "K8", "K8b", "K9", "K9b", "K10", "K10b")})


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
    for rel in ("best_model/lora.msgpack", "final_model/lora.msgpack", "test_mean.csv"):
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
    for rel in ("lora.msgpack", "training_state.json", "training_state.pth"):
        check((ckpt / rel).is_file(), f"missing final_model/{rel}")
    aux["contrastive"] = rec_a

    # cpcsam_train_torch --lora-ckpt final_model/lora.msgpack: the adapters and every entry
    # outside the frozen encoder as run A held them, bit for bit (a test-only run)
    from mia_tpu_torch.models.sam.lora import lora_state_dict, read_lora_checkpoint

    tr_t, _ = run_cpcsam(torch, device, datasets, common + [
        "--work-path", str(workdir / "work_lora"), "--test-only",
        "--lora-ckpt", str(ckpt / "lora.msgpack")])
    held, on_disk = lora_state_dict(tr_a.model), read_lora_checkpoint(ckpt / "lora.msgpack")
    loaded = lora_state_dict(tr_t.model)
    check(set(loaded) == set(held) == set(on_disk)
          and all(torch.equal(loaded[k], held[k]) and torch.equal(on_disk[k], held[k])
                  for k in held),
          "--lora-ckpt lora.msgpack did not restore run A's LoRA checkpoint bit for bit")
    check(sum("lora_" in k for k in held) == 48, "lora.msgpack does not hold the 48 LoRA tensors")

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
          f"encoder bit-identical in both; --test-only --lora-ckpt lora.msgpack restored its "
          f"{len(held)} entries bit for bit")
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
    # the default encoder, the 12 upscaler stages of the three prompt-large decoders on
    # K10/K10b: phase 1 runs each decoder once, unprompted, on the 6 labeled images
    ("K10 upscalers", dict(), False,
     {"K2": 8, "K2b": 8, "K3": 4, "K3b": 4, "K4": 8, "K4b": 7, "K10": 12, "K10b": 12}),
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
        if "K10" in expect:
            check(set_upsample_kernel(tr.model, "always") == 12,
                  f"{label}: the model does not hold 3 x 4 upscaler stages")
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
                **timed("K6b, K8b, K9b", route_bwd_kernel_phase, torch, device),
                **timed("K10, K10b", upsample_kernel_phase, torch, device)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = timed("AL slice", slice_phase, torch, Path(tmp))
        sel = timed("AL selectors", selector_phase, torch, device, Path(tmp), sl)
        demo = timed("demo and checkpoints", demo_phase, torch, device, Path(tmp), sl)
        del sl["trainer"], sl["saved"]
        fugc = timed("FUGC K-fold", fugc_phase, torch, device, Path(tmp))
        cpc, cpc_trainer, acdc = timed("CPC-SAM", cpcsam_phase, torch, device, Path(tmp))
        route_train = timed("route training", route_train_phase, torch, device, cpc_trainer, acdc)
        del cpc_trainer, acdc
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            shutil.copy(sl["log"], args.out / "chip_smoke_train_log.txt")
            shutil.copy(cpc["log"], args.out / "chip_smoke_cpcsam_log.txt")
            shutil.copy(fugc["log"], args.out / "chip_smoke_fugc_log.txt")
    sam, model, cpu_model = timed("SAM serving", sam_phase, torch, device)
    serving_k10 = timed("K10 serving", upscaler_serving_phase, torch, device, model)
    routes = timed("encoder routes", route_phase, torch, device, model)
    amg = timed("AMG", amg_phase, torch, device, model, cpu_model)
    print(f"seconds by phase: build {build_s:.1f}, {seconds}")
    # each path ran with every count set to 0 just before it: K1 from the
    # AL slice, the selector phase's runs and the demo phase's grayscale run (the demo
    # itself launches none), K2-K4 forward from SAM serving, CPC-SAM training, the encoder
    # routes and AMG, the backward kernels of K2-K4 and K5 from CPC-SAM
    # training, K6-K9 from the encoder routes and, with K6b, K8b and K9b, from
    # route training, K8 from AMG on the grid-native encoder too; K1 also from the FUGC
    # K-fold trainer, K10 and K10b from that trainer with the decoder's option on, from
    # route training (the prompt-large upscalers) and K10 from SAM serving
    launches = {k: sum(path["launches"].get(k, 0)
                       for path in (sam, cpc, route_train, routes, amg, fugc, serving_k10, demo))
                for k in KERNELS}
    launches["K1"] += sl["launches"] + sel["launches"]
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
        check(entry["route"] in ("cuda", "triton"), f"{entry['name']}: route {entry['route']!r}")
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
                        "selectors": {k: v for k, v in sel.items() if k != "launches"},
                        "demo": {k: v for k, v in demo.items() if k != "launches"},
                        "cpcsam": {k: v for k, v in cpc.items() if k not in ("launches", "log")},
                        "route_training": route_train["routes"],
                        "fugc": {k: v for k, v in fugc.items() if k not in ("launches", "log")},
                        "k10_serving": {k: v for k, v in serving_k10.items() if k != "launches"},
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
