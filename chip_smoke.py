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
   bfloat16 kernels: the bfloat16 instances of K2, K3 (bfloat16
   ``mma.sync``) and K4 against their plain bfloat16 versions at the same
   shapes (ViT-B/512 batch 1 and 8, the 20x27 grid, 4096 global tokens, head
   dim 80): K2's and K3's output within 2^-7 of max |plain| and their
   log-sum-exp within 1e-5 of the plain one of the same scores (K2's on its
   own rel terms, which kernel R's bfloat16 instance holds to one ulp and
   99% bit-equal), K4's output within one bfloat16 ulp an element (the ulp
   taken at >= 2^-6 of max) and its mu / rstd within 1e-5, two launches
   bit-identical; timed with the library call (bfloat16 operands and dense
   bias) and the bound at 989 TFLOP/s dense bfloat16. Their backward
   kernels' bfloat16 instances (K2b, K3b on bfloat16 ``mma.sync``, K4b)
   through the wrappers the trainer calls, against the plain bfloat16 VJPs
   at the training shapes for batch 12 (K2b on 108 windows, tables off and
   on; K3b on 12 x 1024 tokens; K4b on (12, 32, 32, 768), parameters off
   and on), a 20x27 grid and head dim 80: every output within 2^-7 of max
   |plain|, two launches bit-identical; event and device times (every
   kernel of a call) with the plain version, autograd through one bfloat16
   ``scaled_dot_product_attention`` with the dense bias and the bfloat16
   bound.
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
   at full width (32..512), batch 12, 256², on ``cuda``: 2 AL rounds of 20
   iterations. Checks parameters on the card, finite losses, the round
   files, the labeled set growing by the budget, K1 launches from the train
   steps, and the trained UNet's logits on the card against the same
   weights on the CPU (in full float32, and with the run's TF32
   convolutions). Prints the loader's host decode path (native or PIL, both
   uint8) and the bytes each train batch shipped, beside the step (median of
   round 1's) and round times that depend on them, and the trainer's trace
   spans (``al/select``, ``train/step``, ``valid/step``: total, count, mean
   host seconds). Round 0's train steps run under ``start_profiler`` /
   ``stop_profiler``: the Chrome trace holds one ``train/step`` range a step,
   each with its K1 launch inside.
   AL bfloat16 phase: ``al_train_torch --compute-dtype bfloat16`` on the
   same FUGC set at full width, 2 rounds of 12 iterations: every
   convolution's output bfloat16 (forward hooks), float32 parameters and
   ``model.msgpack`` files, one K1 launch a step, finite losses; the step
   median beside the slice's float32 one, and the trained UNet's logits in
   bfloat16 against the same weights in float32.
   Warmer phase: the same FUGC set through ``al_train_torch``, 2 rounds of 6
   iterations, 4 runs with ``warm_pool_cache`` off, on, on, off (cuDNN's
   deterministic algorithms): round 1's ``al/select`` seconds, the pool
   samples in the decode cache when its sweep began (all of them with the
   warmer, none without), and the same picks in every run.
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
   (medians of 5 after a warm-up, TF32 convolutions); the demo launches no
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
   ACDC and thyroid phase: ``al_train_torch``'s ``train_entry`` on ``cuda``
   at full width (UNet 32..512, 256², batch 12) on an ACDC set served from
   memory through ``ACDCDataset.read_case`` (64 slices, 4 valid and 4 test
   volumes of 10x216x256, three distinct raw spacings a case): the acdc
   recipe, entropy with budget 8, 2 rounds of 20 iterations, volume-mode
   validation every 10 (the default) and the real test; checks the
   RV/Myo/LV test CSVs, the rolled metric spacing, one valid volume's 16
   metrics on the card against the CPU from the same predictions (DSC/JC
   equal, HD/ASD within 1e-5 relative), the recipe on one batch card
   against CPU from the same draws (equal; near-.5-tie source coordinates
   counted), and times the rounds by part and one volume evaluation. Then
   TN3K (48/8/8 336x448 JPGs) with ``--block-type res --block-normalization
   instance --deep-supervision --ds-layer 3 --optimizer adamw``, 10
   iterations: its checkpoint files equal the trainer's memory bit for bit,
   the deep-supervision heads follow adamw's decay alone, the UNet on the
   card against the CPU within 1e-4 of max |logit| (float32 convolutions),
   its step time beside the slice phase's; TG3K, 4 iterations. The phase
   launches no hand kernel.
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
   CPC-SAM bfloat16 phase: the same defaults with ``--compute-dtype
   bfloat16`` for 2 phase-1 and 2 phase-2 steps on the same set: each step
   launches 8 / 4 / 8 bfloat16 K2 / K3 / K4 and 8 / 4 / 7 bfloat16 K2b /
   K3b / K4b and no float32 instance of them; finite losses, the LoRA
   tensors moved, float32 parameters and a float32 ``lora.msgpack`` in the
   float32 run's layout, a validation and the real test; step times and
   peak memory beside the float32 phase's; encoder blocks 0 (windowed) and
   2 (global) of the trained model on the card against the same block on
   the CPU on the card's inputs (output, input cotangent, LoRA gradients),
   closer than the card's float32 block of the same weights.
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
   SAM bfloat16 phase: ``sam_model_registry["vit_b"](512, 3,
   compute_dtype=torch.bfloat16)`` with the SAM phase's weights serves the
   same frame: 8 / 4 / 8 launches of the bfloat16 K2 / K3 / K4 a
   ``set_image`` and none of the float32 instances, a bfloat16 embedding,
   the predict shapes; the embedding's and one point's mask logits' gap to
   the float32 model; ``set_image`` and ``predict`` of both in turns.
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
   3D UNet, losses and export phase: ``UNet(UNetConfig(dimension=3))`` at
   32..512 (1 channel, 4 classes), batch 2 at 128^3, 3 train steps with
   ``DCAndCELoss`` and Adam (TF32 convolutions), then the residual +
   instance-norm + deep-supervision variant (``ds_layer=3``, heads of the
   logits' shape, weighted 1, 0.5, 0.25) for 2: step ms and peak memory;
   the trained UNet's eval logits on a (1, 64, 64, 64, 1) volume on the card
   against the CPU within 1e-5 of max |logit| (float32 convolutions). Each
   nnU-Net loss and its gradient at (2, 128, 128, 128, 4) logits, card
   against CPU within 1e-5 of max (top-k: gradients of pixels within 1e-5 of
   the k-th value left out, counted). ``export_unet_forward`` of a 2D UNet
   32..512 at (1, 256, 256, 3) and ``export_sam_prompt_program`` of the SAM
   phase's ViT-B/512 with 8 point slots, exported, loaded and run on the
   card: within 1e-5 of max of the live module and of
   ``SamPredictor.decode_on_device`` on the same seeded embedding (float32
   convolutions), with export, load and run times. No hand kernel launched.
7. Prints one JSON line with the 17 kernels (K1-K10, forward, and the
   backward kernels K2b-K4b, K6b, K8b, K9b, K10b, with their launches in the
   paths that ran them, their bounds and library times; K2, K3, K6, K7, K8,
   K2b, K3b, K6b and K8b also their tensor-core bound, K2, K3 and K8 their
   batch-8 numbers under ``b8``, K1, K4, K4b, K5, K8, K9 and K9b their ``device_ms``;
   K2, K3, K4, K2b, K3b and K4b a ``bf16`` entry with the same keys for
   their bfloat16 instance, its launches from the bfloat16 SAM and CPC-SAM
   phases),
   then the result line
   ``{"ok": true, "device": {...}}`` last.

Exits non-zero, printing no result, when there is no CUDA device, when it is
not next to the package it tests, or when any phase fails. ``--out DIR``
also writes the trainers' logs and the JSON lines into DIR.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
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
# kernels with a bfloat16 instance (SAM serving and CPC-SAM training in bfloat16); the JSON
# line gives each a ``bf16`` entry with its own launches, times and bounds
BF16_KERNELS = ("K2", "K3", "K4", "K2b", "K3b", "K4b")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores: what most kernels here compute in
# K2, K3, K6, K7, K8, K2b, K3b, K6b and K8b run 3xTF32 on the tensor cores: the card's dense
# TF32 rate, three MMAs a product
TC_3XTF32_FLOPS_PER_S = 495e12 / 3
KERNEL_TOL = 1e-5  # forward kernels: max |kernel - plain| over max |plain|, float32
LSE_TOL = 1e-5  # K2's, K3's and K8's log-sum-exp against the plain one, absolute (values ~10)
BWD_TOL = 1e-4  # backward kernels, per output (float32; another summation order, p from the lse)
# the bfloat16 instances of K2 and K3 round the unnormalised p where the plain version rounds the
# normalised one: max |kernel - plain| over max |plain|, against out's own bfloat16 step of 2^-8
BF16_TOL = 2.0 ** -7
BF16_TC_FLOPS_PER_S = 989e12  # dense bfloat16 on the tensor cores (K2, K3 in bfloat16)
BF16_ULP_FLOOR = 2.0 ** -6  # K4's output and K2's rel terms: an element's ulp at >= this of the max


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


def device_ms(torch, fn, kernel=None, per_block=50):
    """The device time (ms) of one launch of the device kernel whose name
    holds ``kernel``, from its durations under ``torch.profiler`` over one
    block of ``per_block`` calls of ``fn`` (without the host's dispatch that
    the CUDA-event time of a short kernel includes); and the device time of
    the call's other kernels (the wrapper's conversions) a call. With
    ``kernel`` None: every device kernel of one call, summed, and 0."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a capture now and then comes back without any device event of the
    # block (seen once for K4b, which had passed in every earlier run):
    # such a capture is taken again, at most twice
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(per_block):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e for e in events if kernel is None or kernel in e.key]
        if mine:
            break
        print(f"device_ms: capture {attempt + 1} recorded no {kernel or 'device'} launch "
              f"({len(events)} device events)")
    check(mine, f"the profiler recorded no {kernel or 'device'} launch")
    if kernel is None:
        return sum(e.self_device_time_total for e in mine) / 1e3 / per_block, 0.0
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


SPANS = ("al/select", "train/step", "valid/step")  # the trainer's trace spans
K1_DEVICE_KERNEL = "affine_warp_shift2pass_kernel"


def spans_holding(trace: Path, span: str, kernel: str):
    """The ``span`` ranges of a ``stop_profiler`` Chrome trace and, of those,
    the ones inside which a device kernel whose name holds ``kernel`` was
    launched: its launch (the runtime or driver event of the same
    correlation id) lies in the host range, or, where the trace holds no
    launch event for it, the kernel runs inside the span's device range."""
    events = [e for e in json.loads(trace.read_text())["traceEvents"] if e.get("ph") == "X"]
    host = [e for e in events if e.get("name") == span and e.get("cat") == "user_annotation"]
    gpu = [e for e in events if e.get("name") == span and e.get("cat") == "gpu_user_annotation"]
    kernels = [e for e in events if e.get("cat") == "kernel" and kernel in e.get("name", "")]
    corr = {e["args"]["correlation"] for e in kernels if "correlation" in e.get("args", {})}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and e.get("args", {}).get("correlation") in corr]

    def inside(t, r):
        return r["ts"] <= t <= r["ts"] + r["dur"]

    if launches:
        holding = [r for r in host if any(inside(e["ts"], r) for e in launches)]
    else:
        holding = [r for r in gpu if any(inside(k["ts"], r) for k in kernels)]
    return host, holding, len(kernels), "launch in the host range" if launches else "device range"


def slice_phase(torch, workdir: Path):
    from mia_tpu_torch.data import decode_path
    from mia_tpu_torch.entry.activelearning.train import train_entry
    from mia_tpu_torch.ops import warp
    from mia_tpu_torch.training import ALTrainer
    from mia_tpu_torch.utils import profiling

    data = workdir / "fugc"
    write_fugc(data)
    rounds, budget, iters, batch = 2, 8, 20, 12
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

    trace = {}

    def timed_step(self, batch_):
        # round 0's train steps run under the profiler (the step median is
        # round 1's); the capture stops after its last step
        if self.current_round == 0 and self.current_iter == 0:
            profiling.start_profiler(workdir / "trace")
        torch.cuda.synchronize()
        before = warp.affine_warp_shift2pass_fused.launches
        t0 = time.perf_counter()
        orig_step(self, batch_)
        torch.cuda.synchronize()
        steps.append((self.current_round, time.perf_counter() - t0))
        k1_in_steps.append(warp.affine_warp_shift2pass_fused.launches - before)
        img = batch_["image"]
        wire.add((str(img.dtype).removeprefix("torch."), img.numel() * img.element_size()))
        if self.current_round == 0 and self.current_iter == iters:
            trace["path"] = profiling.stop_profiler()

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
        profiling.reset_phase_times()
        warp.affine_warp_shift2pass_fused.launches = 0
        t0 = time.perf_counter()
        trainer = train_entry(argv)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = warp.affine_warp_shift2pass_fused.launches
        spans = profiling.phase_times()
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

    # the trainer's spans: one train/step a step, one al/select a round
    check(set(spans) == set(SPANS), f"trace spans {sorted(spans)}, expected {SPANS}")
    check(spans["train/step"]["count"] == rounds * iters and spans["al/select"]["count"] == rounds,
          f"span counts {({k: v['count'] for k, v in spans.items()})}")
    # round 0's train steps in the profiler trace, each with its K1 launch
    host, holding, k1_kernels, how = spans_holding(trace["path"], "train/step", K1_DEVICE_KERNEL)
    check(len(host) == iters and len(holding) == iters and k1_kernels == iters,
          f"profiler trace: {len(host)} train/step ranges, {len(holding)} holding a K1 launch "
          f"({how}), {k1_kernels} K1 kernels; expected {iters} each")
    trace_mib = trace["path"].stat().st_size / 2**20

    warm = [s for r, s in steps[iters + 5:]]
    step_ms = statistics.median(warm) * 1e3
    print(f"slice: {rounds} AL rounds x {iters} iters at width 32..512, 256^2, batch {batch}; "
          f"labeled {sizes}; losses first {losses[0]:.4f} last {losses[-1]:.4f}")
    print(f"slice: train step median {step_ms:.2f} ms ({batch / step_ms * 1e3:.1f} img/s) "
          f"over round 1's steps after 5 warm-up steps; round seconds "
          f"{[round(s, 2) for s in round_s]} (round 0 under the profiler); total {total_s:.1f} s")
    print(f"slice: host decode: {decode_path()}; train batches shipped as "
          + ", ".join(f"{d} images of {n / 2**20:.2f} MiB ({n} bytes)" for d, n in sorted(wire)))
    for name in SPANS:
        t = spans[name]
        print(f"slice: span {name}: total {t['total_s']:.4f} s, count {t['count']}, "
              f"mean {t['mean_s'] * 1e3:.3f} ms (host wall time)")
    print(f"slice: profiler trace of round 0's train steps ({trace_mib:.1f} MiB): {len(host)} "
          f"train/step ranges, each holding one K1 launch ({how})")
    print(f"slice: K1 launches {launches} in the run, {sum(k1_in_steps)} from train steps; "
          f"UNet logits card vs CPU max |diff| {fp32_err:.3g} (float32), "
          f"{tf32_err:.3g} (TF32 convs), max |logit| {scale:.3g}")
    return {"launches": launches, "log": work / "log.txt", "host_decode": decode_path(),
            "step_ms": step_ms, "trainer": trainer, "data": data, "work": work, "saved": saved,
            "wire_bytes": sorted(wire), "spans": spans}

# ---------------------------------------------------------------------------
# ACDC and thyroid phase: al_train_torch on ACDC with volume-mode validation
# and test, on TN3K with residual blocks, instance norm and deep supervision,
# and on TG3K
# ---------------------------------------------------------------------------

METRIC_TOL = 1e-5  # HD and ASD, card against CPU on the same predictions, relative


def blob_slices(np, count, hw, seed=0):
    """Seeded cardiac-like slices: three overlapping ellipses (classes 1-3)
    over noise, float32 images in [0, 1] and int32 labels, ``(count, h, w)``."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    labels = np.zeros((count, h, w), np.int32)
    for i in range(count):
        for c in (1, 2, 3):
            cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
            ry, rx = rng.uniform(0.06, 0.16) * h, rng.uniform(0.06, 0.16) * w
            labels[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = c
    images = np.clip(0.15 + 0.2 * labels + rng.normal(0.0, 0.06, labels.shape), 0.0, 1.0)
    return images.astype(np.float32), labels


def acdc_spacing(i):
    """(z, y, x) raw spacing of case ``i``: three distinct values, varying by case."""
    return (10.0 - 0.5 * (i % 4), 1.25 + 0.0625 * (i % 4), 1.5 + 0.09375 * (i % 3))


def write_in_memory_acdc(np, ACDCDataset, root: Path, n_train=64, n_valid=4, n_test=4,
                         depth=10, hw=(216, 256)):
    """ACDC's split lists and ``raw_spacing.csv`` on disk; the cases in memory,
    served through ``ACDCDataset.read_case`` (the GPU machine has no h5py).
    Returns the subclass and the (z, y, x) spacing of each patient frame."""
    train = blob_slices(np, n_train, hw, seed=0)
    vols = blob_slices(np, (n_valid + n_test) * depth, hw, seed=1)
    vols = [a.reshape(n_valid + n_test, depth, *hw) for a in vols]
    slices = [f"patient{i // 4:03d}_frame01_slice_{i % 4}" for i in range(n_train)]
    volumes = [f"patient{100 + i:03d}_frame01" for i in range(n_valid + n_test)]
    cases = {name: (train[0][i], train[1][i]) for i, name in enumerate(slices)}
    cases.update({name: (vols[0][i], vols[1][i]) for i, name in enumerate(volumes)})
    (root / "ACDC").mkdir(parents=True, exist_ok=True)
    (root / "ACDC/train_slices.list").write_text("\n".join(slices) + "\n")
    (root / "ACDC/val.list").write_text("\n".join(volumes[:n_valid]) + "\n")
    (root / "ACDC/test.list").write_text("\n".join(volumes[n_valid:]) + "\n")
    patients = sorted({"_".join(n.split("_")[:2]) for n in slices + volumes})
    spacings = {p: acdc_spacing(i) for i, p in enumerate(patients)}
    (root / "ACDC/raw_spacing.csv").write_text("\n".join(
        ["case,sz,sy,sx"] + [f"{p},{','.join(map(str, sp))}" for p, sp in spacings.items()]) + "\n")

    class InMemoryACDC(ACDCDataset):
        def read_case(self, case):
            return cases[case]

    return InMemoryACDC, spacings


def write_thyroid(root: Path, layout: str, n_train, n_valid, n_test=0, size=(336, 448), seed=0):
    """TN3K (``trainval-*`` with a fold-0 split, ``test-*``) or TG3K
    (``thyroid-*`` with one split) JPGs: a bright ellipse on noise, masks 0/255."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    hh, ww = size
    yy, xx = np.mgrid[0:hh, 0:ww]
    dirs = ({"trainval": ("trainval-image", "trainval-mask"), "test": ("test-image", "test-mask")}
            if layout == "tn3k" else {"trainval": ("thyroid-image", "thyroid-mask")})
    for img_dir, mask_dir in dirs.values():
        (root / img_dir).mkdir(parents=True, exist_ok=True)
        (root / mask_dir).mkdir(parents=True, exist_ok=True)

    def write(img_dir, mask_dir, name):
        cy, cx = rng.uniform(0.3, 0.7) * hh, rng.uniform(0.3, 0.7) * ww
        ry, rx = rng.uniform(0.1, 0.25) * hh, rng.uniform(0.1, 0.25) * ww
        mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).astype(np.uint8)
        image = np.clip(70.0 + 90.0 * mask + rng.normal(0.0, 20.0, size), 0, 255)
        Image.fromarray(image.astype(np.uint8)).save(root / img_dir / f"{name}.jpg", quality=95)
        Image.fromarray(mask * 255).save(root / mask_dir / f"{name}.jpg", quality=95)

    ids = list(range(n_train + n_valid))
    for i in ids:
        write(*dirs["trainval"], f"{i:04}")
    for i in range(n_test):
        write(*dirs["test"], f"{i:04}")
    split = json.dumps({"train": ids[:n_train], "val": ids[n_train:]})
    (root / ("tn3k-trainval-fold0.json" if layout == "tn3k" else "tg3k-trainval.json")).write_text(
        split)


def tree_to(tree, device):
    """A recipe's parameter tree (dicts, lists, tensors) moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def near_ties(np, matrices, fire, h, w, tol=1e-4):
    """Pixels of the fired samples whose nearest-warp source coordinate lies
    within ``tol`` of a .5 rounding tie, from the float32 matrices in float64."""
    m = matrices.cpu().numpy().astype(np.float64)[fire.cpu().numpy()]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    count = 0
    for mi in m:
        for row in range(2):
            src = mi[row, 0] * xs + mi[row, 1] * ys + mi[row, 2]
            count += int((np.abs(src - np.floor(src) - 0.5) < tol).sum())
    return count


def acdc_thyroid_phase(torch, device, workdir: Path, sl):
    import numpy as np

    from mia_tpu_torch.data import DATASETS, ACDCDataset, collate
    from mia_tpu_torch.models import UNet
    from mia_tpu_torch.training import ALTrainer
    from mia_tpu_torch.transforms import get_train_transform

    kernel_counts = counters()
    for fn in kernel_counts.values():
        fn.launches = 0
    card = card_line()

    # --- ACDC: 2 rounds of 20 iterations, volume-mode validation and test
    InMemoryACDC, spacings = write_in_memory_acdc(np, ACDCDataset, workdir / "acdc")
    split_s = {}  # (round, part) -> seconds

    def timed_part(part):
        def wrap(orig):
            def run(self, *args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = orig(self, *args)
                torch.cuda.synchronize()
                key = (self.current_round, part)
                split_s[key] = split_s.get(key, 0.0) + time.perf_counter() - t0
                return out
            return run
        return wrap

    def timed_selector(orig):
        def setup(self):
            orig(self)
            select = self.active_selector.select_next_batch

            def timed_select(*args, **kwargs):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = select(*args, **kwargs)
                torch.cuda.synchronize()
                key = (self.current_round, "selection")
                split_s[key] = split_s.get(key, 0.0) + time.perf_counter() - t0
                return out
            self.active_selector.select_next_batch = timed_select
        return setup

    def round_start(orig):
        def start(self):
            torch.cuda.synchronize()
            self._smoke_round_t0 = time.perf_counter()
            return orig(self)
        return start

    def round_end(orig):
        def end(self):
            r = self.current_round
            out = orig(self)
            torch.cuda.synchronize()
            split_s[(r, "round")] = time.perf_counter() - self._smoke_round_t0
            return out
        return end

    rounds, iters, budget, batch = 2, 20, 8, 12
    hooks = {"train_step": timed_part("train"), "valid": timed_part("valid"),
             "perform_real_test": timed_part("test"), "_setup_active_selector": timed_selector,
             "on_round_start": round_start, "on_round_end": round_end}
    argv = ["--work-path", str(workdir / "acdc_work"), "--data-path", str(workdir / "acdc"),
            "--device", "cuda", "--dataset", "ACDC", "--in-channels", "1", "--num-classes", "3",
            "--image-size", "256", "256", "--batch-size", str(batch), "--do-augment",
            "--do-oversample", "--active-selector", "entropy", "--budget", str(budget),
            "--num-rounds", str(rounds), "--num-iters", str(iters), "--valid-freq-iter", "10",
            "--quiet"]
    DATASETS["acdc"], original = InMemoryACDC, DATASETS["acdc"]
    try:
        t0 = time.perf_counter()
        trainer, rec = run_al(torch, argv, hooks)
        acdc_s = time.perf_counter() - t0
    finally:
        DATASETS["acdc"] = original
    work = trainer.work_path
    check(trainer.config.valid_mode == "volumn", "ACDC ran without volume-mode validation")
    check(all(p.device.type == "cuda" for p in trainer.model.parameters()),
          "ACDC: UNet parameters are not on CUDA")
    check(trainer.model.encoder.levels[4][1].all[0].weight.shape[0] == 512,
          "ACDC: UNet is not at full width")
    check(len(rec["losses"]) == rounds * iters and all(math.isfinite(x) for x in rec["losses"]),
          f"ACDC: train losses {rec['losses']}")
    sizes = [len(json.loads((work / f"round_{r}/data_list.json").read_text())
                 ["labeled_image_idx"]) for r in range(rounds)]
    check(sizes == [budget * (r + 1) for r in range(rounds)], f"ACDC: labeled sizes {sizes}")
    for r in range(rounds):
        rows = (work / f"test_mean_round_{r}.csv").read_text().splitlines()
        header = rows[0].split(",")
        check(len(rows) == 5 and all(f"{c}-{m}" in header for c in ("RV", "Myo", "LV")
                                     for m in ("DSC", "HD", "ASD", "JSD")),
              f"ACDC: test_mean_round_{r}.csv malformed: {rows[:2]}")
        dsc = [float(row.split(",")[header.index(f"{c}-DSC")]) for row in rows[1:]
               for c in ("RV", "Myo", "LV")]
        check(all(math.isfinite(x) for x in dsc), f"ACDC: round {r} test DSC {dsc}")
    check(any(math.isfinite(float(x)) for x in rows[1].split(",")[header.index("RV-HD")::4]),
          "ACDC: no finite per-class HD in the last test")

    # the same predictions of one valid volume, metrics on the card and on the CPU
    valid = trainer.valid_dataset
    vol_batch = collate([valid.get_sample(0)])
    check(vol_batch["image"].shape == (1, 10, 216, 256, 1), f"ACDC volume {vol_batch['image'].shape}")
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        pred, labels, loss, spacing, volume = trainer._eval_predict(vol_batch)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    check(volume and pred.shape == (10, 216, 256) and pred.device.type == "cuda",
          "ACDC: the valid volume was not evaluated as one volume on the card")
    # the JAX package's order: (z, y, x) rolled by one
    want_sp = tuple(np.roll(np.float32(spacings[valid.samples_list[0]]), 1).tolist())
    check(tuple(float(v) for v in spacing) == want_sp, f"ACDC: metric spacing {spacing}")
    on_card = [t.cpu().numpy().astype(np.float64)
               for t in trainer._eval_metrics(pred, labels, spacing, True)]
    on_cpu = [t.numpy().astype(np.float64)
              for t in trainer._eval_metrics(pred.cpu(), labels.cpu(), spacing, True)]
    metric_err = 0.0
    for got, want in zip(on_card, on_cpu):
        check(np.array_equal(got[..., [0, 3]], want[..., [0, 3]]),
              f"ACDC: DSC/JC card {got[..., [0, 3]]} vs CPU {want[..., [0, 3]]}")
        g, w = got[..., [1, 2]], want[..., [1, 2]]
        check(np.array_equal(np.isfinite(g), np.isfinite(w)) and np.array_equal(
            g[~np.isfinite(g)], w[~np.isfinite(w)], equal_nan=True),
              f"ACDC: non-finite HD/ASD differ: {g} vs {w}")
        fin = np.isfinite(w)
        if fin.any():
            metric_err = max(metric_err, float(np.max(np.abs(g[fin] - w[fin])
                                                      / np.maximum(np.abs(w[fin]), 1e-30))))
    check(metric_err <= METRIC_TOL, f"ACDC: HD/ASD card vs CPU relative {metric_err}")
    check(int(np.isfinite(on_cpu[1][..., 1]).sum()) >= 2, "ACDC: too few finite HDs to compare")
    eval_times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._finalize_eval(*trainer._eval_batch(vol_batch))
        eval_times.append(time.perf_counter() - t0)
    volume_ms = statistics.median(eval_times[1:]) * 1e3

    # the acdc recipe on one batch, card against CPU, from the same drawn parameters
    train_ds = InMemoryACDC(workdir / "acdc", split="train", image_channels=1, image_size=(256, 256))
    samples = collate([train_ds.get_sample(i) for i in range(batch)])
    img = torch.from_numpy(samples["image"])
    lbl = torch.from_numpy(samples["label"]).long()
    recipe = get_train_transform("acdc")
    gen = torch.Generator(device=device).manual_seed(5)
    params = recipe.draw(gen, tuple(img.shape), device)
    k1_before = kernel_counts["K1"].launches
    card_img, card_lbl = recipe.apply(params, img.to(device), lbl.to(device))
    torch.cuda.synchronize()
    cpu_img, cpu_lbl = recipe.apply(tree_to(params, "cpu"), img, lbl)
    check(kernel_counts["K1"].launches == k1_before, "the acdc recipe launched K1")
    check(torch.equal(card_img.cpu(), cpu_img) and torch.equal(card_lbl.cpu(), cpu_lbl),
          f"acdc recipe: card and CPU differ at {int((card_img.cpu() != cpu_img).sum())} image "
          f"and {int((card_lbl.cpu() != cpu_lbl).sum())} label pixels")
    affine = params["stages"][1]
    ties = near_ties(np, affine["inner"]["matrix"], affine["fire"], 256, 256)
    fired = [int(params["stages"][i]["fire"].sum()) for i in range(2)]
    check(min(fired) > 0, f"acdc recipe: a gate never fired in the batch {fired}")

    # --- TN3K: residual blocks, instance norm, deep supervision, adamw
    write_thyroid(workdir / "tn3k", "tn3k", 48, 8, 8)
    saved, heads0, steps, last_batch = {}, {}, [], []

    def capture_start(orig):
        def run(self):
            heads0.update({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()
                           if ".ds." in k})
            return orig(self)
        return run

    def capture_save(orig):
        def save(self, save_path, save_training_state=False, model_state=None):
            orig(self, save_path, save_training_state, model_state)
            if Path(save_path).name in ("best_model", "final_model"):
                state = self.model.state_dict() if model_state is None else model_state
                opt = self.state.optimizer
                saved[Path(save_path).name] = (
                    {k: v.detach().cpu().clone() for k, v in state.items()},
                    (opt.count, [t.cpu().clone() for t in opt.mu], [t.cpu().clone() for t in opt.nu])
                    if save_training_state else None)
        return save

    def timed_step(orig):
        def step(self, batch_):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig(self, batch_)
            torch.cuda.synchronize()
            steps.append(time.perf_counter() - t0)
            last_batch[:] = [batch_]
        return step

    tn_iters, weight_decay = 10, 0.05
    tn3k, tn_rec = run_al(torch, [
        "--work-path", str(workdir / "tn3k_work"), "--data-path", str(workdir / "tn3k"),
        "--device", "cuda", "--dataset", "tn3k", "--in-channels", "1", "--num-classes", "1",
        "--image-size", "256", "256", "--batch-size", str(batch), "--do-augment",
        "--block-type", "res", "--block-normalization", "instance", "--deep-supervision",
        "--ds-layer", "3", "--optimizer", "adamw", "--weight-decay", str(weight_decay),
        "--lr-warmup-iter", "2", "--active-selector", "entropy", "--budget", "16",
        "--num-rounds", "1", "--num-iters", str(tn_iters), "--valid-freq-iter", "5", "--quiet",
    ], {"on_train_start": capture_start, "save_state_dict": capture_save,
        "train_step": timed_step})
    check(len(tn_rec["losses"]) == tn_iters and all(math.isfinite(x) for x in tn_rec["losses"]),
          f"TN3K: losses {tn_rec['losses']}")
    cfg = tn3k.model.cfg
    check((cfg.block_type, cfg.normalization, cfg.deep_supervision, cfg.ds_levels)
          == ("res", "instance", True, [1, 2]) and cfg.channels_list[-1] == 512,
          f"TN3K: UNet {cfg}")
    state = tn3k.model.state_dict()
    check(sorted(k for k in state if ".ds." in k) == sorted(heads0) and len(heads0) == 4
          and not any("running_mean" in k for k in state), "TN3K: heads or norms malformed")
    tn_work = tn3k.work_path
    final_sd, final_opt = read_al_checkpoint(torch, tn3k, tn_work / "round_0/final_model")
    best_sd, _ = read_al_checkpoint(torch, tn3k, tn_work / "round_0/best_model")
    want_sd, (count, mu, nu) = saved["final_model"]
    check(set(final_sd) == set(want_sd) and all(torch.equal(final_sd[k], want_sd[k])
                                                for k in want_sd),
          "TN3K: final_model/model.msgpack differs from the trainer's memory")
    check(final_opt.count == count and all(torch.equal(a.cpu(), b) for a, b in zip(
        (*final_opt.mu, *final_opt.nu), (*mu, *nu))),
          "TN3K: final_model/opt_state.msgpack differs from the trainer's memory")
    check(all(torch.equal(best_sd[k], v) for k, v in saved["best_model"][0].items()),
          "TN3K: best_model/model.msgpack differs from the trainer's memory")
    # the heads: zero gradient, so adamw's decay alone, p ← p − lr·wd·p each step
    head_err = 0.0
    for k, p0 in heads0.items():
        want = p0.clone()
        for step in range(tn_iters):
            want = want - float(tn3k.lr_schedule(step)) * (weight_decay * want)
        got = want_sd[k]
        # a zero bias stays zero under decay; the kernels must move
        check(not torch.equal(got, p0) or not p0.any(), f"TN3K: head {k} did not move")
        head_err = max(head_err, ((got - want).abs().max() / want.abs().max()).item())
    check(head_err <= 1e-6, f"TN3K: heads off optax's decay by {head_err} relative")
    # one forward of this UNet on the card against the CPU, float32 convolutions
    cpu_unet = UNet(cfg)
    cpu_unet.load_state_dict({k: v.cpu() for k, v in state.items()})
    cpu_unet.eval()
    tn3k.model.eval()
    x = torch.rand((2, 256, 256, 1), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want_out = cpu_unet(x, return_ds=True)
        try:
            torch.backends.cudnn.allow_tf32 = False
            got_out = [t.cpu() for t in tn3k.model(x.to(device), return_ds=True)]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
    fwd_err = max(((g - w).abs().max() / w.abs().max()).item() for g, w in zip(got_out, want_out))
    check(len(got_out) == 3 and fwd_err <= 1e-4,
          f"TN3K: UNet outputs card vs CPU {fwd_err} of max |logit|")
    header = (tn_work / "test_mean_round_0.csv").read_text().splitlines()[0]
    check(header.endswith("thyroid-DSC,thyroid-HD,thyroid-ASD,thyroid-JSD"), f"TN3K: {header}")
    tn_step_ms = statistics.median(steps[3:]) * 1e3
    skip_err, skip_ms = residual_skip_forms(torch, tn3k, x.to(device), got_out[0], last_batch[0])

    # --- TG3K: its registry entry and split (test == valid) on the machine
    write_thyroid(workdir / "tg3k", "tg3k", 24, 8)
    tg3k, tg_rec = run_al(torch, [
        "--work-path", str(workdir / "tg3k_work"), "--data-path", str(workdir / "tg3k"),
        "--device", "cuda", "--dataset", "tg3k", "--num-classes", "1", "--image-size", "256",
        "256", "--batch-size", str(batch), "--do-augment", "--budget", "12", "--num-rounds", "1",
        "--num-iters", "4", "--valid-freq-iter", "2", "--quiet"])
    tg_rows = (tg3k.work_path / "test_mean_round_0.csv").read_text().splitlines()
    check(len(tg_rec["losses"]) == 4 and len(tg_rows) == 9, f"TG3K: {len(tg_rows)} test rows")

    launched = {k: fn.launches for k, fn in kernel_counts.items() if fn.launches}
    check(not launched, f"the ACDC and thyroid phase launched hand kernels: {launched}")

    parts = {r: {part: round(split_s.get((r, part), 0.0), 3)
                 for part in ("round", "train", "valid", "test", "selection")}
             for r in range(rounds)}
    print(f"acdc: {rounds} AL rounds x {iters} iters at width 32..512, 256^2, batch {batch}, "
          f"volume-mode validation of 4 and test of 4 volumes (10 x 216 x 256); labeled {sizes}; "
          f"losses first {rec['losses'][0]:.4f} last {rec['losses'][-1]:.4f}; total {acdc_s:.1f} s")
    print(f"acdc: round seconds by part {parts} [{card}]")
    print(f"acdc: one volume evaluation {volume_ms:.2f} ms (median of 5, TF32 convolutions) "
          f"[{card}]; card vs CPU volume metrics: DSC/JC equal, HD/ASD max relative "
          f"{metric_err:.3g}")
    print(f"acdc: recipe card vs CPU equal on ({batch}, 256, 256, 1), gates fired {fired}, "
          f"{ties} source coordinates within 1e-4 of a .5 tie; K1 launches 0")
    print(f"tn3k: res + instance + deep supervision (heads on levels {cfg.ds_levels}), adamw "
          f"wd {weight_decay}: train step median {tn_step_ms:.2f} ms vs the slice phase's plain "
          f"step {sl['step_ms']:.2f} ms (batch {batch}, 256^2) [{card}]; checkpoints equal the "
          f"trainer's memory; heads decayed within {head_err:.3g} of optax; UNet card vs CPU "
          f"{fwd_err:.3g} of max |logit|")
    print(f"tn3k: residual skip as a stride-2 1x1 conv (the card's) against the CPU's form, a "
          f"stride-1 1x1 conv of every 2nd pixel: logits within {skip_err:.3g} of max (float32 "
          f"convolutions); train step median {skip_ms['strided'][0]:.2f} / "
          f"{skip_ms['strided'][1]:.2f} ms strided, {skip_ms['slice'][0]:.2f} / "
          f"{skip_ms['slice'][1]:.2f} ms sliced (in turns) [{card}]")
    print(f"tg3k: 1 round x 4 iters, test on the valid split ({len(tg_rows) - 1} cases)")
    return {"launches": {}, "acdc_round_s": parts, "acdc_total_s": round(acdc_s, 2),
            "volume_eval_ms": round(volume_ms, 3), "volume_metric_rel_err": metric_err,
            "recipe_ties": ties, "tn3k_step_ms": round(tn_step_ms, 3),
            "slice_step_ms": round(sl["step_ms"], 3), "tn3k_forward_err": fwd_err,
            "tn3k_head_decay_err": head_err, "residual_skip_step_ms": skip_ms,
            "residual_skip_logit_err": skip_err}


def residual_skip_forms(torch, trainer, x, logits, batch):
    """The residual blocks' skip as the port runs it on the card (a stride-s
    1x1 conv) against its CPU form (a stride-1 1x1 conv on every s-th pixel),
    on the card: the largest logit difference of one eval forward of ``x``
    in the CPU form against ``logits`` (float32 convolutions), and the train
    step's median ms of each form, run in turns, on ``batch``. Trains the
    model further."""
    import torch.nn.functional as F

    from mia_tpu_torch.models.unet import ResidualBlock

    def sliced(self, x_, generator=None):
        conv, norm, dropout, act = self.all
        out = act(dropout(norm(conv(x_)), generator))
        if self.downsample_skip is None:
            return x_ + out
        skip_conv, skip_norm = self.downsample_skip
        s = self.stride
        return skip_norm(F.conv2d(x_[:, :, ::s, ::s], skip_conv.weight, skip_conv.bias)) + out

    strided = ResidualBlock.forward
    tf32 = torch.backends.cudnn.allow_tf32

    def median_step_ms(n=10):
        times = []
        for _ in range(n + 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer._train_step(trainer.state, batch["image"], batch["label"], trainer.generator)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        return statistics.median(times[2:]) * 1e3

    ms = {"strided": [], "slice": []}
    try:
        ResidualBlock.forward = sliced
        trainer.model.eval()
        torch.backends.cudnn.allow_tf32 = False
        with torch.no_grad():
            got = trainer.model(x, return_ds=True)[0].cpu()
        torch.backends.cudnn.allow_tf32 = tf32
        err = ((got - logits).abs().max() / logits.abs().max()).item()
        check(err <= 1e-5, f"TN3K: the CPU's sliced skip lies {err} of max from the card's")
        for form in ("strided", "slice", "strided", "slice"):
            ResidualBlock.forward = strided if form == "strided" else sliced
            ms[form].append(round(median_step_ms(), 3))
    finally:
        ResidualBlock.forward = strided
        torch.backends.cudnn.allow_tf32 = tf32
    return err, ms


# ---------------------------------------------------------------------------
# selector phase: every AL selector on the card against the CPU, then
# al_train_torch with BADGE, --resume, --init-round-path and BUSI
# ---------------------------------------------------------------------------

NEW_SELECTORS = ("confidence", "margin", "coreset-l2", "coreset-cosine", "kmean-l2",
                 "kmean-cosine", "badge")
SELECT_TOL = 1e-4  # card (float32 convolutions) against CPU, of the largest |value|
ARGMAX_GAP = 1e-4  # card vs CPU: a pixel's argmax may differ below this top-2 logit gap


def argmax_flips(torch, np, card, host, ds, device):
    """Per image of ``ds``, how many pixels' argmax differs between the card's
    and the CPU's logits (float32 convolutions), the largest of the CPU's
    top-2 gaps at those pixels (0.0 when none differs), and the card's argmax
    maps (N, H, W)."""
    from mia_tpu_torch.activelearning import sweep_pool

    def logits(scorer):
        def fn(images):
            with torch.no_grad():
                return scorer.model(scorer._prep(images)).to(torch.float32)
        return fn

    got = sweep_pool(ds, 8, lambda im: logits(card)(im).argmax(-1), device)[0]
    want = torch.from_numpy(sweep_pool(ds, 8, logits(host.scorer), torch.device("cpu"))[0])
    top2 = torch.topk(want, 2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).numpy()
    differ = got != want.argmax(-1).numpy()
    return differ.sum((1, 2)), float(gap[differ].max()) if differ.any() else 0.0, got


def with_label_maps(torch, fn, maps, device):
    """``fn(images, preds=...)`` for ``sweep_pool``: each call takes the next
    rows of ``maps`` (N, H, W), in the sweep's order."""
    taken = [0]

    def run(images):
        n = len(images)
        preds = torch.from_numpy(maps[taken[0]:taken[0] + n]).to(device)
        taken[0] += n
        return fn(images, preds=preds)
    return run


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


WARMER_RUNS = (False, True, True, False)  # warm_pool_cache of each run, in turns


def warmer_phase(torch, workdir: Path, sl):
    """``al_train_torch`` on the slice's FUGC set, 2 rounds of 6 iterations,
    with ``warm_pool_cache`` off and on in turns (cuDNN's deterministic
    algorithms, so that the runs train alike): round 1's ``al/select``
    seconds, the pool samples in the decode cache when its sweep began, and
    the same picks in every run."""
    from mia_tpu_torch.utils import profiling

    iters = 6
    runs = []
    for i, warm in enumerate(WARMER_RUNS):
        rec = {}

        def warm_switch(orig, warm=warm):
            def method(self):
                self.config.warm_pool_cache = warm
                return orig(self)
            return method

        def round_start(orig, rec=rec):
            def method(self):
                if self.current_round != 1:
                    return orig(self)
                pool = self.active_dataset.pool_dataset
                cache = getattr(pool.dataset, "_decoded_cache", None) or {}
                rec["cached"] = sum(pool.case_name_to_idx[pool.image_idx[j]] in cache
                                    for j in range(len(pool)))
                rec["pool"] = len(pool)
                before = profiling.phase_times()["al/select"]["total_s"]
                out = orig(self)
                rec["select_s"] = profiling.phase_times()["al/select"]["total_s"] - before
                return out
            return method

        argv = [
            "--work-path", str(workdir / f"warm_{i}"), "--data-path", str(sl["data"]),
            "--device", "cuda", "--dataset", "fugc", "--in-channels", "3",
            "--num-classes", "2", "--image-size", "256", "--batch-size", "12",
            "--valid-mode", "slice", "--active-selector", "entropy",
            "--do-augment", "--do-normalize", "--optimizer", "adam",
            "--lr-scheduler", "poly", "--lr-warmup-iter", "5",
            "--num-rounds", "2", "--budget", "8",
            "--num-iters", str(iters), "--valid-freq-iter", str(iters),
            "--do-oversample", "--quiet",
        ]
        deterministic, benchmark = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
        try:
            profiling.reset_phase_times()
            trainer, r = run_al(torch, argv, {"_warm_pool_cache": warm_switch,
                                              "on_round_start": round_start})
        finally:
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
                deterministic, benchmark)
        check_al_run(f"warmer run {i}", trainer, r, (0, 1), (8, 16), iters)
        thread = getattr(trainer, "_pool_warm_thread", None)
        check((thread is not None) == warm, f"warmer run {i}: warm_pool_cache {warm}, thread {thread}")
        if thread is not None:
            thread.join(timeout=60)
            check(not thread.is_alive(), f"warmer run {i}: the warmer thread is still running")
        picks = json.loads((trainer.work_path / "round_1/data_list.json").read_text())
        runs.append({"warm": warm, "cached": rec["cached"], "pool": rec["pool"],
                     "select_s": rec["select_s"], "picks": sorted(picks["labeled_image_idx"]),
                     "launches": sum(r["k1"])})
        print(f"warmer: run {i} warm_pool_cache {warm}: round 1's al/select "
              f"{rec['select_s'] * 1e3:.2f} ms, {rec['cached']} of {rec['pool']} pool samples "
              f"decoded when its sweep began")
        del trainer
    check(all(r["picks"] == runs[0]["picks"] for r in runs),
          f"round 1's picks differ between the runs: {[r['picks'] for r in runs]}")
    cold = [r for r in runs if not r["warm"]]
    hot = [r for r in runs if r["warm"]]
    check(all(r["cached"] == r["pool"] for r in hot) and all(r["cached"] == 0 for r in cold),
          f"pool samples decoded at round 1's sweep: {[(r['cached'], r['pool']) for r in runs]}")
    print(f"warmer: round 1's al/select with the warmer "
          f"{[round(r['select_s'] * 1e3, 2) for r in hot]} ms, without "
          f"{[round(r['select_s'] * 1e3, 2) for r in cold]} ms; the same "
          f"{len(runs[0]['picks'])} labeled cases after round 1 in all {len(runs)} runs")
    return {"launches": sum(r["launches"] for r in runs),
            "select_ms": {"warm": [r["select_s"] * 1e3 for r in hot],
                          "cold": [r["select_s"] * 1e3 for r in cold]},
            "cached": {"warm": [r["cached"] for r in hot], "cold": [r["cached"] for r in cold]}}


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
        # BADGE differentiates against the model's own argmax, which may flip
        # between the devices where a pixel's top-2 logits nearly tie: both
        # embeddings are taken against the card's argmax maps, and every flip
        # is held to its top-2 gap
        flips, flip_gap, card_maps = argmax_flips(torch, np, card, host, pool, device)
        check(flip_gap < ARGMAX_GAP,
              f"badge: argmax differs at {int(flips.sum())} pixels of "
              f"{int((flips > 0).sum())} images, top-2 gap up to {flip_gap:.3g}")
        badge_flips = (int(flips.sum()), int((flips > 0).sum()))
        holds = {}
        for name, fn_card, fn_host, ds, bs in (
                ("confidence", lambda im: card.uncertainty(im, "confidence"),
                 lambda im: host.uncertainty(im, "confidence"), pool, 12),
                ("margin", lambda im: card.uncertainty(im, "margin"),
                 lambda im: host.uncertainty(im, "margin"), pool, 12),
                ("enc_feature", card.enc_feature, host.enc_feature, pool, 12),
                ("badge", with_label_maps(torch, card.badge_grad_embedding, card_maps, device),
                 with_label_maps(torch, host.scorer.badge_grad_embedding, card_maps, cpu),
                 pool, 8)):
            got, names_card = sweep_pool(ds, bs, fn_card, device)
            want, names_host = sweep_pool(ds, bs, fn_host, cpu)
            check(names_card == names_host and got.shape == want.shape,
                  f"{name}: the sweeps differ in shape or order")
            scale = float(np.abs(want).max())
            holds[name] = float(np.abs(got - want).max() / scale)
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
          + f" (limit {SELECT_TOL}; badge on every image, both against the card's argmax maps, "
          f"which differ from the CPU's at {badge_flips[0]} pixels of {badge_flips[1]} images, "
          f"each within {ARGMAX_GAP} of a tie); kcenter_greedy and the k-means++ "
          f"core pick the same on both devices; picks equal on both devices for every selector"
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
    return {"launches": launches, "select_ms": select_ms, "holds": holds,
            "badge_flips": dict(zip(("pixels", "images"), badge_flips)),
            "runs_s": runs,
            "differ": differ}


# ---------------------------------------------------------------------------
# demo and checkpoint phase: the files the AL trainer wrote, then demo_serve_torch
# serving a model.msgpack of al_train_torch
# ---------------------------------------------------------------------------

DEMO_GAP = 1e-4  # card (float32 convolutions) vs CPU: a class may differ below this top-2 gap
DEMO_FEATURE_TOL = 1e-5  # specialist features, of the largest |feature|
DEMO_RUNS = 5


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
# the bfloat16 instances of K2, K3 and K4 against their plain bfloat16 versions
# ---------------------------------------------------------------------------


def bf16_ulp(torch, x):
    """One bfloat16 unit in the last place of each element of ``x``, taken at
    no less than ``BF16_ULP_FLOOR`` of max |x|: a value near zero is a sum
    that cancelled, whose float32 rounding in another order moves it by more
    than its own ulp (a rel term of K2 did, on the card)."""
    x = x.float().abs()
    floor = max(x.max().item() * BF16_ULP_FLOOR, 2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(x.clamp_min(floor))) - 7)


def bf16_bound(tensors, flops):
    """The least time (ms): the tensors once at 3.35 TB/s, or ``flops`` at
    the dense bfloat16 tensor-core rate (989 TFLOP/s), whichever is larger."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_TC_FLOPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def bf16_kernel_phase(torch, device):
    """K2, K3 and K4 in bfloat16 at the float32 cases' shapes: outputs within
    ``BF16_TOL`` of max |plain| (K4 within one ulp an element), K2's and K3's
    log-sum-exp and K4's statistics within 1e-5 of the plain ones, two
    launches bit-identical; times, bounds and the library call."""
    from mia_tpu_torch.ops import attention, ln_window

    bf = torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(3)

    def randn(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (scale * torch.randn(shape, generator=gen, device=device) + shift).to(dtype)

    heads, d, ws, c = 12, 64, 14, 768
    worst = {k: [0.0, 0.0] for k in ("K2", "K3", "K4")}
    worst_lse = {"K2": 0.0, "K3": 0.0}
    worst_terms = [1.0]  # the smallest share of K2's rel terms bit-equal to the plain ones

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        check(got.dtype == bf and got.shape == want.shape, f"{name} bf16 {label}: {got.dtype} "
              f"{tuple(got.shape)}")
        check(bool(torch.isfinite(got).all()), f"{name} bf16 {label}: non-finite output")
        diff = (got.float() - want.float()).abs()
        err, ref = diff.max().item(), want.float().abs().max().item()
        if name == "K4":  # one rounding of the same float32 value: one ulp at most
            over = int((diff > bf16_ulp(torch, want)).sum())
            check(over == 0, f"K4 bf16 {label}: {over} elements more than one ulp from plain")
        else:
            check(err <= BF16_TOL * ref, f"{name} bf16 {label}: max |kernel - plain| {err} > "
                  f"{BF16_TOL} x max |plain| {ref}")
        worst[name] = [max(worst[name][0], err), max(worst[name][1], err / ref)]

    def launch_k2_terms(qkv, rh_, rw_, sc, k_hw, n_heads):
        """K2 in bfloat16 through its C entry, keeping kernel R's rel terms
        (the wrapper's launch, which the serving path makes, drops them)."""
        b, n, _ = qkv.shape
        out = torch.empty(b, n, qkv.shape[-1] // 3, device=device, dtype=bf)
        lse = torch.empty(b * n_heads, n, device=device)
        terms = torch.empty(b * n_heads, n, sum(k_hw), device=device, dtype=bf)
        attention._call("K2 bf16", "mia_attention_rel_packed_ik_bf16", qkv,
                        (qkv, rh_, rw_, out, lse, terms), k_hw, n_heads, sc)
        return out, lse, terms

    def hold_attention(name, label, args):
        """The wrapper's output against the plain version's, its log-sum-exp
        against the plain one of the same scores, and two launches. K2's rel
        terms are float32 sums rounded once to bfloat16, in another order
        than the plain version's: a term may round one ulp apart, which moves
        the scores by that ulp. So kernel R's terms are held to one ulp
        (and 99% bit-equal), and the log-sum-exp to the plain one of the
        kernel's own terms."""
        qkv, rel_a, rel_b, sc, k_hw, n_heads = args
        if name == "K2":
            out, lse = attention._launch_k2(*args, with_lse=True)
            out_c, lse_c, terms = launch_k2_terms(*args)
            torch.cuda.synchronize()
            check(torch.equal(out, out_c) and torch.equal(lse, lse_c),
                  f"K2 bf16 {label}: the wrapper's launch differs from its C entry's")
            want_h, want_w = attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, n_heads)
            want_terms = torch.cat([want_h, want_w], -1)
            diff = (terms.float() - want_terms.float()).abs()
            over = int((diff > bf16_ulp(torch, want_terms)).sum())
            equal = float((diff == 0).float().mean())
            check(over == 0 and equal >= 0.99, f"K2 bf16 {label}: rel terms {over} beyond one "
                  f"ulp, {equal:.4f} bit-equal")
            worst_terms[0] = min(worst_terms[0], equal)
            rel_h, rel_w = terms.split(list(k_hw), -1)
            want = attention.attention_rel_packed_bf16(qkv, want_h, want_w, sc, k_hw, n_heads)[0]
            again, lse_again = attention._launch_k2(*args, with_lse=True)
        else:
            out, lse = attention._launch_k3(*args, with_lse=True)
            rel_h, rel_w = rel_a, rel_b
            want = attention.attention_rel_packed_bf16(*args)[0]
            again, lse_again = attention._launch_k3(*args, with_lse=True)
        hold(name, label, out, want)
        _, want_lse = attention.attention_rel_packed_bf16(qkv, rel_h.contiguous(),
                                                          rel_w.contiguous(), sc, k_hw, n_heads)
        err = (lse - want_lse).abs().max().item()
        check(err <= LSE_TOL, f"{name} bf16 {label}: log-sum-exp off by {err} > {LSE_TOL}")
        worst_lse[name] = max(worst_lse[name], err)
        torch.cuda.synchronize()
        check(torch.equal(out, again) and torch.equal(lse, lse_again),
              f"{name} bf16 {label}: two launches differ")

    ln_scale = randn(c, scale=0.2, shift=1.0, dtype=torch.float32)
    ln_bias = randn(c, scale=0.1, shift=0.5, dtype=torch.float32)
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    inputs = {}
    for label, grid_shape, n_win in (("B=1", (1, 32, 32, c), 9), ("B=8", (8, 32, 32, c), 72),
                                     ("grid 20x27", (2, 20, 27, c), 8)):
        x = randn(*grid_shape)
        got, mu, rstd = ln_window._launch_k4(x, ln_scale, ln_bias, ws, 1e-6, with_stats=True)
        want = ln_window.ln_window_partition(x, ln_scale, ln_bias, ws)
        hold("K4", label, got, want)
        pad = ln_window.window_partition(x.new_ones(*grid_shape[:3], 1), ws)[0][..., 0] == 0
        check(not got[pad].any(), f"K4 bf16 {label}: pad slots are not zero")
        want_mu, want_rstd = (t[..., 0] for t in ln_window.layer_norm_stats(x.float(), 1e-6))
        stats_err = max((mu - want_mu).abs().max().item(), (rstd - want_rstd).abs().max().item())
        check(stats_err <= LSE_TOL, f"K4 bf16 {label}: mu/rstd off by {stats_err}")
        bit_identical(torch, "K4 bf16", label, (got, mu, rstd),
                      ln_window._launch_k4(x, ln_scale, ln_bias, ws, 1e-6, with_stats=True))
        qkv = randn(n_win, ws * ws, 3 * heads * d)
        hold_attention("K2", label, (qkv, rh, rw, d ** -0.5, (ws, ws), heads))
        inputs[("K4", label)] = (x, ln_scale, ln_bias, ws, 1e-6)
        inputs[("K2", label)] = (qkv, rh, rw, d ** -0.5, (ws, ws), heads)
    for label, b, k_hw in (("B=1", 1, (32, 32)), ("B=8", 8, (32, 32)),
                           ("4096 tokens", 1, (64, 64)), ("grid 20x27", 2, (20, 27))):
        n = k_hw[0] * k_hw[1]
        args = (randn(b, n, 3 * heads * d), randn(b * heads, n, k_hw[0]),
                randn(b * heads, n, k_hw[1]), d ** -0.5, k_hw, heads)
        hold_attention("K3", label, args)
        inputs[("K3", label)] = args
    h_heads, h_d = 16, 80  # ViT-H at 512²; its scale is not a power of two
    hold_attention("K2", "head dim 80", (randn(9, ws * ws, 3 * h_heads * h_d),
                                         randn(ws * ws, h_d, scale=0.1),
                                         randn(ws * ws, h_d, scale=0.1), h_d ** -0.5, (ws, ws),
                                         h_heads))
    hold_attention("K3", "head dim 80", (randn(1, 1024, 3 * h_heads * h_d),
                                         randn(h_heads, 1024, 32), randn(h_heads, 1024, 32),
                                         h_d ** -0.5, (32, 32), h_heads))
    print(f"bf16: K2 and K3 within {BF16_TOL} of max |plain| (worst relative "
          f"{worst['K2'][1]:.3g} / {worst['K3'][1]:.3g}), log-sum-exp within "
          f"{worst_lse['K2']:.3g} / {worst_lse['K3']:.3g} (limit {LSE_TOL}; K2's on its own "
          f"rel terms, of which at least {worst_terms[0]:.4f} equal the plain ones bit for bit, "
          f"the rest one ulp apart); K4 within one "
          f"bfloat16 ulp an element (max |diff| {worst['K4'][0]:.3g}), statistics within "
          f"{LSE_TOL}; two launches bit-identical on every case")

    def yardsticks(name, label):
        args = inputs[(name, label)]
        if name == "K4":
            x = args[0]
            out = ln_window.ln_window_partition(*args)
            return {"library_ms": None, **bound([x, args[1], args[2], out], 8 * x.numel())}
        qkv, rel_a, rel_b, sc, k_hw, n_heads = args
        b, n, _ = qkv.shape
        flops = attention_flops(b * n_heads, n, n, d)
        if name == "K2":
            flops += b * n_heads * n * sum(k_hw) * 2 * d
            rel_h, rel_w = attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, n_heads)
        else:
            rel_h, rel_w = rel_a, rel_b
        out = torch.empty(b, n, n_heads * d, device=device, dtype=bf)
        lib = sdpa_ms(torch, *head_major(qkv, n_heads), dense_bias(rel_h, rel_w, b, n_heads), sc,
                      50 if label == "B=1" else 10)
        return {"library_ms": lib, **bf16_bound([qkv, rel_a, rel_b, out], flops)}

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
            m = {"ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
                 **yardsticks(name, label)}
            print(f"{name} bf16 at ViT-B/512 {label}: kernel {k_a * 1e3:.2f} / {k_b * 1e3:.2f} us, "
                  f"plain {plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us; {describe_yardsticks(m)}")
            if label == "B=1":
                if name == "K4":
                    m = with_device_ms(torch, f"K4 bf16 at ViT-B/512 {label}",
                                       lambda: kernel(*args), "ln_window_partition_kernel", m)
                out[name] = {"max_abs_err": worst[name][0], **m}
            elif name != "K4":
                out[name]["b8"] = m
    return out


def bf16_train_kernel_phase(torch, device):
    """K2b, K3b and K4b in bfloat16 at the ViT-B/512 training shapes for batch
    12 (K2b on the 9 windows an image, tables off and on; K3b on the 1024
    tokens of a global block; K4b on (12, 32, 32, 768) at ws 14, parameters
    off and on), a 20x27 global grid and head dim 80: through the wrappers
    the trainer calls, every output within ``BF16_TOL`` of max |plain| of
    the plain bfloat16 VJP on the same inputs (the kernel's own forward's
    output and log-sum-exp), two launches bit-identical; event and device
    times beside the plain version, the library call (autograd through one
    bfloat16 ``scaled_dot_product_attention`` with the dense bias) and the
    bound at 989 TFLOP/s bfloat16 or 3.35 TB/s."""
    from mia_tpu_torch.ops import attention, ln_window

    bf = torch.bfloat16
    gen = torch.Generator(device=device)
    gen.manual_seed(5)

    def randn(*shape, scale=1.0, shift=0.0, dtype=bf):
        return (scale * torch.randn(shape, generator=gen, device=device) + shift).to(dtype)

    heads, d, ws, c, side = 12, 64, 14, 768, 32
    worst = {k: [0.0, 0.0, 1.0] for k in ("K2b", "K3b", "K4b")}  # abs, relative, least bit-equal

    def hold(name, label, got, want):
        torch.cuda.synchronize()
        check(len(got) == len(want), f"{name} bf16 {label}: {len(got)} outputs")
        for i, (a, b) in enumerate(zip(got, want)):
            check((a is None) == (b is None), f"{name} bf16 {label}: output {i} in one version only")
            if b is None:
                continue
            check(a.dtype == b.dtype and a.shape == b.shape,
                  f"{name} bf16 {label}: output {i} {a.dtype} {tuple(a.shape)}, plain {b.dtype} "
                  f"{tuple(b.shape)}")
            check(bool(torch.isfinite(a.float()).all()), f"{name} bf16 {label}: output {i} not finite")
            diff = (a.float() - b.float()).abs()
            err, ref = diff.max().item(), b.float().abs().max().item()
            check(err <= BF16_TOL * ref, f"{name} bf16 {label}: output {i} max |kernel - plain| "
                  f"{err} > {BF16_TOL} x max |plain| {ref}")
            equal = float((diff == 0).float().mean())
            worst[name] = [max(worst[name][0], err), max(worst[name][1], err / ref if ref else 0.0),
                           min(worst[name][2], equal)]

    timed = {}
    ln_scale = randn(c, scale=0.2, shift=1.0, dtype=torch.float32)
    ln_bias = randn(c, scale=0.1, shift=0.5, dtype=torch.float32)
    for label, shape in (("B=12", (12, side, side, c)), ("grid 20x27", (2, 20, 27, c))):
        x = randn(*shape)
        y, mu, rstd = ln_window._launch_k4(x, ln_scale, ln_bias, ws, 1e-6, with_stats=True)
        dy = randn(*y.shape)
        for params in (False, True):
            args = (x, dy, mu, rstd, ln_scale, ws, params)
            got = ln_window.ln_window_partition_fused_bwd(*args)
            hold("K4b", f"{label} params={params}", got, ln_window.ln_window_partition_bwd(*args))
            bit_identical(torch, "K4b bf16", f"{label} params={params}", got,
                          ln_window.ln_window_partition_fused_bwd(*args))
        if label == "B=12":
            timed["K4b"] = (x, dy, mu, rstd, ln_scale, ws, False)

    def k2b_case(label, n_win, n_heads, hd, tables_too=True):
        rh, rw = randn(ws * ws, hd, scale=0.1), randn(ws * ws, hd, scale=0.1)
        qkv = randn(n_win, ws * ws, 3 * n_heads * hd)
        out, lse = attention._launch_k2(qkv, rh, rw, hd ** -0.5, (ws, ws), n_heads, with_lse=True)
        g = randn(n_win, ws * ws, n_heads * hd)
        for tables in ((False, True) if tables_too else (False,)):
            args = (qkv, rh, rw, out, g, lse, hd ** -0.5, (ws, ws), n_heads, tables)
            got = attention.fused_attention_rel_packed_ik_bwd(*args)
            hold("K2b", f"{label} tables={tables}", got,
                 attention.attention_rel_packed_ik_bwd_bf16(*args))
            bit_identical(torch, "K2b bf16", f"{label} tables={tables}", got,
                          attention.fused_attention_rel_packed_ik_bwd(*args))
        return (qkv, rh, rw, out, g, lse, hd ** -0.5, (ws, ws), n_heads, False)

    def k3b_case(label, b, k_hw, n_heads, hd):
        n = k_hw[0] * k_hw[1]
        qkv = randn(b, n, 3 * n_heads * hd)
        rel_h, rel_w = randn(b * n_heads, n, k_hw[0]), randn(b * n_heads, n, k_hw[1])
        out, lse = attention._launch_k3(qkv, rel_h, rel_w, hd ** -0.5, k_hw, n_heads, with_lse=True)
        args = (qkv, rel_h, rel_w, out, randn(b, n, n_heads * hd), lse, hd ** -0.5, k_hw, n_heads)
        got = attention.fused_attention_rel_packed_bwd(*args)
        hold("K3b", label, got, attention.attention_rel_packed_bwd_bf16(*args))
        bit_identical(torch, "K3b bf16", label, got, attention.fused_attention_rel_packed_bwd(*args))
        return args

    timed["K2b"] = k2b_case("B=12", 12 * 9, heads, d)
    k2b_case("head dim 80", 9, 16, 80)
    timed["K3b"] = k3b_case("B=12", 12, (side, side), heads, d)
    k3b_case("grid 20x27", 2, (20, 27), heads, d)
    k3b_case("head dim 80", 1, (side, side), 16, 80)
    for name, (err, rel, equal) in worst.items():
        print(f"{name} bf16 within {BF16_TOL} of max |plain| on every case: max |diff| {err:.3g} "
              f"(relative {rel:.3g}), at least {equal:.4f} of each output bit-equal; two launches "
              "bit-identical")

    def yardsticks(name, args):
        if name == "K4b":
            x, dy, mu, rstd, ln_w = args[:5]
            # as the float32 K4b: x, the real tokens' dy, mu, rstd, scale read, dx written
            return {"library_ms": None, **bf16_bound([x, x, mu, rstd, ln_w, x], 12 * x.numel())}
        qkv, rel_a, rel_b, o, g, _, sc, k_hw, n_heads = args[:9]
        b, n, _ = qkv.shape
        flops = attention_flops(b * n_heads, n, n, d, backward=True)
        if name == "K2b":  # the rel terms again, and their cotangent routed into dq
            flops += b * n_heads * n * sum(k_hw) * 4 * d
            rel_h, rel_w = attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, n_heads)
            moved = [qkv, rel_a, rel_b, o, g, qkv]
        else:
            rel_h, rel_w = rel_a, rel_b
            moved = [qkv, rel_a, rel_b, o, g, qkv, rel_a, rel_b]
        g4 = g.view(b, n, n_heads, d).transpose(1, 2).contiguous()
        lib = sdpa_backward_ms(torch, *head_major(qkv, n_heads),
                               dense_bias(rel_h, rel_w, b, n_heads), sc, g4, 10)
        return {"library_ms": lib, **bf16_bound(moved, flops)}

    fns = {"K2b": (attention.fused_attention_rel_packed_ik_bwd,
                   attention.attention_rel_packed_ik_bwd_bf16),
           "K3b": (attention.fused_attention_rel_packed_bwd, attention.attention_rel_packed_bwd_bf16),
           "K4b": (ln_window.ln_window_partition_fused_bwd, ln_window.ln_window_partition_bwd)}
    out = {}
    for name, (kernel, plain) in fns.items():
        args = timed[name]
        (k_a, k_b), (plain_a, plain_b) = turns_ms(torch, lambda: kernel(*args),
                                                  lambda: plain(*args), 10)
        m = {"max_abs_err": worst[name][0], "ms": min(k_a, k_b), "plain_ms": min(plain_a, plain_b),
             "device_ms": device_ms(torch, lambda: kernel(*args), per_block=10)[0], **yardsticks(name, args)}
        print(f"{name} bf16 at ViT-B/512 training B=12: kernel {k_a * 1e3:.2f} / {k_b * 1e3:.2f} us "
              f"(device {m['device_ms'] * 1e3:.2f} us a call, every kernel of it), plain "
              f"{plain_a * 1e3:.2f} / {plain_b * 1e3:.2f} us; {describe_yardsticks(m)}")
        out[name] = m
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
# bfloat16 serving and training: SAM through the bfloat16 K2, K3 and K4, and
# al_train_torch --compute-dtype bfloat16
# ---------------------------------------------------------------------------

# the bfloat16 model on the card against the same model on the CPU (plain
# bfloat16 K2-K4, same weights), module by module: every module call inside a
# windowed and a global encoder block of the CPU's model, replayed on the
# card's module of the same name with the CPU call's own inputs. A Linear or
# LayerNorm rounds the same float32 value as the CPU's, bar sums taken in
# another order: at least BF16_LEAF_EQUAL of its outputs bit-equal (the
# float32 module, rounded, about half). The MLP carries a few such flips
# through its GELU, the attention through its softmax, and K2 / K3 round P
# before normalising it where the plain version rounds the normalised p: the
# two are held by ||card - CPU|| / ||CPU|| (BF16_MODULE_TOL), each limit below
# the float32 module's own distance to the CPU's bfloat16 output. The whole
# encoder then parts from the CPU's by about the bfloat16-vs-float32 gap (a
# flip moves every score of its row, block after block): the embedding and
# the mask logits against the CPU's are printed and held only to
# BF16_WHOLE_SANITY times that gap
BF16_LEAF_EQUAL = 0.998
BF16_MODULE_TOL = {"Attention": 3e-3, "MLPBlock": 1e-3}
BF16_WHOLE_SANITY = 2.0


def frob_rel(np, a, b) -> float:
    a, b = (np.asarray(t, np.float64) for t in (a, b))
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_module_holds(torch, np, cpu_model, card_model, card32_model, x_cpu, device):
    """Each module call inside encoder blocks 0 (windowed) and 2 (global) of
    the CPU's bfloat16 model, replayed on the card's bfloat16 module and on
    the card's float32 one (inputs widened) of the same name: {kind: [least
    share bit-equal, largest ||card - CPU|| / ||CPU||, least of the float32
    module's share and distance]}."""
    worst = {}
    for index in (0, 2):
        calls, hooks = [], []
        for name, module in cpu_model.image_encoder.blocks[index].named_modules():
            if type(module).__name__ in ("Linear", "LayerNorm", "Attention", "MLPBlock"):
                hooks.append(module.register_forward_hook(
                    lambda m, args, kwargs, out, name=name: calls.append(
                        (name, [a.clone() if torch.is_tensor(a) else a for a in args], kwargs,
                         out.clone())), with_kwargs=True))
        with torch.inference_mode():
            cpu_model.get_image_embeddings(x_cpu)
        for h in hooks:
            h.remove()
        card = dict(card_model.image_encoder.blocks[index].named_modules())
        card32 = dict(card32_model.image_encoder.blocks[index].named_modules())
        for name, args, kwargs, want in {c[0]: c for c in calls}.values():
            with torch.inference_mode():
                got = card[name](*(a.to(device) if torch.is_tensor(a) else a for a in args),
                                 **kwargs)
                got32 = card32[name](*(a.to(device, torch.float32) if torch.is_tensor(a) else a
                                       for a in args), **kwargs)
            check(got.dtype == torch.bfloat16 and got.shape == want.shape,
                  f"bf16 block {index} {name}: {got.dtype} {tuple(got.shape)}")
            equal = float((got.cpu() == want).float().mean())
            equal32 = float((got32.to(torch.bfloat16).cpu() == want).float().mean())
            err = frob_rel(np, got.float().cpu(), want.float())
            err32 = frob_rel(np, got32.cpu(), want.float())
            kind = type(card[name]).__name__
            w = worst.setdefault(kind, [1.0, 0.0, 1.0, float("inf")])
            worst[kind] = [min(w[0], equal), max(w[1], err), min(w[2], equal32), min(w[3], err32)]
    return worst


def bf16_serving_phase(torch, device, model, cpu_model):
    """``sam_model_registry["vit_b"](512, 3, compute_dtype=torch.bfloat16)``
    with the float32 SAM phase's weights serves the same frame: 8 / 4 / 8
    launches of the bfloat16 K2 / K3 / K4 a ``set_image`` and none of the
    float32 ones, a bfloat16 embedding on the card, the predict shapes; the
    card against the same bfloat16 model on the CPU, module by module
    (``bf16_module_holds``) and whole; its gap to the float32 model's
    embedding and mask logits; ``set_image`` and ``predict`` times of both models in turns
    (float32, bfloat16, bfloat16, float32)."""
    import numpy as np

    from mia_tpu_torch.models.sam import SamPredictor, sam_model_registry
    from mia_tpu_torch.ops import attention, ln_window

    bf = torch.bfloat16
    bmodel, _ = sam_model_registry["vit_b"](512, 3, compute_dtype=bf, device=device)
    bmodel.load_state_dict(model.state_dict())
    check(bmodel.image_encoder.compute_dtype == bf and bmodel.mask_decoder.compute_dtype == bf,
          "the registry did not build a bfloat16 SAM")
    check(all(p.dtype == torch.float32 and p.device.type == "cuda" for p in bmodel.parameters()),
          "bfloat16 SAM parameters are not float32 on the card")
    image = sam_frame(np)
    point, label = np.array([[352.0, 216.0]]), np.array([1])
    box = np.array([220.0, 110.0, 500.0, 330.0])
    coords16 = np.random.default_rng(5).uniform([0, 0], [640, 480], (16, 1, 2))
    labels16 = np.ones((16, 1), np.int64)
    counters = {"K2": attention.fused_attention_rel_packed_ik,
                "K3": attention.fused_attention_rel_packed,
                "K4": ln_window.ln_window_partition_fused}

    predictor = SamPredictor(bmodel)
    for fn in counters.values():
        fn.launches = fn.bf16_launches = 0
    predictor.set_image(image)
    torch.cuda.synchronize()
    per_set_image = {k: fn.bf16_launches for k, fn in counters.items()}
    outs = {"point": predictor.predict(point_coords=point, point_labels=label)}
    outs["box"] = predictor.predict(box=box)
    best = int(np.argmax(outs["point"][1]))
    outs["point+box+mask"] = predictor.predict(
        point_coords=point, point_labels=label, box=box, mask_input=outs["point"][2][best][None])
    batch = predictor.predict_batch(coords16, labels16)
    torch.cuda.synchronize()
    launches = {k: fn.bf16_launches for k, fn in counters.items()}
    float32_launches = {k: fn.launches for k, fn in counters.items()}
    check(per_set_image == {"K2": 8, "K3": 4, "K4": 8},
          f"bfloat16 kernel launches per set_image {per_set_image}, expected 8 K2, 4 K3, 8 K4")
    check(launches == per_set_image, f"bfloat16 predict launched encoder kernels: {launches}")
    check(not any(float32_launches.values()),
          f"the bfloat16 model launched float32 kernels: {float32_launches}")
    for name, (masks, iou, low) in outs.items():
        check(masks.shape == (3, 480, 640) and masks.dtype == bool, f"bf16 {name}: masks {masks.shape}")
        check(iou.shape == (3,) and low.shape == (3, 128, 128), f"bf16 {name}: iou/low-res shapes")
        check(bool(np.isfinite(iou).all() and np.isfinite(low).all()), f"bf16 {name}: non-finite")
    check(batch[0].shape == (16, 3, 480, 640) and bool(np.isfinite(batch[1]).all()),
          "bfloat16 predict_batch malformed")
    emb = predictor.get_image_embedding()
    check(emb.device.type == "cuda" and emb.dtype == bf and emb.shape == (1, 32, 32, 256)
          and bool(torch.isfinite(emb).all()), f"bfloat16 embedding {emb.dtype} {tuple(emb.shape)}")

    # the card against the CPU: the same bfloat16 model, weights and resized
    # input, module by module and whole; and the card's gap to its float32
    # model on that input
    cpu_bmodel, _ = sam_model_registry["vit_b"](512, 3, compute_dtype=bf)
    cpu_bmodel.load_state_dict(cpu_model.state_dict())
    cpu_predictor = SamPredictor(cpu_bmodel)
    cpu_predictor.set_image(image)
    x_cpu = cpu_predictor._input_image(image)
    modules = bf16_module_holds(torch, np, cpu_bmodel, bmodel, model, x_cpu, device)
    f32_predictor = SamPredictor(model)
    f32_predictor.set_image(image)
    with torch.inference_mode():
        predictor.features = bmodel.get_image_embeddings(x_cpu.to(device))
        f32_predictor.features = model.get_image_embeddings(x_cpu.to(device))
    emb, emb32 = predictor.get_image_embedding(), f32_predictor.get_image_embedding()
    emb_cpu = cpu_predictor.get_image_embedding()
    check(emb_cpu.dtype == bf, f"CPU bfloat16 embedding is {emb_cpu.dtype}")
    emb_gap = ((emb.float() - emb32).abs().max() / emb32.abs().max()).item()
    emb_gap_frob = frob_rel(np, emb.float().cpu(), emb32.cpu())
    emb_card = frob_rel(np, emb.float().cpu(), emb_cpu.float())
    prompts = {"point": dict(point_coords=point, point_labels=label), "box": dict(box=box),
               "point+box": dict(point_coords=point, point_labels=label, box=box)}
    logit_card, logit_gaps = {}, {}
    for name, kw in prompts.items():
        logits = predictor.predict(**kw, return_logits=True)[0]
        logits32 = f32_predictor.predict(**kw, return_logits=True)[0]
        check(logits.dtype == np.float32 and np.isfinite(logits).all(),
              f"bfloat16 {name} logits malformed")
        logit_card[name] = frob_rel(np, logits, cpu_predictor.predict(**kw, return_logits=True)[0])
        logit_gaps[name] = frob_rel(np, logits, logits32)
    logit_gap = max(logit_gaps.values())
    print("bf16 sam: modules of encoder blocks 0 and 2 on the CPU's inputs, card against CPU "
          "(least share bit-equal, largest ||card - CPU|| / ||CPU||; the float32 module's): "
          + ", ".join(f"{k} {v[0]:.4f} / {v[1]:.3g} ({v[2]:.4f} / {v[3]:.3g})"
                      for k, v in modules.items())
          + f"; limits: Linear and LayerNorm {BF16_LEAF_EQUAL} bit-equal, Attention "
          f"{BF16_MODULE_TOL['Attention']}, MLP {BF16_MODULE_TOL['MLPBlock']}")
    print(f"bf16 sam: whole model, card against the CPU's bfloat16 model, ||card - CPU|| / ||CPU||: "
          f"embedding {emb_card:.3g} (bfloat16 against float32 on the card {emb_gap_frob:.3g}), "
          "mask logits " + ", ".join(f"{k} {v:.3g} (float32 gap {logit_gaps[k]:.3g})"
                                     for k, v in logit_card.items())
          + f" (sanity bound {BF16_WHOLE_SANITY} x the gap)")
    check(set(modules) == {"Linear", "LayerNorm", "Attention", "MLPBlock"},
          f"bfloat16 module holds covered {sorted(modules)}")
    for kind in ("Linear", "LayerNorm"):
        check(modules[kind][0] >= BF16_LEAF_EQUAL,
              f"bfloat16 {kind} card vs CPU: {modules[kind][0]} bit-equal < {BF16_LEAF_EQUAL}")
    check(modules["Linear"][2] < BF16_LEAF_EQUAL,
          f"a float32 Linear rounded to bfloat16 is {modules['Linear'][2]} bit-equal to the CPU's")
    for kind, tol in BF16_MODULE_TOL.items():
        check(modules[kind][1] <= tol < modules[kind][3],
              f"bfloat16 {kind} card vs CPU {modules[kind][1]} (limit {tol}, float32 module "
              f"{modules[kind][3]})")
    check(emb_card <= BF16_WHOLE_SANITY * emb_gap_frob,
          f"bfloat16 embedding card vs CPU {emb_card} > {BF16_WHOLE_SANITY} x {emb_gap_frob}")
    for name, err in logit_card.items():
        check(err <= BF16_WHOLE_SANITY * logit_gaps[name],
              f"bfloat16 {name} logits card vs CPU {err} > {BF16_WHOLE_SANITY} x {logit_gaps[name]}")

    times = {}
    for key, p in (("float32", f32_predictor), ("bfloat16", predictor),
                   ("bfloat16 again", predictor), ("float32 again", f32_predictor)):
        times[key] = (median_s(lambda: p.set_image(image), torch, n=10) * 1e3,
                      median_s(lambda: p.predict(point_coords=point, point_labels=label),
                               torch, n=10) * 1e3)
    set_ms = {k: min(times[k][0], times[k + " again"][0]) for k in ("float32", "bfloat16")}
    predict_ms = {k: min(times[k][1], times[k + " again"][1]) for k in ("float32", "bfloat16")}
    print(f"bf16 sam: launches per set_image {per_set_image} (bfloat16 instances; no float32 "
          f"kernel); embedding {emb.dtype}, max |bf16 - f32| / max |f32| {emb_gap:.3g}; mask "
          f"logits ||bf16 - f32|| / ||f32|| up to {logit_gap:.3g}")
    print(f"bf16 sam: set_image ms float32 / bfloat16 / bfloat16 / float32 "
          f"{[round(times[k][0], 3) for k in times]}; predict ms {[round(times[k][1], 3) for k in times]}")
    return {"launches": launches, "set_image_ms": set_ms, "predict_ms": predict_ms,
            "embedding_gap": emb_gap, "logit_gap": logit_gap, "embedding_card_vs_cpu": emb_card,
            "logits_card_vs_cpu": logit_card, "modules_card_vs_cpu": modules}


def bf16_al_phase(torch, workdir: Path, sl):
    """``al_train_torch --compute-dtype bfloat16`` on the slice's FUGC set at
    full width, 2 rounds of 12 iterations: every convolution's output in
    bfloat16 (forward hooks), float32 parameters and checkpoints, one K1
    launch a step, finite losses; the step time (median of round 1's after 3
    warm-up steps) beside the float32 slice's, and the trained UNet's logits
    in bfloat16 against the same weights in float32."""
    from mia_tpu_torch.models import UNet
    from mia_tpu_torch.ops import warp
    from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack

    iters = 12
    steps, k1, conv_dtypes = [], [], set()

    def build(orig):
        def method(self, *args, **kwargs):
            out = orig(self, *args, **kwargs)
            for m in self.model.modules():
                if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                    m.register_forward_hook(lambda mod, i, o: conv_dtypes.add(o.dtype))
            return out
        return method

    def timed(orig):  # takes run_al's place on train_step: counts K1 too
        def method(self, batch):
            torch.cuda.synchronize()
            before = warp.affine_warp_shift2pass_fused.launches
            t0 = time.perf_counter()
            orig(self, batch)
            torch.cuda.synchronize()
            steps.append((self.current_round, time.perf_counter() - t0))
            k1.append(warp.affine_warp_shift2pass_fused.launches - before)
        return method

    argv = [
        "--work-path", str(workdir / "bf16"), "--data-path", str(sl["data"]),
        "--device", "cuda", "--dataset", "fugc", "--in-channels", "3",
        "--num-classes", "2", "--image-size", "256", "--batch-size", "12",
        "--valid-mode", "slice", "--active-selector", "entropy",
        "--do-augment", "--do-normalize", "--optimizer", "adam",
        "--lr-scheduler", "poly", "--lr-warmup-iter", "5",
        "--num-rounds", "2", "--budget", "8",
        "--num-iters", str(iters), "--valid-freq-iter", str(iters),
        "--do-oversample", "--quiet", "--compute-dtype", "bfloat16",
    ]
    trainer, rec = run_al(torch, argv, {"_build_model": build, "train_step": timed})
    work = trainer.work_path
    check(trainer.model.cfg.compute_dtype == torch.bfloat16, "the UNet was not built in bfloat16")
    check(trainer.model.encoder.levels[4][1].all[0].weight.shape[0] == 512, "UNet is not at full width")
    check(conv_dtypes == {torch.bfloat16}, f"convolution outputs in {conv_dtypes}")
    check(all(p.dtype == torch.float32 and p.device.type == "cuda"
              for p in trainer.model.parameters()), "UNet parameters are not float32 on the card")
    check(len(k1) == 2 * iters and all(k == 1 for k in k1), f"bf16: K1 launches per step {k1}")
    check(len(rec["losses"]) == 2 * iters and all(math.isfinite(x) for x in rec["losses"]),
          f"bf16: losses {rec['losses']}")
    for r in range(2):
        for kind in ("best_model", "final_model"):
            tree = read_flax_msgpack(work / f"round_{r}/{kind}/model.msgpack")
            leaves = []

            def walk(t):
                for v in t.values():
                    walk(v) if isinstance(v, dict) else leaves.append(v)

            walk(tree)
            check(leaves and all(v.dtype.name == "float32" for v in leaves),
                  f"round_{r}/{kind}/model.msgpack holds {sorted({v.dtype.name for v in leaves})}")
    # the trained weights in bfloat16 against float32, eval logits of one batch
    f32 = UNet(dataclasses.replace(trainer.model.cfg, compute_dtype=torch.float32)).cuda()
    f32.load_state_dict(trainer.model.state_dict())
    f32.eval()
    trainer.model.eval()
    x = torch.rand((2, 256, 256, 3), generator=torch.Generator().manual_seed(1)).cuda()
    with torch.no_grad():
        got, want = trainer.model(x), f32(x)
    check(got.dtype == torch.bfloat16 and bool(torch.isfinite(got).all()), "bfloat16 logits")
    logit_gap = ((got.float() - want).abs().max() / want.abs().max()).item()
    step_ms = statistics.median([t for r, t in steps if r == 1][3:]) * 1e3
    print(f"bf16 al: 2 rounds x {iters} iters at width 32..512, 256^2, batch 12; losses first "
          f"{rec['losses'][0]:.4f} last {rec['losses'][-1]:.4f}; every convolution output "
          f"bfloat16, parameters and model.msgpack float32, one K1 launch a step")
    print(f"bf16 al: train step median {step_ms:.2f} ms (round 1 after 3 warm-up steps) against "
          f"the float32 slice's {sl['step_ms']:.2f} ms; trained UNet's logits bf16 vs f32 max "
          f"|diff| / max |logit| {logit_gap:.3g}")
    return {"launches": sum(k1), "step_ms": step_ms, "float32_step_ms": sl["step_ms"],
            "logit_gap": logit_gap}


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

# ---------------------------------------------------------------------------
# 3D UNet, nnU-Net losses and export phase: no hand kernel lies on it
# ---------------------------------------------------------------------------

UNET3D_TOL = 1e-5  # 3D UNet logits, card against CPU (float32 convolutions), of max |logit|
LOSS_TOL = 1e-5  # each loss and its gradient, card against CPU, of the largest |value|
EXPORT_TOL = 1e-5  # an exported program against the live module, of the largest |value|
DS_WEIGHTS = (1.0, 0.5, 0.25)  # logits, then the heads of decoder levels 2 and 1
UNET3D_BATCH = (2, 128, 128, 128)  # the training batch: 2 volumes of 128^3
UNET3D_HOLD = (1, 64, 64, 64)  # the card-against-CPU volume
LOSS_SHAPE = (2, 128, 128, 128, 4)  # the losses' logits


@contextlib.contextmanager
def float32_convolutions(torch):
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def all_launches():
    return {k: fn.launches for k, fn in counters().items()}


def rel_diff(torch, got, want) -> float:
    """max |got - want| over max |want| (tensors on any devices)."""
    want = want.detach().cpu().double()
    return (got.detach().cpu().double() - want).abs().max().item() / max(
        want.abs().max().item(), 1e-30)


def nnunet_losses(torch):
    """name -> (loss(logits, labels, regions) on one device, uses regions)."""
    from mia_tpu_torch import losses as L

    weight = [1.0, 2.0, 0.5, 1.5]

    def w(x):
        return torch.tensor(weight, device=x.device)

    return {
        "cross_entropy(weight, ignore 255)":
            lambda x, y, r: L.cross_entropy(x, y, weight=w(x), ignore_index=255),
        "cross_entropy(label smoothing 0.1)":
            lambda x, y, r: L.cross_entropy(x, y.clamp_max(3), label_smoothing=0.1),
        "robust_cross_entropy": lambda x, y, r: L.robust_cross_entropy(
            x, y[..., None].clamp_max(3).float()),
        "topk_loss(k 10, ignore 255)":
            lambda x, y, r: L.topk_loss(x, y, k=10.0, ignore_index=255),
        "bce_with_logits": lambda x, y, r: L.bce_with_logits(x[..., :3], r[..., :3]),
        "memory_efficient_soft_dice_loss(mask, batch)":
            lambda x, y, r: L.memory_efficient_soft_dice_loss(
                x, y.clamp_max(3), (y != 255).float(), batch_dice=True, do_bg=False),
        # squared: the four plain counts weigh every class alike, and their
        # gradient through the softmax is zero up to rounding
        "get_tp_fp_fn_tn(mask, square)": lambda x, y, r: L.get_tp_fp_fn_tn(
            torch.softmax(x, -1), y.clamp_max(3), mask=(y != 255).float(), square=True),
        "DualBranchDiceAndCELoss": lambda x, y, r: L.DualBranchDiceAndCELoss()(
            {"low_res_logits1": x, "low_res_logits2": 0.5 * x.flip(1)}, y.clamp_max(3)),
        "DCAndCELoss(ignore 255)": lambda x, y, r: L.DCAndCELoss(ignore_label=255)(x, y),
        "DCAndBCELoss(ignore channel)":
            lambda x, y, r: L.DCAndBCELoss(use_ignore_label=True)(x[..., :3], r),
        "DCAndTopKLoss(ignore 255)": lambda x, y, r: L.DCAndTopKLoss(ignore_label=255)(x, y),
    }


def scalar(torch, out):
    """A loss's output as one scalar, each part of a tuple weighted apart."""
    if isinstance(out, tuple):
        return sum((i + 1.0) * o.sum() for i, o in enumerate(out))
    return out.sum()


def unet3d_loss_export_phase(torch, device, sam_model):
    """The 3D UNet at full width, the nnU-Net losses and the two exported
    programs on the card; no hand kernel launched."""
    import numpy as np

    from mia_tpu_torch import losses as L
    from mia_tpu_torch.models import UNet, UNetConfig, export
    from mia_tpu_torch.models.sam import SamPredictor
    from mia_tpu_torch.training import make_optimizer

    check(torch.backends.cudnn.allow_tf32, "the phase trains with TF32 convolutions")
    before = all_launches()
    out = {}

    # --- the 3D UNet: 32..512, 1 channel in, 4 classes, batch 2 at 128^3 ------
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.rand(UNET3D_BATCH + (1,), generator=gen, device=device)
    y = torch.randint(0, 4, UNET3D_BATCH, generator=gen, device=device)
    loss_fn = L.DCAndCELoss()
    for label, options, steps in (
            ("plain", {}, 3),
            ("res + instance + ds", dict(block_type="res", normalization="instance",
                                         deep_supervision=True, ds_layer=3), 2)):
        torch.manual_seed(0)
        cfg = UNetConfig(dimension=3, in_channels=1, out_classes=4, **options)
        model = UNet(cfg).to(device)
        check(model.encoder.levels[4][1].all[0].weight.shape == (512, 512, 3, 3, 3),
              "the 3D UNet is not at full width")
        params = list(model.parameters())
        opt = make_optimizer("adam", params, 1e-3, 10.0)
        model.train()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, losses = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            if cfg.deep_supervision:
                outs = model(x, gen, return_ds=True)
                check(len(outs) == 3 and all(o.shape == outs[0].shape for o in outs),
                      f"3D deep-supervision outputs {[tuple(o.shape) for o in outs]}")
                loss = sum(wt * loss_fn(o, y) for wt, o in zip(DS_WEIGHTS, outs))
            else:
                loss = loss_fn(model(x, gen), y)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            opt.step([torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)])
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(loss.item())
        peak = torch.cuda.max_memory_allocated() / 2**30
        check(all(math.isfinite(v) for v in losses), f"3D {label}: losses {losses}")
        step_ms = statistics.median(times[1:]) * 1e3
        print(f"unet3d: {label}, 32..512, batch {UNET3D_BATCH}, DCAndCELoss + Adam, TF32 "
              f"convolutions: step ms {[round(t * 1e3, 2) for t in times]} (median after the "
              f"first {step_ms:.2f}), max_memory_allocated {peak:.2f} GiB; losses "
              f"{[round(v, 4) for v in losses]}")
        out[f"unet3d {label}"] = {"step_ms": [t * 1e3 for t in times], "peak_gib": peak}
        if label == "plain":
            trained = model
        else:
            del model, params, opt, grads
    del x, y
    torch.cuda.empty_cache()

    # card against CPU on the same (trained) weights, float32 convolutions
    cpu_model = UNet(trained.cfg)
    cpu_model.load_state_dict({k: v.cpu() for k, v in trained.state_dict().items()})
    cpu_model.eval()
    trained.eval()
    vol = torch.rand(UNET3D_HOLD + (1,), generator=torch.Generator().manual_seed(2))
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model(vol)
        cpu_s = time.perf_counter() - t0
        with float32_convolutions(torch):
            got = trained(vol.to(device))
    err = rel_diff(torch, got, want)
    check(got.shape == UNET3D_HOLD + (4,) and torch.isfinite(got).all(), "3D logits malformed")
    check(err <= UNET3D_TOL, f"3D UNet logits card vs CPU {err:.3g} of max |logit|")
    print(f"unet3d: eval logits on {UNET3D_HOLD + (1,)}, card vs CPU (float32 convolutions): "
          f"{err:.3g} of max |logit| {want.abs().max().item():.3g} (CPU side {cpu_s:.1f} s)")
    out["unet3d card vs cpu"] = err
    del trained, cpu_model

    # --- the nnU-Net losses and their gradients at (2, 128, 128, 128, 4) -------
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(LOSS_SHAPE, generator=g)
    labels = torch.randint(0, 4, LOSS_SHAPE[:-1], generator=g)
    labels[torch.rand(labels.shape, generator=g) < 0.05] = 255
    regions = (torch.rand(LOSS_SHAPE, generator=g) < 0.3).float()
    worst, near_ties = {}, {}
    t0 = time.perf_counter()
    for name, fn in nnunet_losses(torch).items():
        results = []
        for dev in ("cpu", device):
            xl = logits.to(dev).requires_grad_(True)
            value = fn(xl, labels.to(dev), regions.to(dev))
            grad, = torch.autograd.grad(scalar(torch, value), xl)
            values = value if isinstance(value, tuple) else (value,)
            results.append(([v.detach() for v in values], grad))
        (cpu_vals, cpu_grad), (card_vals, card_grad) = results
        val_err = max(rel_diff(torch, c, h) for c, h in zip(card_vals, cpu_vals))
        card_grad = card_grad.cpu()
        if "TopK" in name or "topk" in name:
            # a pixel whose cross-entropy lies within 1e-5 of the k-th largest
            # may be picked on one device and not the other: its gradient
            # is left out of the comparison (and counted)
            per = L.cross_entropy(logits, labels, ignore_index=255, reduction="none")
            kth = torch.topk(per.reshape(-1), max(1, int(per.numel() * 10.0 / 100))).values.min()
            near = (per - kth).abs() <= 1e-5 * per.abs().max()
            near_ties[name] = int(near.sum())
            card_grad = torch.where(near[..., None], cpu_grad, card_grad)
        grad_err = rel_diff(torch, card_grad, cpu_grad)
        check(all(torch.isfinite(v).all() for v in card_vals), f"{name}: value not finite")
        check(val_err <= LOSS_TOL and grad_err <= LOSS_TOL,
              f"{name}: card vs CPU value {val_err:.3g}, gradient {grad_err:.3g} of max")
        worst[name] = (val_err, grad_err)
    print(f"losses: {len(worst)} nnU-Net losses on {LOSS_SHAPE} logits, card vs CPU "
          f"(value, gradient) of max: "
          + "; ".join(f"{n} {v:.2g}, {gr:.2g}" for n, (v, gr) in worst.items())
          + f" ({time.perf_counter() - t0:.1f} s); pixels within 1e-5 of the top-k threshold, "
          f"left out of the top-k gradients: {near_ties}")
    out["losses card vs cpu"] = worst
    del logits, labels, regions

    # --- export: the 2D FUGC UNet and SAM's prompt program ----------------------
    torch.manual_seed(4)
    unet = UNet(UNetConfig(in_channels=3, out_classes=3)).to(device)
    img = torch.rand((1, 256, 256, 3), generator=torch.Generator().manual_seed(5)).to(device)
    with float32_convolutions(torch):
        t0 = time.perf_counter()
        blob = export.export_unet_forward(unet, img)
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        program = export.load_exported(blob)
        load_s = time.perf_counter() - t0
        unet.eval()
        with torch.no_grad():
            want = unet(img)
            got = program(img)
        live_ms = median_s(lambda: unet(img), torch, 11) * 1e3
        prog_ms = median_s(lambda: program(img), torch, 11) * 1e3
    err = rel_diff(torch, got, want)
    check(got.device.type == "cuda" and err <= EXPORT_TOL,
          f"exported UNet vs the live module: {err:.3g} of max |logit|")
    print(f"export: 2D UNet 32..512 (1, 256, 256, 3): export {export_s:.2f} s, .pt2 "
          f"{len(blob) / 2**20:.1f} MiB, load {load_s:.2f} s; program vs live module "
          f"{err:.3g} of max |logit| (float32 convolutions); forward {prog_ms:.2f} ms, live "
          f"{live_ms:.2f} ms (medians of 11)")
    out["export unet"] = {"export_s": export_s, "load_s": load_s, "mib": len(blob) / 2**20,
                          "err": err, "program_ms": prog_ms, "live_ms": live_ms}
    del unet, program

    check(set_upsample_kernel(sam_model.mask_decoder, "never") > 0, "SAM decoder has no upscaler")
    # a seeded embedding in set_image's place (the encoder would launch K2-K4)
    e = sam_model.img_size // 16
    predictor = SamPredictor(sam_model)
    emb = torch.randn((1, e, e, 256), generator=torch.Generator().manual_seed(6)).to(device)
    predictor.features, predictor.is_image_set = emb, True
    predictor.input_size = predictor.original_size = (sam_model.img_size,) * 2
    rng = np.random.default_rng(7)
    points = 8
    coords = torch.zeros((1, points, 2), device=device)
    coords[0, :5] = torch.from_numpy(rng.uniform(0, 512, (5, 2)).astype(np.float32))
    labels = torch.full((1, points), -1, dtype=torch.int32, device=device)
    labels[0, :5] = torch.tensor([1, 1, 0, 1, 0], dtype=torch.int32)
    t0 = time.perf_counter()
    blob = export.export_sam_prompt_program(sam_model, max_points=points)
    export_s = time.perf_counter() - t0
    program = export.load_exported(blob)
    no_mask = (torch.zeros((1, 4 * e, 4 * e, 1), device=device), torch.zeros(1, device=device))
    with float32_convolutions(torch), torch.no_grad():
        masks, iou, low_res = program(emb, coords, labels, *no_mask)
        # the predictor appends one padding point: the program's last slot
        live = predictor.decode_on_device((coords[:, :-1], labels[:, :-1]))
        prog_ms = median_s(lambda: program(emb, coords, labels, *no_mask), torch, 11) * 1e3
        live_ms = median_s(lambda: predictor.decode_on_device(
            (coords[:, :-1], labels[:, :-1])), torch, 11) * 1e3
        with_mask = program(emb, coords, labels, live[2][..., :1], torch.ones(1, device=device))
    errs = [rel_diff(torch, masks.permute(0, 3, 1, 2), live[0]), rel_diff(torch, iou, live[1]),
            rel_diff(torch, low_res, live[2])]
    check(masks.shape == (1, 512, 512, 3) and max(errs) <= EXPORT_TOL,
          f"exported SAM program vs SamPredictor (masks, iou, low-res): {errs}")
    check(not torch.allclose(with_mask[0], masks), "has_mask does not switch the mask prompt in")
    print(f"export: SAM vit_b/512 prompt program ({points} point slots): export {export_s:.2f} s, "
          f".pt2 {len(blob) / 2**20:.1f} MiB; vs SamPredictor.decode_on_device on the same "
          f"embedding (masks, iou, low-res) {[f'{v:.3g}' for v in errs]} of max; decode "
          f"{prog_ms:.2f} ms, live {live_ms:.2f} ms (medians of 11)")
    out["export sam"] = {"export_s": export_s, "mib": len(blob) / 2**20, "errs": errs,
                         "program_ms": prog_ms, "live_ms": live_ms}

    after = all_launches()
    check(after == before, f"hand kernels launched in the phase: "
          f"{({k: after[k] - before[k] for k in after if after[k] != before[k]})}")
    print("unet3d, losses, export: no hand kernel launched")
    return out


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
    ``launches`` of the whole run and the peak memory; with ``bf16_steps``
    and ``bf16_launches``, the same counts of the bfloat16 instances."""
    from mia_tpu_torch.entry.cpcsam.train import train_entry
    from mia_tpu_torch.training import cpcsam_trainer

    counts = counters()
    bf16_counts = {k: fn for k, fn in counts.items() if hasattr(fn, "bf16_launches")}
    rec = {"steps": [], "bf16_steps": [], "losses": [], "snap": {}}
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
            before16 = {k: fn.bf16_launches for k, fn in bf16_counts.items()}
            t0 = time.perf_counter()
            super().train_step(batch)
            torch.cuda.synchronize()
            rows = None if self.memory is None else self.memory.valid.sum(1).tolist()
            rec["steps"].append((phase, time.perf_counter() - t0,
                                 {k: fn.launches - before[k] for k, fn in counts.items()
                                  if k != "K1"}, rows))
            rec["bf16_steps"].append({k: fn.bf16_launches - before16[k]
                                      for k, fn in bf16_counts.items()})

        def _log_train(self, step, lr, step_losses):
            rec["losses"].append([float(v) for v in step_losses.cpu()])
            return super()._log_train(step, lr, step_losses)

    cpcsam_trainer.CPCSAMTrainer = SmokeTrainer
    try:
        for fn in counts.values():
            fn.launches = 0
        for fn in bf16_counts.values():
            fn.bf16_launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        trainer = train_entry(argv)
        torch.cuda.synchronize()
        rec["total_s"] = time.perf_counter() - t0
        rec["launches"] = {k: fn.launches for k, fn in counts.items()}
        rec["bf16_launches"] = {k: fn.bf16_launches for k, fn in bf16_counts.items()}
        rec["peak"] = torch.cuda.max_memory_allocated(device)
    finally:
        cpcsam_trainer.CPCSAMTrainer = base
    return trainer, rec


def check_cpcsam_steps(torch, trainer, rec, phases, moved_prefixes, expected=None):
    """What every CPC-SAM run of the smoke must show: the phases of its
    steps, the derived launches in each (``expected`` by phase, default
    ``STEP_LAUNCHES``), finite losses, the trainable tensors under
    ``moved_prefixes`` moved and the frozen encoder bit-identical."""
    expected = expected or STEP_LAUNCHES
    check([s[0] for s in rec["steps"]] == phases, f"phases of the steps: {[s[0] for s in rec['steps']]}")
    for phase, _, per_step, _ in rec["steps"]:
        check(per_step == expected[phase],
              f"phase-{phase} step launched {per_step}, expected {expected[phase]}")
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



# ---------------------------------------------------------------------------
# CPC-SAM in bfloat16: the trainer's defaults with --compute-dtype bfloat16
# ---------------------------------------------------------------------------

# bfloat16 launches of one step of either phase (the float32 ones are STEP_LAUNCHES'); the
# step launches no float32 instance of K2-K4b
BF16_STEP_LAUNCHES = {"K2": 8, "K2b": 8, "K3": 4, "K3b": 4, "K4": 8, "K4b": 7}
# card against the CPU in training, module by module: every module call inside encoder blocks 0
# (windowed) and 2 (global) of the trained bfloat16 model, on the inputs the CPU's copy of the
# block gives it (the block's own input taken from the card's forward), forward and backward for
# a seeded bfloat16 cotangent, on the card's bfloat16 module, the CPU's, and the card's float32
# one (inputs widened). The Linears, the LayerNorms and K4 (norm1 + partition): output, input
# cotangent and LoRA gradients at least BF16_TRAIN_LEAF_EQUAL bit-equal to the CPU's (cuBLAS sums
# in another order than the CPU: about one output in 2000 rounds the other way). The MLP, the
# attention kernel's forward (K2 / K3 against the plain bfloat16 version on the CPU block's own
# qkv and rel operands) and its backward alone (K2b / K3b on the plain forward's output and
# log-sum-exp, so both sides start from the same forward): ||card - CPU|| / ||CPU|| under
# BF16_TRAIN_SHARES of the float32 version's (the float32 module; for the kernels the plain
# float32 forward and VJP of the widened operands). What composes them, the attention core
# (forward and backward on each side's own forward) and the Attention module, carries the
# forward kernel's other rounding of P (it rounds the unnormalised P) into its backward; they,
# and the whole block, are printed and held to BF16_WHOLE_SANITY times the float32 distance.
# Read on an H100: Linears >= 0.9984 bit-equal, LayerNorms and K4 1.0; shares MLP 0.083,
# attention forward 0.55, backward alone 0.059 (99.68% bit-equal); attention core 0.96,
# Attention module 0.68, whole blocks 0.51-0.82
BF16_TRAIN_LEAF_EQUAL = 0.995
BF16_TRAIN_SHARES = {"MLPBlock": 0.25, "attention forward": 0.75, "attention backward": 0.2}
BF16_TRAIN_LEAVES = ("Linear", "LayerNorm", "K4")
BF16_TRAIN_COMPOSED = ("attention core", "Attention")


def bf16_train_replay(torch, fn, inputs, blocks, device, gen):
    """``fn(block, *inputs)`` forward and backward on the CPU's bfloat16
    block, the card's and the card's float32 one, for one seeded bfloat16
    cotangent → {target: {"output": y, "dx": input cotangents concatenated,
    "LoRA grads": LoRA gradients concatenated}} (empty where there are none),
    each on the CPU in float32."""
    out, g = {}, None
    for key, dev, dtype in (("cpu", "cpu", None), ("card", device, None), ("f32", device, torch.float32)):
        xs = [t.to(dev, dtype or t.dtype).requires_grad_() if torch.is_tensor(t)
              and t.is_floating_point() else t for t in inputs]
        y = fn(blocks[key], *xs)
        if g is None:
            g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
        lora = [p for _, p in sorted(blocks[key].named_parameters()) if p.requires_grad]
        leaves = [t for t in xs if torch.is_tensor(t) and t.requires_grad]
        grads = torch.autograd.grad(y, leaves + lora, g.to(dev, y.dtype), allow_unused=True)

        def cat(ts):
            return torch.cat([t.detach().flatten().float().cpu() for t in ts if t is not None]
                             or [torch.zeros(0)])

        out[key] = {"output": y.detach().float().cpu().flatten(), "dx": cat(grads[:len(leaves)]),
                    "LoRA grads": cat(grads[len(leaves):])}
    return out


def _float32_block(torch, blk, x, device):
    """The card's float32 block of ``blk``'s weights, with its trainable set."""
    from mia_tpu_torch.models.sam.image_encoder import Block

    attn = blk.attn
    blk32 = Block(x.shape[-1], attn.num_heads, attn.window_size, (x.shape[1], x.shape[2]),
                  lora_rank=attn.lora_rank).to(device)
    blk32.load_state_dict(blk.state_dict())
    trainable = {n for n, p in blk.named_parameters() if p.requires_grad}
    for n, p in blk32.named_parameters():
        p.requires_grad_(n in trainable)
    return blk32


def bf16_train_module_holds(torch, np, blocks, x, device, gen):
    """The module calls of one encoder block (``blocks``: the CPU's copy,
    the card's and its float32 one; ``x`` its input) replayed as the comment
    above says → {(kind, what): [least share bit-equal to the CPU, largest
    ||card - CPU|| / ||CPU||, least of the float32 module's share and
    distance]}."""
    from mia_tpu_torch.models.sam import image_encoder
    from mia_tpu_torch.ops.ln_window import ln_window_partition_fused

    cpu = blocks["cpu"]
    calls, core = [], []
    hooks = [m.register_forward_hook(
        lambda m, args, kwargs, out, name=name: calls.append(
            (type(m).__name__, name, [a.detach().clone() if torch.is_tensor(a) else a for a in args],
             kwargs)), with_kwargs=True)
        for name, m in cpu.named_modules()
        if type(m).__name__ in ("Linear", "LayerNorm", "Attention", "MLPBlock")]
    attend = cpu.attn._attend
    cpu.attn._attend = lambda qkv, hw, route: (core.append((qkv.detach().clone(), hw, route)),
                                               attend(qkv, hw, route))[1]
    fused, names = [], ("fused_attention_rel_packed", "fused_attention_rel_packed_ik")
    originals = {n: getattr(image_encoder, n) for n in names}
    for n in names:
        setattr(image_encoder, n, lambda qkv, a, b, *cfg, n=n: (
            fused.append((n, [t.detach().clone() for t in (qkv, a, b)], cfg)),
            originals[n](qkv, a, b, *cfg))[1])
    try:
        with torch.no_grad():
            cpu(x.cpu())
    finally:
        for n in names:
            setattr(image_encoder, n, originals[n])
        for h in hooks:
            h.remove()
        del cpu.attn._attend
    replays = [(kind, lambda b, *xs, name=name, kwargs=kwargs:
                dict(b.named_modules())[name](*xs, **kwargs), args)
               for kind, name, args, kwargs in calls]
    qkv, hw, route = core[0]
    replays.append(("attention core", lambda b, t: b.attn._attend(t, hw, route), [qkv]))
    if cpu.use_lnw:
        replays.append(("K4", lambda b, t: ln_window_partition_fused(
            t, b.norm1.weight, b.norm1.bias, b.window_size, b.norm1.eps), [x.cpu()]))
    worst = {}
    results = [(kind, bf16_train_replay(torch, fn, inputs, blocks, device, gen))
               for kind, fn, inputs in replays]
    results += bf16_attention_kernel_replays(torch, fused[0], device, gen)
    for kind, res in results:
        for what, want in res["cpu"].items():
            got, got32 = res["card"][what], res["f32"][what]
            check(got.shape == want.shape == got32.shape,
                  f"bf16 training replay {kind} {what}: {got.shape} / {want.shape} / {got32.shape}")
            if not want.numel() or not want.norm():
                continue
            equal = float((got == want).float().mean())
            equal32 = float((got32.to(torch.bfloat16).float() == want).float().mean())
            entry = worst.setdefault((kind, what), [1.0, 0.0, 1.0, float("inf")])
            worst[(kind, what)] = [min(entry[0], equal), max(entry[1], frob_rel(np, got, want)),
                                   min(entry[2], equal32), min(entry[3], frob_rel(np, got32, want))]
    return worst


def bf16_attention_kernel_replays(torch, call, device, gen):
    """The block's attention kernel on the CPU block's own operands
    (``call``: the name of the fused op, ``(qkv, rel_a, rel_b)`` and its
    configuration): the forward (K2 / K3 on the card, the plain bfloat16
    version on the CPU, the plain float32 one of the widened operands) and
    the backward alone, on the CPU's plain forward's output and log-sum-exp
    (K2b / K3b on the card, the plain bfloat16 VJP on the CPU, the plain
    float32 VJP) → [(kind, {target: {"output" / "dx": tensor}})] as
    ``bf16_train_replay`` gives them."""
    from mia_tpu_torch.ops import attention

    name, (qkv, rel_a, rel_b), (scale, k_hw, heads) = call
    windowed = name.endswith("_ik")
    rel = attention.window_rel_terms(qkv, rel_a, rel_b, k_hw, heads) if windowed else (rel_a, rel_b)
    out, lse = attention.attention_rel_packed_bf16(qkv, *rel, scale, k_hw, heads)
    g = torch.randn(out.shape, generator=gen).to(torch.bfloat16)
    wide = [t.float() for t in (qkv, rel_a, rel_b)]
    card = [t.to(device) for t in (qkv, rel_a, rel_b, out, g, lse)]
    launch = attention._launch_k2 if windowed else attention._launch_k3
    if windowed:
        back = (attention.attention_rel_packed_ik_bwd_bf16(qkv, rel_a, rel_b, out, g, lse, scale,
                                                           k_hw, heads, False)[:1],
                attention.fused_attention_rel_packed_ik_bwd(*card, scale, k_hw, heads, False)[:1],
                attention.attention_rel_packed_ik_bwd(*wide, out.float(), g.float(), scale, k_hw,
                                                      heads, False)[:1])
        plain32 = attention.attention_rel_packed_ik(*wide, scale, k_hw, heads)
    else:
        back = (attention.attention_rel_packed_bwd_bf16(qkv, rel_a, rel_b, out, g, lse, scale,
                                                        k_hw, heads),
                attention.fused_attention_rel_packed_bwd(*card, scale, k_hw, heads),
                attention.attention_rel_packed_bwd(*wide, out.float(), g.float(), scale, k_hw, heads))
        plain32 = attention.attention_rel_packed(*wide, scale, k_hw, heads)
    forward = {"cpu": out, "card": launch(*card[:3], scale, k_hw, heads), "f32": plain32}
    torch.cuda.synchronize()

    def flat(ts):
        return torch.cat([t.detach().flatten().float().cpu() for t in ts])

    return [("attention forward", {k: {"output": flat([v])} for k, v in forward.items()}),
            ("attention backward", {k: {"dx": flat(v)} for k, v in zip(("cpu", "card", "f32"), back)})]


def bf16_block_holds(torch, model, images, device):
    """Encoder blocks 0 (windowed) and 2 (global) of the trained bfloat16
    model, on the inputs the card's forward gave them for ``images``: module
    by module (``bf16_train_module_holds``) and whole (the block's output,
    input cotangent and LoRA gradients on the card against the same block on
    the CPU, beside the card's float32 block's distance to that CPU block)
    → ({(kind, what): module readings}, {block: {what: (bfloat16 distance,
    float32 distance)}})."""
    import copy

    import numpy as np

    enc = model.image_encoder
    captured = {}
    hooks = [enc.blocks[i].register_forward_hook(
        lambda mod, args, out, i=i: captured.__setitem__(i, args[0].detach())) for i in (0, 2)]
    with torch.no_grad():
        model.get_image_embeddings(images)
    for h in hooks:
        h.remove()
    gen = torch.Generator().manual_seed(9)
    modules, whole = {}, {}
    for i in (0, 2):
        blk, x = enc.blocks[i], captured[i]
        blocks = {"cpu": copy.deepcopy(blk).cpu(), "card": blk,
                  "f32": _float32_block(torch, blk, x, device)}
        for key, v in bf16_train_module_holds(torch, np, blocks, x, device, gen).items():
            old = modules.get(key, [1.0, 0.0, 1.0, float("inf")])
            modules[key] = [min(old[0], v[0]), max(old[1], v[1]), min(old[2], v[2]),
                            min(old[3], v[3])]
        res = bf16_train_replay(torch, lambda b, t: b(t), [x], blocks, device, gen)
        torch.cuda.synchronize()
        whole[f"block {i} ({'global' if blk.attn.window_size == 0 else 'windowed'})"] = {
            what: (frob_rel(np, res["card"][what], w), frob_rel(np, res["f32"][what], w))
            for what, w in res["cpu"].items()}
    return modules, whole


def cpcsam_bf16_phase(torch, device, workdir: Path, datasets, f32):
    """``cpcsam_train_torch``'s defaults with ``--compute-dtype bfloat16`` for
    2 phase-1 and 2 phase-2 steps on the CPC-SAM phase's in-memory ACDC set:
    exactly the bfloat16 launches of ``BF16_STEP_LAUNCHES`` a step and no
    float32 instance of K2-K4b, finite losses, the LoRA tensors moved and
    the frozen encoder bit-identical, float32 parameters and a float32
    ``lora.msgpack`` with the float32 run's keys, the validation and the
    real test of the bfloat16 model; step ms and peak memory beside the
    float32 phase's; two blocks on the card against the CPU
    (``bf16_block_holds``)."""
    import numpy as np

    from mia_tpu_torch.models.sam.lora import read_lora_checkpoint

    argv = ["--data-path", str(workdir / "acdc"), "--device", "cuda", "--lr-warmup-iter", "1",
            "--quiet", "--work-path", str(workdir / "work_bf16"), "--compute-dtype", "bfloat16",
            "--warmup-iter", "2", "--min-iter", "4", "--max-iter", "4", "--valid-freq-iter", "4"]
    trainer, rec = run_cpcsam(torch, device, datasets, argv)
    model = trainer.model
    bf = torch.bfloat16
    enc = model.image_encoder
    check(len(enc.blocks) == 12 and enc.blocks[0].attn.qkv.in_features == 768
          and model.num_decoders == 3 and trainer.config.batch_size == 12
          and trainer.config.labeled_batch_size == 6,
          "not the LoRA ViT-B/512 SamDualmask at batch 12 (6 labeled)")
    check(enc.compute_dtype == bf and all(d.compute_dtype == bf for d in model.mask_decoders),
          "cpcsam_train_torch --compute-dtype bfloat16 did not build a bfloat16 model")
    check(all(p.dtype == torch.float32 and p.device.type == "cuda" for p in model.parameters()),
          "bfloat16 CPC-SAM parameters are not float32 on the card")
    no_float32 = {ph: {**STEP_LAUNCHES[ph], **{k: 0 for k in BF16_STEP_LAUNCHES}} for ph in (1, 2)}
    check_cpcsam_steps(torch, trainer, rec, [1, 1, 2, 2], (), expected=no_float32)
    for i, per_step in enumerate(rec["bf16_steps"]):
        check(per_step == BF16_STEP_LAUNCHES,
              f"bfloat16 step {i} launched {per_step}, expected {BF16_STEP_LAUNCHES}")
    work = trainer.work_path
    log = (work / "log.txt").read_text()
    check(log.count("Valid results") == 1 and "Real test results" in log,
          "the bfloat16 model's validation (iteration 4) or real test did not run")
    lora = read_lora_checkpoint(work / "final_model" / "lora.msgpack")
    f32_lora = read_lora_checkpoint(f32["log"].parent / "final_model" / "lora.msgpack")
    check(set(lora) == set(f32_lora) and all(v.dtype == torch.float32 for v in lora.values()),
          "the bfloat16 run's lora.msgpack is not the float32 run's layout in float32")

    train_set = datasets["train"]
    images = torch.from_numpy(np.stack([np.repeat(train_set.images[i][..., None], 3, -1)
                                        for i in (0, 40)])).to(device)
    modules, blocks = bf16_block_holds(torch, model, images, device)
    print("cpcsam bf16: modules of encoder blocks 0 and 2 in training, on the CPU block's inputs, "
          "card against CPU (least share bit-equal, largest ||card - CPU|| / ||CPU||; the float32 "
          "module's): " + ", ".join(f"{k} {w} {v[0]:.4f} / {v[1]:.3g} ({v[2]:.4f} / {v[3]:.3g})"
                                    for (k, w), v in sorted(modules.items())))
    print("cpcsam bf16: blocks on the card against the CPU on the card's inputs, ||card - CPU|| "
          "/ ||CPU||, bfloat16 / float32 card: " + "; ".join(
              f"{n}: " + ", ".join(f"{w} {a:.3g} / {b:.3g}" for w, (a, b) in d.items())
              for n, d in blocks.items()))
    kinds = {k for k, _ in modules}
    check(kinds == set(BF16_TRAIN_LEAVES + BF16_TRAIN_COMPOSED + tuple(BF16_TRAIN_SHARES)),
          f"bfloat16 training module holds covered {sorted(kinds)}")
    check(("Linear", "LoRA grads") in modules and ("Attention", "LoRA grads") in modules,
          "no LoRA gradient among the bfloat16 training module holds")
    for (kind, what), (equal, err, equal32, err32) in modules.items():
        if kind in BF16_TRAIN_LEAVES:
            check(equal >= BF16_TRAIN_LEAF_EQUAL,
                  f"bfloat16 {kind} {what} card vs CPU: {equal} bit-equal < {BF16_TRAIN_LEAF_EQUAL}")
        else:
            share = BF16_TRAIN_SHARES.get(kind, BF16_WHOLE_SANITY)
            check(err <= share * err32, f"bfloat16 {kind} {what} card vs CPU {err:.3g}, not under "
                  f"{share} x the float32 version's {err32:.3g}")
    check(modules[("Linear", "output")][2] < BF16_TRAIN_LEAF_EQUAL,
          "a float32 Linear rounded to bfloat16 is as bit-equal to the CPU's as the bfloat16 one")
    for name, dists in blocks.items():
        for what, (d16, d32) in dists.items():
            check(d16 <= BF16_WHOLE_SANITY * d32,
                  f"bfloat16 {name} {what}: card vs CPU {d16:.3g} > {BF16_WHOLE_SANITY} x the "
                  f"float32 block's {d32:.3g}")

    steps = rec["steps"]
    med = {ph: statistics.median(s[1] for s in steps if s[0] == ph) * 1e3 for ph in (1, 2)}
    print(f"cpcsam bf16: --compute-dtype bfloat16, {len(steps)} steps (2 + 2): step ms "
          f"{[round(s[1] * 1e3, 2) for s in steps]}; median phase 1 {med[1]:.2f} ms, phase 2 "
          f"{med[2]:.2f} ms, float32 phase {f32['phase1_step_ms']:.2f} / {f32['phase2_step_ms']:.2f} "
          f"ms; max_memory_allocated {rec['peak'] / 2**30:.2f} GiB, float32 "
          f"{f32['max_memory_allocated'] / 2**30:.2f} GiB")
    print(f"cpcsam bf16: bfloat16 launches a step {BF16_STEP_LAUNCHES} and no float32 K2-K4b; "
          f"in the run {rec['bf16_launches']}; losses first {rec['losses'][0]} last "
          f"{rec['losses'][-1]}; 48 LoRA tensors moved, frozen encoder bit-identical; lora.msgpack "
          "float32 in the float32 run's layout")
    return {"launches": rec["bf16_launches"], "phase1_step_ms": med[1], "phase2_step_ms": med[2],
            "max_memory_allocated": rec["peak"], "losses": rec["losses"],
            "blocks_card_vs_cpu": {n: {w: list(v) for w, v in d.items()} for n, d in blocks.items()},
            "modules_card_vs_cpu": {f"{k} {w}": v for (k, w), v in modules.items()}}


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
                "bf16": {**timed("K2-K4 bfloat16", bf16_kernel_phase, torch, device),
                         **timed("K2b-K4b bfloat16", bf16_train_kernel_phase, torch, device)},
                **timed("K2b-K4b, K5", train_kernel_phase, torch, device),
                **timed("K6-K9", route_kernel_phase, torch, device),
                **timed("K6b, K8b, K9b", route_bwd_kernel_phase, torch, device),
                **timed("K10, K10b", upsample_kernel_phase, torch, device)}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        sl = timed("AL slice", slice_phase, torch, Path(tmp))
        sel = timed("AL selectors", selector_phase, torch, device, Path(tmp), sl)
        demo = timed("demo and checkpoints", demo_phase, torch, device, Path(tmp), sl)
        del sl["trainer"], sl["saved"]
        warmer = timed("pool-cache warmer", warmer_phase, torch, Path(tmp), sl)
        bf16_al = timed("AL bfloat16", bf16_al_phase, torch, Path(tmp), sl)
        fugc = timed("FUGC K-fold", fugc_phase, torch, device, Path(tmp))
        acdc_th = timed("ACDC and thyroid", acdc_thyroid_phase, torch, device, Path(tmp), sl)
        cpc, cpc_trainer, acdc = timed("CPC-SAM", cpcsam_phase, torch, device, Path(tmp))
        route_train = timed("route training", route_train_phase, torch, device, cpc_trainer, acdc)
        del cpc_trainer
        bf16_cpc = timed("CPC-SAM bfloat16", cpcsam_bf16_phase, torch, device, Path(tmp), acdc, cpc)
        del acdc
        if args.out is not None:
            args.out.mkdir(parents=True, exist_ok=True)
            shutil.copy(sl["log"], args.out / "chip_smoke_train_log.txt")
            shutil.copy(cpc["log"], args.out / "chip_smoke_cpcsam_log.txt")
            shutil.copy(fugc["log"], args.out / "chip_smoke_fugc_log.txt")
    sam, model, cpu_model = timed("SAM serving", sam_phase, torch, device)
    bf16_sam = timed("SAM serving bfloat16", bf16_serving_phase, torch, device, model, cpu_model)
    serving_k10 = timed("K10 serving", upscaler_serving_phase, torch, device, model)
    routes = timed("encoder routes", route_phase, torch, device, model)
    amg = timed("AMG", amg_phase, torch, device, model, cpu_model)
    del cpu_model
    unet3d = timed("3D UNet, losses, export", unet3d_loss_export_phase, torch, device, model)
    print(f"seconds by phase: build {build_s:.1f}, {seconds}")
    # each path ran with every count set to 0 just before it: K1 from the
    # AL slice, the selector phase's runs, the warmer phase's runs and the demo phase's
    # grayscale run (the demo itself launches none; nor does the 3D UNet, losses and
    # export phase, which checks it), K2-K4 forward from SAM serving, CPC-SAM training, the encoder
    # routes and AMG, the backward kernels of K2-K4 and K5 from CPC-SAM
    # training, K6-K9 from the encoder routes and, with K6b, K8b and K9b, from
    # route training, K8 from AMG on the grid-native encoder too; K1 also from the FUGC
    # K-fold trainer, K10 and K10b from that trainer with the decoder's option on, from
    # route training (the prompt-large upscalers) and K10 from SAM serving; the bfloat16
    # instances from their own phases (below)
    launches = {k: sum(path["launches"].get(k, 0)
                       for path in (sam, cpc, route_train, routes, amg, fugc, serving_k10, demo))
                for k in KERNELS}
    launches["K1"] += sl["launches"] + sel["launches"] + warmer["launches"] + bf16_al["launches"]
    for k in KERNELS:
        check(launches[k] > 0, f"{k} was launched on no path")
    # the bfloat16 instances of K2, K3 and K4, from SAM serving in bfloat16
    # the bfloat16 instances: K2-K4 from SAM serving and CPC-SAM training in bfloat16, K2b-K4b
    # from CPC-SAM training in bfloat16
    bf16 = {k: {"launches": bf16_sam["launches"].get(k, 0) + bf16_cpc["launches"][k],
                **measured["bf16"][k]} for k in BF16_KERNELS}
    for k, entry in bf16.items():
        check(entry["launches"] > 0, f"{k} in bfloat16 was launched on no path")
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
        **({"bf16": bf16[key]} if key in bf16 else {}),
    } for key, (name, source, replaces) in KERNELS.items()]}
    keys = {"launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    for entry in kernels["kernels"]:
        check(keys <= set(entry), f"{entry['name']}: kernels line lacks {keys - set(entry)}")
        if "bf16" in entry:
            check(keys <= set(entry["bf16"]),
                  f"{entry['name']} bf16: kernels line lacks {keys - set(entry['bf16'])}")
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
                        "bf16": {"sam": {k: v for k, v in bf16_sam.items() if k != "launches"},
                                 "al": {k: v for k, v in bf16_al.items() if k != "launches"},
                                 "cpcsam": {k: v for k, v in bf16_cpc.items() if k != "launches"}},
                        "routes": routes["set_image_ms"],
                        "amg": {k: v for k, v in amg.items() if k != "launches"},
                        "selectors": {k: v for k, v in sel.items() if k != "launches"},
                        "demo": {k: v for k, v in demo.items() if k != "launches"},
                        "cpcsam": {k: v for k, v in cpc.items() if k not in ("launches", "log")},
                        "route_training": route_train["routes"],
                        "fugc": {k: v for k, v in fugc.items() if k not in ("launches", "log")},
                        "acdc_thyroid": {k: v for k, v in acdc_th.items() if k != "launches"},
                        "k10_serving": {k: v for k, v in serving_k10.items() if k != "launches"},
                        "slice": {"wire_bytes": sl["wire_bytes"], "spans": sl["spans"],
                                  "step_ms": sl["step_ms"]},
                        "warmer": {k: v for k, v in warmer.items() if k != "launches"},
                        "unet3d_losses_export": unet3d,
                        "seconds": {"build": build_s, **seconds},
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
