"""Where the PyTorch port's CPC-SAM train step spends its time on one GPU.

LoRA-4 ViT-B/512 ``SamDualmask`` (3 decoders, 3 classes) with seeded random
weights, batch 12 (6 labeled) of seeded blob images, ``--promptmode
point``, the port's float32 setting (TF32 convolutions, full-float32
matmuls). For phase 1 and phase 2 it prints the median step time (host
clock around ``CPCSAMTrainer.train_step`` ending in a synchronise), the
peak memory, and a ``torch.profiler`` table of device time per step by
kernel group: the hand-written kernels (forward and backward), the cuBLAS
GEMMs, the cuDNN convolutions and the rest. ``--variant`` trains through
another route of the encoder (K9 exit, grid-native K8, head-major K6, no
rel-pos K7), ``--use-contrastive-loss`` and ``--use-adv-loss`` switch the
auxiliary losses on (both phases then run the whole batch),
``--compute-dtype bfloat16`` trains the model in bfloat16 (the bfloat16
instances of K2-K4b; default route only). Needs a CUDA device.

    python scripts/profile_torch_cpcsam.py [--steps 10] [--profiled 3]
        [--variant default|k9|grid_native|head_major|no_rel_pos]
        [--use-contrastive-loss] [--use-adv-loss] [--compute-dtype bfloat16]
"""

from __future__ import annotations

import argparse
import logging
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mia_tpu_torch.models.sam import ImageEncoderViT  # noqa: E402
from mia_tpu_torch.training.cpcsam_trainer import CPCSAMTrainer  # noqa: E402

GROUPS = (  # (label, substrings of the kernel name), first match wins
    # attention_fwd_tc_kernel<D, bias, keys> (3xTF32): bias 0 = K2, 1 = K3, and K6, which
    # runs K3's instance, 2 = K7 (dense), 3 = K8 (windows of the token grid);
    # attention_bwd_tc_{dq,dkv}_kernel<D, tables, window>: <true, false> = K2b,
    # <false, false> = K3b, and K6b, which runs K3b's instance (see
    # head_major_groups), <false, true> = K8b
    ("K2 forward", ("attention_fwd_tc_kernel<64, 0,",)),
    ("K3 forward", ("attention_fwd_tc_kernel<64, 1,",)),
    ("K7 forward", ("attention_fwd_tc_kernel<64, 2,",)),
    ("K8 forward", ("attention_fwd_tc_kernel<64, 3,",)),
    ("K2 backward, dq pass", ("attention_bwd_tc_dq_kernel<64, true",)),
    ("K3 backward, dq pass", ("attention_bwd_tc_dq_kernel<64, false, false",)),
    ("K8 backward, dq pass", ("attention_bwd_tc_dq_kernel<64, false, true",)),
    ("K2 backward, dk/dv pass", ("attention_bwd_tc_dkv_kernel<64, true",)),
    ("K3 backward, dk/dv pass", ("attention_bwd_tc_dkv_kernel<64, false, false",)),
    ("K8 backward, dk/dv pass and pad reduce", ("attention_bwd_tc_dkv_kernel<64, false, true",
                                                "attention_bwd_pad_reduce_kernel")),
    ("K2 backward, table pass", ("attention_rel_bwd_tables_kernel",)),
    ("K2 rel terms (forward and backward) and routing", ("attention_rel_terms_kernel",
                                                         "attention_rel_route_kernel")),
    # the bfloat16 instances (--compute-dtype bfloat16): attention_fwd_bf16_kernel<D, tables,
    # keys> and attention_bwd_bf16_{dq,dkv}_kernel<D, tables>, tables = K2 / K2b
    ("K2 forward, bfloat16", ("attention_fwd_bf16_kernel<64, true",)),
    ("K3 forward, bfloat16", ("attention_fwd_bf16_kernel<64, false",)),
    ("K2 backward, bfloat16", ("attention_bwd_bf16_dq_kernel<64, true",
                               "attention_bwd_bf16_dkv_kernel<64, true")),
    ("K3 backward, bfloat16", ("attention_bwd_bf16_dq_kernel<64, false",
                               "attention_bwd_bf16_dkv_kernel<64, false")),
    ("K4 backward", ("ln_window_partition_bwd_kernel", "ln_window_partition_params")),
    ("K4 forward", ("ln_window_partition_kernel",)),
    ("K9 backward", ("unpartition_add_ln_bwd_kernel", "unpartition_add_ln_params")),
    ("K9 forward", ("unpartition_add_ln_kernel",)),
    ("K5 connected components", ("connected_components_kernel",)),
    ("cuDNN convolutions", ("fprop", "dgrad", "wgrad", "implicit", "cudnn", "conv")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "kernel2")),
)


def head_major_groups(groups):
    """The head-major route runs K6 in every block, so the tensor-core
    instances that K3 and K6, K3b and K6b share time K6 and K6b there."""
    return tuple((label.replace("K3 ", "K6 "), keys) for label, keys in groups)


VARIANTS = {  # the encoder's options by route (see models/sam/image_encoder.py)
    "default": {},
    "k9": dict(fuse_unpart_residual="always"),
    "grid_native": dict(fuse_ln_window="never", attn_route="grid_native"),
    "head_major": dict(attn_route="head_major"),
    "no_rel_pos": dict(use_rel_pos=False),
}


def with_encoder(model, lora_rank, **options):
    """Replace ``model``'s LoRA ViT-B/512 image encoder by one built with
    ``options``, loaded with the same weights (bar absent rel-pos tables)."""
    old = model.image_encoder
    new = ImageEncoderViT(img_size=512, patch_size=16, embed_dim=768, depth=12, num_heads=12,
                          out_chans=256, window_size=14, global_attn_indexes=(2, 5, 8, 11),
                          lora_rank=lora_rank, **options).to(old.pos_embed.device)
    new.load_state_dict({k: v for k, v in old.state_dict().items()
                         if options.get("use_rel_pos", True) or "rel_pos" not in k})
    model.image_encoder = new
    return model


def blob_batch(n=12, size=512, seed=0):
    """Seeded images (0-255) with three ellipse classes, and their labels."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    labels = np.zeros((n, size, size), np.int64)
    for i in range(n):
        for c in (1, 2, 3):
            cy, cx = rng.uniform(0.3, 0.7, 2) * size
            ry, rx = rng.uniform(0.05, 0.15, 2) * size
            labels[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = c
    images = np.clip(40.0 + 50.0 * labels + rng.normal(0.0, 12.0, labels.shape), 0, 255)
    return {"image": np.repeat(images.astype(np.float32)[..., None], 3, -1), "label": labels}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=10, help="timed steps per phase")
    parser.add_argument("--profiled", type=int, default=3, help="profiled steps per phase")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="default",
                        help="the encoder route to train through")
    parser.add_argument("--use-contrastive-loss", action="store_true")
    parser.add_argument("--use-adv-loss", action="store_true")
    parser.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_cpcsam: needs a CUDA device")
    if args.compute_dtype != "float32" and args.variant != "default":
        sys.exit("profile_torch_cpcsam: bfloat16 trains on the default route only")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)

    trainer = CPCSAMTrainer(device="cuda", config=dict(
        image_size=512, num_classes=3, batch_size=12, labeled_batch_ratio=0.5, lora_rank=4,
        promptmode=["point"], optimizer_name="adam", max_iter=10**6, lr_warmup_iter=1,
        use_contrastive_loss=args.use_contrastive_loss, use_adv_loss=args.use_adv_loss,
        compute_dtype=args.compute_dtype))
    trainer.logger = logging.getLogger("profile_torch_cpcsam")
    trainer.epoch_train_outputs = []
    trainer._build_model()
    if args.variant != "default":
        with_encoder(trainer.model, trainer.config.lora_rank, **VARIANTS[args.variant])
    print(f"encoder variant {args.variant}; contrastive loss {args.use_contrastive_loss}, "
          f"VAT {args.use_adv_loss}; compute dtype {args.compute_dtype}")
    trainer._setup_loss()
    trainer._setup_optimizer()
    batch = blob_batch()
    batch = {k: torch.as_tensor(v, device=trainer.device) for k, v in batch.items()}

    from torch.profiler import ProfilerActivity, profile

    for phase in (1, 2):
        trainer.config.warmup_iter = 10**9 if phase == 1 else 0

        def step():
            trainer.train_step(batch)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_ms = statistics.median(times) * 1e3
        peak = torch.cuda.max_memory_allocated() / 2**30
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(args.profiled):
                step()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        per = args.profiled
        total = sum(e.self_device_time_total for e in kernels) / 1e3 / per
        print(f"phase {phase}: step median {step_ms:.2f} ms ({12 / step_ms * 1e3:.1f} img/s, "
              f"median of {args.steps}); kernel time {total:.2f} ms per step, so the card "
              f"idles {1 - total / step_ms:.1%} of the step; max_memory_allocated {peak:.2f} GiB")
        groups = head_major_groups(GROUPS) if args.variant == "head_major" else GROUPS
        grouped = {group: [0.0, 0] for group, _ in groups}
        grouped["other (elementwise, reductions, copies, Adam)"] = [0.0, 0]
        for e in kernels:
            name = e.key.lower()
            group = next((g for g, keys in groups if any(k.lower() in name for k in keys)),
                         "other (elementwise, reductions, copies, Adam)")
            grouped[group][0] += e.self_device_time_total / 1e3 / per
            grouped[group][1] += e.count // per
        print(f"phase {phase} by group (ms per step, share of kernel time, launches per step):")
        for group, (ms, count) in grouped.items():
            print(f"  {ms:9.3f} {ms / total:6.1%} {count:6d}  {group}")
        print(f"phase {phase} by kernel (top 12):")
        for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]:
            ms = e.self_device_time_total / 1e3 / per
            print(f"  {ms:9.3f} {ms / total:6.1%} {e.count // per:6d}  {e.key[:100]}")


if __name__ == "__main__":
    main()
