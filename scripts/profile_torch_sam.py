"""Where the PyTorch port's SAM serving spends its time on one GPU.

ViT-B/512 ``SamPredictor`` with seeded random weights, a 480x640 uint8 frame
(input 512x384, padded), the port's float32 setting (TF32 convolutions,
full-float32 matmuls). Prints the median ``set_image`` and ``predict``
times and a ``torch.profiler`` table of device time by kernel for
``set_image``, with the hand-written kernels (K2-K4, K6-K9), the cuDNN
convolutions and the cuBLAS GEMMs summed into groups, and the share of the
profiled window in which the card ran no kernel. ``--variant`` picks the
encoder's route; ``--amg`` profiles one ``SamAutomaticMaskGenerator.generate``
(32x32 points in chunks of 64 on a 512x512 frame) instead of ``set_image``.
``--compute-dtype bfloat16`` builds the model in bfloat16 (float32 weights
cast at each call; any route), whose kernels are the bfloat16 instances; ``--compare`` then also times the float32 model on the same
weights, in turns (float32, bfloat16, bfloat16, float32). Needs a CUDA
device.

    python scripts/profile_torch_sam.py [--variant default|k9|grid_native|head_major|no_rel_pos]
                                        [--compute-dtype float32|bfloat16] [--compare]
                                        [--amg] [--runs 5] [--trace trace.json]
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mia_tpu_torch.device import set_compute_precision  # noqa: E402
from mia_tpu_torch.models.sam import (  # noqa: E402
    ImageEncoderViT,
    SamAutomaticMaskGenerator,
    SamPredictor,
    sam_model_registry,
)

# K2, K3, K6, K7 and K8 run the tensor-core template of csrc/attention_fwd_tc.cuh,
# attention_fwd_tc_kernel<D, bias, keys>: bias 0 = K2 (after kernel R,
# attention_rel_terms_kernel), 1 = K3, and K6, which runs K3's instance on head-major
# strides (the head-major route runs no K3: HEAD_MAJOR_GROUPS), 2 = K7 (dense bias), 3 = K8
# (windows carved from the token grid); keys is the streamed key tile. In bfloat16 every
# kind runs attention_fwd_bf16_kernel<D, bias, keys> (the same bias numbers) and K2's
# kernel R its bfloat16 instance
GROUPS = (  # (label, substrings of the kernel name), first match wins
    ("K2 windowed attention", ("attention_fwd_tc_kernel<64, 0,", "attention_fwd_bf16_kernel<64, 0,",
                               "attention_rel_terms_kernel")),
    ("K3 global attention", ("attention_fwd_tc_kernel<64, 1,", "attention_fwd_bf16_kernel<64, 1,")),
    ("K7 dense-bias attention", ("attention_fwd_tc_kernel<64, 2,",
                                 "attention_fwd_bf16_kernel<64, 2,")),
    ("K8 grid-native windowed attention", ("attention_fwd_tc_kernel<64, 3,",
                                           "attention_fwd_bf16_kernel<64, 3,")),
    ("K4 LayerNorm + partition", ("ln_window_partition_kernel",)),
    ("K9 unpartition + residual + LayerNorm", ("unpartition_add_ln_kernel",)),
    ("cuDNN convolutions", ("fprop", "implicit", "cudnn", "conv2d")),
    ("cuBLAS GEMMs", ("gemm", "cutlass", "Kernel2", "nvjet")),
    ("PyTorch elementwise (casts, adds, GELU)", ("elementwise", "copy_kernel")),
)
HEAD_MAJOR_GROUPS = tuple(("K6 head-major attention", keys) if label.startswith("K3") else
                          (label, keys) for label, keys in GROUPS)
VARIANTS = {  # the encoder's options by route (see models/sam/image_encoder.py)
    "default": {},
    "k9": dict(fuse_unpart_residual="always"),
    "grid_native": dict(fuse_ln_window="never", attn_route="grid_native"),
    "head_major": dict(attn_route="head_major"),
    "no_rel_pos": dict(use_rel_pos=False),
}


def with_encoder(model, **options):
    """Replace ``model``'s ViT-B/512 image encoder by one built with
    ``options`` in its compute dtype, loaded with the same weights (bar
    absent rel-pos tables)."""
    old = model.image_encoder
    new = ImageEncoderViT(img_size=512, patch_size=16, embed_dim=768, depth=12, num_heads=12,
                          out_chans=256, window_size=14, global_attn_indexes=(2, 5, 8, 11),
                          compute_dtype=old.compute_dtype, **options).to(old.pos_embed.device)
    new.load_state_dict({k: v for k, v in old.state_dict().items()
                         if options.get("use_rel_pos", True) or "rel_pos" not in k})
    model.image_encoder = new
    return model.eval()


def median_ms(fn, n=20, warmup=3) -> float:
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
    parser.add_argument("--runs", type=int, default=5, help="calls profiled")
    parser.add_argument("--trace", type=Path, default=None, help="chrome trace output")
    parser.add_argument("--variant", choices=sorted(VARIANTS), default="default",
                        help="the encoder's route")
    parser.add_argument("--amg", action="store_true",
                        help="profile SamAutomaticMaskGenerator.generate instead of set_image")
    parser.add_argument("--compute-dtype", choices=("float32", "bfloat16"), default="float32",
                        help="the model's compute dtype")
    parser.add_argument("--compare", action="store_true",
                        help="also time the float32 model on the same weights, in turns")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_torch_sam: needs a CUDA device")

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(card)
    set_compute_precision(args.compute_dtype)
    torch.manual_seed(0)
    model, _ = sam_model_registry["vit_b"](512, 3, device="cuda", compute_dtype=args.compute_dtype)
    if args.variant != "default":
        model = with_encoder(model, **VARIANTS[args.variant])
    predictor = SamPredictor(model.eval())
    print(f"compute dtype {args.compute_dtype}")
    rng = np.random.default_rng(0)
    point, label = np.array([[320.0, 240.0]]), np.array([1])
    if args.compare:
        f32_model, _ = sam_model_registry["vit_b"](512, 3, device="cuda")
        f32_model.load_state_dict(model.state_dict())
        f32 = SamPredictor(f32_model.eval())
        image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        for key, p in (("float32", f32), (args.compute_dtype, predictor),
                       (args.compute_dtype, predictor), ("float32", f32)):
            print(f"{key}: set_image {median_ms(lambda: p.set_image(image)):.3f} ms, predict "
                  f"{median_ms(lambda: p.predict(point_coords=point, point_labels=label)):.3f} ms "
                  "(medians of 20)")
    if args.amg:
        image = rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
        generator = SamAutomaticMaskGenerator(predictor, points_per_side=32, points_per_batch=64)
        what, call = "generate", lambda: generator.generate(image)
        ms = median_ms(call, n=5, warmup=1)
        print(f"encoder variant {args.variant}; generate (32x32 points, 16 chunks of 64, 512x512 "
              f"frame): {ms:.2f} ms (median of 5), {32 * 32 * 3 / ms * 1e3:.0f} candidate masks/s")
    else:
        image = rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
        what, call = "set_image", lambda: predictor.set_image(image)
        print(f"encoder variant {args.variant}; set_image: {median_ms(call):.2f} ms (median of 20)")
        print(f"predict (1 point): "
              f"{median_ms(lambda: predictor.predict(point_coords=point, point_labels=label)):.2f} ms")

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.runs):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.runs
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / args.runs
    # kernels of one stream do not overlap, so the rest of the wall-clock is idle card
    print(f"{what} under the profiler: wall {wall:.3f} ms per call, kernel and copy time "
          f"{total:.3f} ms ({len(kernels)} names), card idle {max(0.0, 1 - total / wall):.1%}")
    groups = HEAD_MAJOR_GROUPS if args.variant == "head_major" else GROUPS
    grouped = {group: [0.0, 0] for group, _ in groups}
    grouped["other"] = [0.0, 0]
    for e in kernels:
        name = e.key.lower()
        group = next((g for g, keys in groups if any(k.lower() in name for k in keys)), "other")
        grouped[group][0] += e.self_device_time_total / 1e3 / args.runs
        grouped[group][1] += e.count // args.runs
    print(f"by group (ms per {what}, share, launches):")
    for group, (ms, count) in grouped.items():
        if count:
            print(f"  {ms:8.3f} {ms / total:6.1%} {count:5d}  {group}")
    print("by kernel (top 15):")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:15]:
        ms = e.self_device_time_total / 1e3 / args.runs
        print(f"  {ms:8.3f} {ms / total:6.1%} {e.count // args.runs:5d}  {e.key[:100]}")
    if args.trace is not None:
        prof.export_chrome_trace(str(args.trace))


if __name__ == "__main__":
    main()
