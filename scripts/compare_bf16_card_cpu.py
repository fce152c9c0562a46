"""Where the port's bfloat16 SAM on one GPU parts from the same model on the CPU.

The ViT-B/512 ``sam_model_registry["vit_b"](512, 3, compute_dtype=torch.bfloat16)``
with ``chip_smoke.py``'s seeded weights, on its 480x640 frame resized on the
CPU, runs on the CPU (plain bfloat16 K2-K4, oneDNN GEMMs) and on the card in
several settings:

- ``default``: the port as it serves (the bfloat16 K2, K3 and K4 kernels,
  cuBLAS GEMMs with PyTorch's default
  ``allow_bf16_reduced_precision_reduction``);
- ``no reduced reductions``: that flag off;
- ``plain K2-K4``: the encoder's K2, K3 and K4 replaced by their plain
  bfloat16 versions on the card;
- ``both``.

For each it prints the set_image embedding against the CPU's
(``||card - CPU|| / ||CPU||``) and, block by block with each block fed the
CPU block's own input, the block's output against the CPU's: relative
Frobenius norm and the share of elements bit-equal. Then the same for the
bfloat16 against the float32 model on the card (the gap a computation in
float32 would show). With ``--ops`` it goes one level down instead: every
module call inside blocks 0 (windowed) and 2 (global) of the CPU's model
(the Linears, the LayerNorms, the attention, the MLP), replayed on the
card's module of the same name with the CPU call's own inputs, in the
``plain K2-K4`` setting: share bit-equal and largest distance in bfloat16
ulps (the ulp taken at no less than 2^-6 of the largest element). Needs a
CUDA device.

    python scripts/compare_bf16_card_cpu.py [--ops]
"""

from __future__ import annotations

import contextlib
import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import sam_frame  # noqa: E402
from mia_tpu_torch.device import set_compute_precision  # noqa: E402
from mia_tpu_torch.models.sam import SamPredictor, image_encoder, sam_model_registry  # noqa: E402
from mia_tpu_torch.ops import attention, ln_window  # noqa: E402


def frob(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).norm() / b.norm())


def equal_share(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.cpu() == b.cpu()).float().mean())


@contextlib.contextmanager
def setting(reduced: bool, plain: bool):
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    saved = {k: getattr(image_encoder, k) for k in
             ("fused_attention_rel_packed", "fused_attention_rel_packed_ik",
              "ln_window_partition_fused")}
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = reduced
    if plain:
        image_encoder.fused_attention_rel_packed = attention.attention_rel_packed
        image_encoder.fused_attention_rel_packed_ik = attention.attention_rel_packed_ik
        image_encoder.ln_window_partition_fused = ln_window.ln_window_partition
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
        for k, v in saved.items():
            setattr(image_encoder, k, v)


def block_io(model, x):
    """Each encoder block's (input, output) of ``model`` on pixels ``x``."""
    io, hooks = [], []
    for block in model.image_encoder.blocks:
        hooks.append(block.register_forward_hook(
            lambda m, args, out: io.append((args[0].detach().clone(), out.detach().clone()))))
    with torch.inference_mode():
        emb = model.get_image_embeddings(x)
    for h in hooks:
        h.remove()
    return emb, io


def ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    floor = max(b.abs().max().item() * 2.0 ** -6, 2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(b.abs().clamp_min(floor))) - 7)
    return float(((a - b).abs() / ulp).max())


def op_report(cpu16, card16, x) -> None:
    """Each module call inside blocks 0 and 2 of the CPU model, replayed on
    the card's module of the same name."""
    for index in (0, 2):
        cpu_block = cpu16.image_encoder.blocks[index]
        card_modules = dict(card16.image_encoder.blocks[index].named_modules())
        calls, hooks = [], []
        for name, module in cpu_block.named_modules():
            if name:
                hooks.append(module.register_forward_hook(
                    lambda m, args, kwargs, out, name=name: calls.append(
                        (name, [a.clone() if torch.is_tensor(a) else a for a in args], kwargs,
                         out.clone())),
                    with_kwargs=True))
        with torch.inference_mode():
            cpu16.get_image_embeddings(x)
        for h in hooks:
            h.remove()
        seen = set()
        for name, args, kwargs, want in calls:
            if name in seen:
                continue
            seen.add(name)
            with torch.inference_mode():
                got = card_modules[name](*(a.cuda() if torch.is_tensor(a) else a for a in args),
                                         **kwargs)
            print(f"  block {index} {name} ({type(card_modules[name]).__name__}, "
                  f"{tuple(want.shape)} {want.dtype}): {equal_share(got, want):.4f} bit-equal, "
                  f"{ulps(got, want):.3g} ulps, ||card - CPU|| / ||CPU|| {frob(got, want):.3g}")


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("compare_bf16_card_cpu: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"default allow_bf16_reduced_precision_reduction = "
          f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    set_compute_precision("float32")
    torch.manual_seed(0)  # the weights of chip_smoke.py's SAM phases
    cpu32, _ = sam_model_registry["vit_b"](512, 3)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in cpu32.named_parameters():
            if name.endswith(("rel_pos_h", "rel_pos_w")):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
            elif name.endswith("pos_embed"):
                p.copy_(0.02 * torch.randn(p.shape, generator=gen))
    bf = torch.bfloat16
    cpu16, _ = sam_model_registry["vit_b"](512, 3, compute_dtype=bf)
    cpu16.load_state_dict(cpu32.state_dict())
    card16 = copy.deepcopy(cpu16).cuda().eval()
    card32 = copy.deepcopy(cpu32).cuda().eval()
    x = SamPredictor(cpu16)._input_image(sam_frame(np))
    if "--ops" in sys.argv[1:]:
        with setting(True, True):
            print("modules of blocks 0 and 2 on the CPU's inputs, plain K2-K4 on the card:")
            op_report(cpu16, card16, x)
        return 0
    emb_cpu, io_cpu = block_io(cpu16, x)
    print(f"CPU bfloat16 embedding {tuple(emb_cpu.shape)} {emb_cpu.dtype}")
    for label, reduced, plain in (("default", True, False), ("no reduced reductions", False, False),
                                  ("plain K2-K4", True, True), ("both", False, True)):
        with setting(reduced, plain):
            emb, _ = block_io(card16, x.cuda())
            blocks = []
            with torch.inference_mode():
                for block, (inp, out) in zip(card16.image_encoder.blocks, io_cpu):
                    got = block(inp.cuda())
                    blocks.append((frob(got, out), equal_share(got, out)))
        print(f"{label}: embedding card vs CPU {frob(emb, emb_cpu):.4g}; blocks on the CPU's "
              "inputs, ||card - CPU|| / ||CPU|| (share bit-equal): "
              + ", ".join(f"{i}: {f:.3g} ({e:.3f})" for i, (f, e) in enumerate(blocks)))
    emb32, _ = block_io(card32, x.cuda())
    with setting(True, False):
        emb16, _ = block_io(card16, x.cuda())
        blocks = []
        with torch.inference_mode():
            for b16, b32, (inp, _) in zip(card16.image_encoder.blocks, card32.image_encoder.blocks,
                                          io_cpu):
                want = b32(inp.float().cuda())
                blocks.append(frob(b16(inp.cuda()).float(), want))
    print(f"bfloat16 against float32 on the card: embedding {frob(emb16.float(), emb32):.4g}; "
          "blocks on the CPU's bfloat16 inputs: "
          + ", ".join(f"{i}: {f:.3g}" for i, f in enumerate(blocks)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
