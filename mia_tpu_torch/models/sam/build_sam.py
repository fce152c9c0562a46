"""SAM registry and reference-checkpoint surgery (counterpart of
``mia_tpu/models/sam/build_sam.py``).

``sam_model_registry[name](image_size, num_classes, checkpoint=None,
lora_rank=0, ...) -> (model, embed_size)`` takes the JAX registry's arguments
(``checkpoint`` is accepted and not read, as there) and builds the module
with PyTorch's initialisers, on the CPU unless ``device`` is given: the plain ``Sam`` for ``vit_b``/``vit_l``/
``vit_h``, and CPC-SAM's ``SamDualmask`` (ViT-B) for
``vit_b_dualmask_same_prompt_class_random_large``. ``compute_dtype``
(``torch.float32`` or ``torch.bfloat16``, or their names) reaches the model
as the JAX registry's does; keywords meant for another entry are accepted
and ignored, as there.

:func:`import_torch_sam_encoder` reads a reference SAM checkpoint's
``image_encoder.*`` weights with the reference's ``load_from`` surgery:
the absolute position embedding resized bilinearly to the token grid, and
the rel-pos tables of the global blocks resized linearly to
``2·tokens − 1`` (window blocks keep theirs).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from ...device import as_compute_dtype
from .sam import Sam, SamDualmask

_VIT_SPECS = {
    "vit_h": dict(embed_dim=1280, depth=32, num_heads=16, global_idx=(7, 15, 23, 31)),
    "vit_l": dict(embed_dim=1024, depth=24, num_heads=16, global_idx=(5, 11, 17, 23)),
    "vit_b": dict(embed_dim=768, depth=12, num_heads=12, global_idx=(2, 5, 8, 11)),
}


def _build_plain(spec_name: str):
    spec = _VIT_SPECS[spec_name]

    def build(image_size, num_classes, checkpoint=None, lora_rank=0, device=None,
              compute_dtype=torch.float32, **kwargs):
        # ``checkpoint`` is accepted and not read, as in the JAX package's registry:
        # weights come in through ``import_torch_sam_encoder`` and ``load_state_dict``
        model = Sam(
            img_size=image_size,
            num_classes=num_classes,
            encoder_embed_dim=spec["embed_dim"],
            encoder_depth=spec["depth"],
            encoder_num_heads=spec["num_heads"],
            encoder_global_attn_indexes=spec["global_idx"],
            lora_rank=lora_rank,
            compute_dtype=as_compute_dtype(compute_dtype),
        )
        return model.to(device) if device is not None else model, image_size // 16

    return build


def build_sam_vit_b_dualmask(image_size, num_classes, checkpoint=None, dropout_rate=0.0,
                             num_points_prompt=(1, 2), bbox_change_rate=(0.1, 0.2), lora_rank=0,
                             device=None, compute_dtype=torch.float32, **kwargs):
    # ``checkpoint`` is accepted and not read, as above: the trainer loads its ``model_ckpt``
    spec = _VIT_SPECS["vit_b"]
    model = SamDualmask(
        img_size=image_size,
        num_classes=num_classes,
        encoder_embed_dim=spec["embed_dim"],
        encoder_depth=spec["depth"],
        encoder_num_heads=spec["num_heads"],
        encoder_global_attn_indexes=spec["global_idx"],
        dropout_rate=dropout_rate,
        num_points_prompt=tuple(num_points_prompt),
        bbox_change_rate=tuple(bbox_change_rate),
        lora_rank=lora_rank,
        compute_dtype=as_compute_dtype(compute_dtype),
    )
    return model.to(device) if device is not None else model, image_size // 16


sam_model_registry = {
    "default": _build_plain("vit_h"),
    "vit_h": _build_plain("vit_h"),
    "vit_l": _build_plain("vit_l"),
    "vit_b": _build_plain("vit_b"),
    "vit_b_dualmask_same_prompt_class_random_large": build_sam_vit_b_dualmask,
}


def _np(v) -> np.ndarray:
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def _interp_linear(x: np.ndarray, new_len: int) -> np.ndarray:
    """``F.interpolate(mode="linear"/"bilinear", align_corners=False)`` on axis 0."""
    n = x.shape[0]
    if n == new_len:
        return x
    pos = (np.arange(new_len) + 0.5) * n / new_len - 0.5
    lo = np.clip(np.floor(pos).astype(int), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    frac = np.clip(pos - lo, 0.0, 1.0).reshape((new_len,) + (1,) * (x.ndim - 1))
    return x[lo] * (1 - frac) + x[hi] * frac


def import_torch_sam_encoder(
    state_dict: Mapping[str, Any],
    depth: int,
    image_size: int,
    patch_size: int = 16,
    global_attn_indexes=(2, 5, 8, 11),
    prefix: str = "image_encoder.",
) -> dict[str, torch.Tensor]:
    """Reference SAM ``image_encoder.*`` weights → an ``ImageEncoderViT``
    state dict (no prefix, no LoRA entries) after the resize surgery."""
    sd = {k[len(prefix):]: _np(v) for k, v in state_dict.items() if k.startswith(prefix)}
    token_size = image_size // patch_size
    out = {k: v for k, v in sd.items()
           if k.startswith(("patch_embed.", "neck.")) or (k.startswith("blocks.")
                                                         and int(k.split(".")[1]) < depth)}
    pos = sd["pos_embed"]  # (1, S, S, C)
    if pos.shape[1] != token_size:
        pos = _interp_linear(pos[0], token_size)
        pos = _interp_linear(pos.transpose(1, 0, 2), token_size).transpose(1, 0, 2)[None]
    out["pos_embed"] = pos
    for i in global_attn_indexes:
        if i >= depth:
            continue
        for name in ("rel_pos_h", "rel_pos_w"):
            key = f"blocks.{i}.attn.{name}"
            out[key] = _interp_linear(sd[key], 2 * token_size - 1)
    return {k: torch.tensor(np.ascontiguousarray(v, np.float32)) for k, v in out.items()}
