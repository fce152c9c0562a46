"""Weight bridge flax → torch for SAM.

``sam_state_dict_from_flax(variables)`` turns the JAX ``Sam``'s or
``SamDualmask``'s params (numpy arrays) into a state dict under the
reference SAM parameter names, loadable by
:class:`mia_tpu_torch.models.sam.Sam` or ``SamDualmask`` with
``strict=True``:

- Dense kernel ``(in, out)`` → Linear weight ``(out, in)``;
- Conv kernel HWIO → weight OIHW; the patch embed's ``(P, P, C, D)``
  kernel → ``patch_embed.proj.weight`` ``(D, C, P, P)``;
- the upscaler's transposed-conv kernel ``(2, 2, I, O)`` → weight
  ``(I, O, 2, 2)``, spatially flipped (``y[2i+di] = x·K[1-di]`` in the JAX
  package, ``x·W[di]`` in torch);
- an encoder built with ``use_rel_pos=False`` has no ``rel_pos_h``/``rel_pos_w``
  leaves and yields no such entries, matching the port's encoder of the
  same option;
- LayerNorm ``scale`` → ``weight``; token and prompt tables → Embedding
  weights (the plain prompt encoder's ``point_embeddings`` ``(4, C)`` →
  four ``(1, C)``; the class prompt encoder keeps one ``(4, C)`` table);
- ``SamDualmask``'s decoders ``mask_decoder{i}``, 4-stage upscalers
  (``up{k}`` → ``output_upscaling.{3k}``, ``norm{k}`` → ``.{3k+1}``), LoRA
  adapters and contrastive heads (``bn/scale`` → ``bn.weight``).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

# flax path (after "/"-joining) → reference module path, applied in order
_RENAMES = (
    (r"^image_encoder/block(\d+)/", r"image_encoder/blocks/\1/"),
    (r"^image_encoder/patch_embed/", "image_encoder/patch_embed/proj/"),
    (r"^image_encoder/neck_conv1/", "image_encoder/neck/0/"),
    (r"^image_encoder/neck_norm1/", "image_encoder/neck/1/"),
    (r"^image_encoder/neck_conv2/", "image_encoder/neck/2/"),
    (r"^image_encoder/neck_norm2/", "image_encoder/neck/3/"),
    (r"/mask_downscaling/conv1/", "/mask_downscaling/0/"),
    (r"/mask_downscaling/norm1/", "/mask_downscaling/1/"),
    (r"/mask_downscaling/conv2/", "/mask_downscaling/3/"),
    (r"/mask_downscaling/norm2/", "/mask_downscaling/4/"),
    (r"/mask_downscaling/conv3/", "/mask_downscaling/6/"),
    (r"^(mask_decoder\d*)/core/", r"\1/"),
    (r"/output_upscaling/up(\d+)/", lambda m: f"/output_upscaling/{3 * int(m[1])}/"),
    (r"/output_upscaling/norm(\d+)/", lambda m: f"/output_upscaling/{3 * int(m[1]) + 1}/"),
    (r"/hyper_mlp(\d+)/", r"/output_hypernetworks_mlps/\1/"),
    (r"/iou_head/", "/iou_prediction_head/"),
    (r"/layers_(\d+)/", r"/layers/\1/"),
    (r"^(mask_decoder\d*)/transformer/layer(\d+)/", r"\1/transformer/layers/\2/"),
    (r"/(iou_token|mask_tokens|not_a_point_embed|no_mask_embed|box_corner_embeddings)$",
     r"/\1/weight"),
    (r"^prompt_encoder/point_embeddings$", "prompt_encoder/point_embeddings/weight"),
    (r"/scale$", "/weight"),
)


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v, np.float32)
    return out


def _convert(path: str, leaf: np.ndarray) -> np.ndarray:
    if not path.endswith("/kernel"):
        return leaf
    if leaf.ndim == 2:  # Dense
        return leaf.T
    if "/output_upscaling/" in path:  # transposed conv, taps flipped
        return leaf[::-1, ::-1].transpose(2, 3, 0, 1)
    return leaf.transpose(3, 2, 0, 1)  # conv HWIO → OIHW


def sam_state_dict_from_flax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """Flax ``Sam``/``SamDualmask`` variables (``{"params": ...}``) →
    reference-named state dict."""
    sd: dict[str, torch.Tensor] = {}
    flat = _flatten(variables["params"])
    class_prompts = "prompt_encoder/box_corner_embeddings" in flat
    for path, leaf in flat.items():
        leaf = _convert(path, leaf)
        if path == "prompt_encoder/point_embeddings" and not class_prompts:
            for i in range(leaf.shape[0]):
                sd[f"prompt_encoder.point_embeddings.{i}.weight"] = torch.tensor(leaf[i: i + 1])
            continue
        name = re.sub(r"/kernel$", "/weight", path)
        for pattern, repl in _RENAMES:
            name = re.sub(pattern, repl, name)
        sd[name.replace("/", ".")] = torch.tensor(np.ascontiguousarray(leaf))
    return sd
