"""Weight bridge between flax and torch for SAM.

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

``sam_state_dict_to_flax(sd)`` goes the other way, to a flax ``params``
tree, through its own table (``_INVERSE``, torch module path → flax module
path) rather than by reversing ``_RENAMES``: Linear weights transposed back,
conv weights OIHW → HWIO, the upscaler's taps flipped back, a ``.weight``
leaf named ``kernel``, ``scale`` (flax ``LayerNorm``/``BatchNorm``:
``norm{k}``, ``norm_final_attn``, ``bn``), ``weight`` (the ``LayerNorm2d``
of the neck, the mask downscaling and the upscaler) or after its table,
the plain prompt encoder's four ``point_embeddings.{i}`` merged into one
``(4, C)`` table. Buffers that flax does not keep (BatchNorm running
statistics) are refused; leave them out of ``sd``.
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


# torch module path → flax module path, applied in order to the dotted name
_INVERSE = (
    (r"^image_encoder\.blocks\.(\d+)\.", r"image_encoder.block\1."),
    (r"^image_encoder\.patch_embed\.proj\.", "image_encoder.patch_embed."),
    (r"^image_encoder\.neck\.0\.", "image_encoder.neck_conv1."),
    (r"^image_encoder\.neck\.1\.", "image_encoder.neck_norm1."),
    (r"^image_encoder\.neck\.2\.", "image_encoder.neck_conv2."),
    (r"^image_encoder\.neck\.3\.", "image_encoder.neck_norm2."),
    (r"\.mask_downscaling\.0\.", ".mask_downscaling.conv1."),
    (r"\.mask_downscaling\.1\.", ".mask_downscaling.norm1."),
    (r"\.mask_downscaling\.3\.", ".mask_downscaling.conv2."),
    (r"\.mask_downscaling\.4\.", ".mask_downscaling.norm2."),
    (r"\.mask_downscaling\.6\.", ".mask_downscaling.conv3."),
    (r"^(mask_decoder\d*)\.transformer\.layers\.(\d+)\.", r"\1.transformer.layer\2."),
    (r"\.output_upscaling\.(\d+)\.",
     lambda m: f".output_upscaling.{'norm' if int(m[1]) % 3 else 'up'}{int(m[1]) // 3}."),
    (r"\.output_hypernetworks_mlps\.(\d+)\.", r".hyper_mlp\1."),
    (r"\.iou_prediction_head\.", ".iou_head."),
    (r"\.layers\.(\d+)\.", r".layers_\1."),
    (r"^(mask_decoder\d*)\.(?!transformer\.)", r"\1.core."),
)
_TABLES = ("iou_token", "mask_tokens", "not_a_point_embed", "no_mask_embed",
           "box_corner_embeddings", "point_embeddings")
_LAYER_NORM_2D = r"(neck_norm\d|mask_downscaling\.norm\d|output_upscaling\.norm\d+)$"
_SCALED = r"(^|\.)(norm\d|norm_final_attn|bn)$"


def _flax_leaf(module: str, leaf: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """Flax path and value of the torch leaf ``leaf`` of flax module ``module``."""
    if leaf != "weight":
        return f"{module}.{leaf}", value
    if module.rsplit(".", 1)[-1] in _TABLES:
        return module, value
    if re.search(_LAYER_NORM_2D, module):
        return f"{module}.weight", value
    if re.search(_SCALED, module):
        return f"{module}.scale", value
    if value.ndim == 2:  # Linear
        return f"{module}.kernel", value.T
    if ".output_upscaling.up" in module:  # transposed conv, taps flipped back
        return f"{module}.kernel", value.transpose(2, 3, 0, 1)[::-1, ::-1]
    return f"{module}.kernel", value.transpose(2, 3, 1, 0)  # conv OIHW → HWIO


def sam_state_dict_to_flax(sd: Mapping[str, torch.Tensor]) -> dict:
    """Reference-named SAM state dict (or a subset of it) → flax ``params`` tree."""
    sd = dict(sd)
    points = sorted((k for k in sd
                     if re.fullmatch(r"prompt_encoder\.point_embeddings\.\d+\.weight", k)),
                    key=lambda k: int(k.split(".")[2]))
    if points:
        sd["prompt_encoder.point_embeddings.weight"] = torch.cat([sd.pop(k) for k in points])
    params: dict = {}
    for name, tensor in sd.items():
        if name.endswith(("running_mean", "running_var", "num_batches_tracked")):
            raise KeyError(f"{name}: flax keeps no BatchNorm running statistics in its params")
        module, leaf = name.rsplit(".", 1)
        module += "."  # the table's patterns end at a dot
        for pattern, repl in _INVERSE:
            module = re.sub(pattern, repl, module)
        module = module[:-1]
        path, value = _flax_leaf(module, leaf, tensor.detach().cpu().numpy())
        node = params
        *parents, last = path.split(".")
        for part in parents:
            node = node.setdefault(part, {})
        node[last] = np.array(value, order="C", copy=True)
    return params
