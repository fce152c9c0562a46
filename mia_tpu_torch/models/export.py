"""Model export on ``torch.export`` (counterpart of ``mia_tpu/models/export.py``).

A module is traced into an ``ExportedProgram`` with its weights frozen in
and serialised by ``torch.export.save`` (the ``.pt2`` format); loading it
back needs no model code. The JAX package serialises StableHLO instead:
a file exported by one package does not load in the other.

The programs trace the plain PyTorch operators of the module as it stands.
Neither program here reaches a hand kernel: the UNet's forward runs none,
and SAM's decoder upscales through ``EinsumConvTranspose2x`` with
``use_kernel="never"`` (its default), the plain GEMM.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Callable

import torch
import torch.nn as nn

from ..ops.resize import resize


def export_apply(module: nn.Module, *example_args) -> bytes:
    """``torch.export.export(module, example_args)`` saved to ``.pt2`` bytes."""
    program = torch.export.export(module, tuple(example_args))
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    return buffer.getvalue()


def save_exported(path: str | Path, module: nn.Module, *example_args) -> Path:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(export_apply(module, *example_args))
    return path


def load_exported(path_or_bytes) -> Callable:
    """A saved program (a path or its bytes) back as a callable module."""
    data = (path_or_bytes if isinstance(path_or_bytes, (bytes, bytearray))
            else Path(path_or_bytes).read_bytes())
    return torch.export.load(io.BytesIO(data)).module()


def export_unet_forward(model: nn.Module, sample_input: torch.Tensor) -> bytes:
    """A UNet's eval-mode forward ``(B, H, W, C) -> logits`` with its weights
    frozen in; the model's own mode is restored afterwards."""
    was_training = model.training
    model.eval()
    try:
        return export_apply(model, sample_input)
    finally:
        model.train(was_training)


class _SamPromptProgram(nn.Module):
    """SAM's prompt → mask serving program over a precomputed embedding
    (upstream ``SamOnnxModel``'s semantics, as the JAX package's). It holds
    the prompt encoder and the mask decoder alone, so the image encoder's
    weights stay out of the saved program."""

    def __init__(self, sam: nn.Module):
        super().__init__()
        self.prompt_encoder, self.mask_decoder = sam.prompt_encoder, sam.mask_decoder
        self.img_size = sam.img_size

    def forward(self, image_embeddings, point_coords, point_labels, mask_input, has_mask):
        pe = self.prompt_encoder
        pemb = pe.pe_layer.forward_with_coords(point_coords + 0.5, pe.input_image_size)
        lbl = point_labels[..., None]
        pemb = torch.where(lbl == -1, pe.not_a_point_embed.weight[0], pemb)
        for i in range(4):  # 0/1 points, 2/3 box corners
            pemb = pemb + torch.where(lbl == i, pe.point_embeddings[i].weight[0], 0.0)
        gate = has_mask.reshape(-1, 1, 1, 1)
        no_mask = pe.no_mask_embed.weight.reshape(1, 1, 1, -1)
        dense = pe.mask_downscaling(mask_input) * gate + no_mask * (1.0 - gate)
        low_res, iou = self.mask_decoder(image_embeddings, pe.get_dense_pe(), pemb, dense, True)
        masks = resize(low_res, (self.img_size, self.img_size), "bilinear", antialias=False)
        return masks, iou, low_res


def export_sam_prompt_program(sam: nn.Module, max_points: int = 8) -> bytes:
    """A frozen prompt → mask program of a ``Sam`` on the device it lives on.

    Inputs (fixed prompt slots):
    - ``image_embeddings`` ``(1, E, E, 256)`` from ``Sam.get_image_embeddings``;
    - ``point_coords`` ``(1, P, 2)`` in the model's input frame, (x, y);
    - ``point_labels`` ``(1, P)`` int32: -1 pad, 0 negative, 1 positive,
      2 box top-left, 3 box bottom-right;
    - ``mask_input`` ``(1, 4E, 4E, 1)``, a low-res mask prompt;
    - ``has_mask`` ``(1,)``, 1.0 / 0.0: blends the mask prompt's embedding
      with the no-mask one.

    Outputs: masks upscaled to ``(1, img, img, M)``, iou ``(1, M)`` and the
    low-res logits ``(1, 4E, 4E, M)``.
    """
    e = sam.img_size // 16
    device = next(sam.parameters()).device
    was_training = sam.training
    sam.eval()
    example = (
        torch.zeros((1, e, e, 256), device=device),
        torch.zeros((1, max_points, 2), device=device),
        torch.zeros((1, max_points), dtype=torch.int32, device=device),
        torch.zeros((1, 4 * e, 4 * e, 1), device=device),
        torch.zeros((1,), device=device),
    )
    try:
        return export_apply(_SamPromptProgram(sam), *example)
    finally:
        sam.train(was_training)
