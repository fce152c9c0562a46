"""SAM prompt encoders (counterpart of ``mia_tpu/models/sam/prompt_encoder.py``):
the plain ``PromptEncoder`` and CPC-SAM's class-indexed
``PromptEncoderPromptClass``. Channel-last: the dense embedding is
``(B, H, W, C)``. Parameters carry the reference names
(``point_embeddings.{i}.weight``, ``mask_downscaling.{0,1,3,4,6}``, the
``pe_layer.positional_encoding_gaussian_matrix`` buffer)."""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import LayerNorm2d


class PositionEmbeddingRandom(nn.Module):
    """Positional encoding with random spatial frequencies."""

    def __init__(self, num_pos_feats: int):
        super().__init__()
        self.register_buffer("positional_encoding_gaussian_matrix", torch.randn(2, num_pos_feats))

    def _pe_encoding(self, coords: torch.Tensor) -> torch.Tensor:
        coords = 2 * coords - 1
        coords = 2 * math.pi * (coords.to(torch.float32) @ self.positional_encoding_gaussian_matrix)
        return torch.cat([coords.sin(), coords.cos()], dim=-1)

    def forward(self, size: Tuple[int, int]) -> torch.Tensor:
        """Dense grid encoding, ``(H, W, C)``."""
        h, w = size
        dev = self.positional_encoding_gaussian_matrix.device
        y = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        x = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        grid = torch.stack([x[None, :].expand(h, w), y[:, None].expand(h, w)], dim=-1)
        return self._pe_encoding(grid)

    def forward_with_coords(self, coords: torch.Tensor, image_size: Tuple[int, int]) -> torch.Tensor:
        coords = coords.to(torch.float32)
        coords = torch.stack([coords[..., 0] / image_size[1], coords[..., 1] / image_size[0]], -1)
        return self._pe_encoding(coords)


class _MaskDownscaling(nn.Sequential):
    """4x mask downscaler: (B, 4H, 4W, 1) → (B, H, W, embed_dim)."""

    def __init__(self, mask_in_chans: int, embed_dim: int):
        super().__init__(
            nn.Conv2d(1, mask_in_chans // 4, 2, stride=2),
            LayerNorm2d(mask_in_chans // 4),
            nn.GELU(),
            nn.Conv2d(mask_in_chans // 4, mask_in_chans, 2, stride=2),
            LayerNorm2d(mask_in_chans),
            nn.GELU(),
            nn.Conv2d(mask_in_chans, embed_dim, 1),
        )

    def forward(self, masks: torch.Tensor) -> torch.Tensor:
        conv1, norm1, _, conv2, norm2, _, conv3 = self
        x = norm1(conv1(masks.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        x = F.gelu(x)
        x = norm2(conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        x = F.gelu(x)
        return conv3(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class PromptEncoder(nn.Module):
    """Points, boxes and mask prompts → sparse ``(B, N, C)`` and dense
    ``(B, H, W, C)`` embeddings."""

    def __init__(self, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int], mask_in_chans: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.image_embedding_size = tuple(image_embedding_size)
        self.input_image_size = tuple(input_image_size)
        self.pe_layer = PositionEmbeddingRandom(embed_dim // 2)
        self.point_embeddings = nn.ModuleList(nn.Embedding(1, embed_dim) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, embed_dim)
        self.mask_downscaling = _MaskDownscaling(mask_in_chans, embed_dim)
        self.no_mask_embed = nn.Embedding(1, embed_dim)

    def get_dense_pe(self) -> torch.Tensor:
        """(1, H, W, C) dense positional encoding of the embedding grid."""
        return self.pe_layer(self.image_embedding_size)[None]

    def _embed_points(self, points, labels, pad: bool):
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros(points.shape[0], 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(labels.shape[0], 1)], dim=1)
        pe = self.pe_layer.forward_with_coords(points, self.input_image_size)
        pe = torch.where((labels == -1)[..., None], self.not_a_point_embed.weight[0], pe)
        pe = pe + torch.where((labels == 0)[..., None], self.point_embeddings[0].weight[0], 0.0)
        return pe + torch.where((labels == 1)[..., None], self.point_embeddings[1].weight[0], 0.0)

    def _embed_boxes(self, boxes):
        coords = (boxes + 0.5).reshape(-1, 2, 2)
        pe = self.pe_layer.forward_with_coords(coords, self.input_image_size)
        corners = torch.cat([self.point_embeddings[2].weight, self.point_embeddings[3].weight])
        return pe + corners

    def forward(self, points=None, boxes=None, masks=None):
        if points is not None:
            bs, device = points[0].shape[0], points[0].device
        elif boxes is not None:
            bs, device = boxes.shape[0], boxes.device
        elif masks is not None:
            bs, device = masks.shape[0], masks.device
        else:
            bs, device = 1, self.no_mask_embed.weight.device
        sparse = torch.empty((bs, 0, self.embed_dim), device=device)
        if points is not None:
            coords, labels = points
            sparse = torch.cat([sparse, self._embed_points(coords, labels, pad=boxes is None)], 1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(boxes).reshape(bs, -1, self.embed_dim)], 1)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(bs, h, w, self.embed_dim)
        return sparse, dense


class PromptEncoderPromptClass(PromptEncoder):
    """Class-indexed prompt encoder: per-class learned point embeddings
    (``point_embeddings.weight`` ``(num_classes, C)``) and per-class box
    corner embeddings (``box_corner_embeddings.weight`` ``(2·num_classes, C)``),
    selected by the prompt labels. Boxes arrive as ``(coords (B, N, 2, 2),
    labels (B, N))``."""

    def __init__(self, embed_dim: int, image_embedding_size: Tuple[int, int],
                 input_image_size: Tuple[int, int], mask_in_chans: int, num_classes: int = 4):
        super().__init__(embed_dim, image_embedding_size, input_image_size, mask_in_chans)
        self.num_classes = num_classes
        self.point_embeddings = nn.Embedding(num_classes, embed_dim)
        self.box_corner_embeddings = nn.Embedding(2 * num_classes, embed_dim)

    def _embed_points(self, points, labels, pad: bool):
        points = points + 0.5
        if pad:
            points = torch.cat([points, points.new_zeros(points.shape[0], 1, 2)], dim=1)
            labels = torch.cat([labels, -labels.new_ones(labels.shape[0], 1)], dim=1)
        pe = self.pe_layer.forward_with_coords(points, self.input_image_size)
        invalid = (labels == -1)[..., None]
        pe = torch.where(invalid, self.not_a_point_embed.weight[0], pe)
        class_add = self.point_embeddings.weight[labels.clamp(0, self.num_classes - 1).long()]
        return pe + torch.where(invalid, 0.0, class_add)

    def _embed_boxes(self, boxes, labels):
        b, n = boxes.shape[:2]
        pe = self.pe_layer.forward_with_coords((boxes + 0.5).reshape(b, n * 2, 2),
                                               self.input_image_size)
        corners = self.box_corner_embeddings.weight
        add = torch.stack([corners[: self.num_classes][labels.long()],
                           corners[self.num_classes:][labels.long()]], dim=2)
        return (pe.reshape(b, n, 2, -1) + add).reshape(b, n * 2, -1)

    def forward(self, points=None, boxes=None, masks=None):
        if points is not None:
            bs, device = points[0].shape[0], points[0].device
        elif boxes is not None:
            bs, device = boxes[0].shape[0], boxes[0].device
        elif masks is not None:
            bs, device = masks.shape[0], masks.device
        else:
            bs, device = 1, self.no_mask_embed.weight.device
        sparse = torch.empty((bs, 0, self.embed_dim), device=device)
        if points is not None:
            coords, labels = points
            sparse = torch.cat([sparse, self._embed_points(coords, labels, pad=boxes is None)], 1)
        if boxes is not None:
            sparse = torch.cat([sparse, self._embed_boxes(*boxes)], 1)
        if masks is not None:
            dense = self.mask_downscaling(masks)
        else:
            h, w = self.image_embedding_size
            dense = self.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(bs, h, w, self.embed_dim)
        return sparse, dense
