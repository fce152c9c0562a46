"""Plain single-decoder SAM (counterpart of ``Sam``, ``preprocess_image`` and
``postprocess_masks`` in ``mia_tpu/models/sam/sam.py``). Channel-last."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resize import resize
from .image_encoder import ImageEncoderViT
from .mask_decoder import MaskDecoder
from .prompt_encoder import PromptEncoder
from .transformer import TwoWayTransformer

PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def preprocess_image(x: torch.Tensor, img_size: int, pixel_mean=PIXEL_MEAN,
                     pixel_std=PIXEL_STD) -> torch.Tensor:
    """Normalise and zero-pad ``(B, H, W, 3)`` to the encoder size."""
    mean = torch.tensor(pixel_mean, dtype=torch.float32, device=x.device)
    std = torch.tensor(pixel_std, dtype=torch.float32, device=x.device)
    x = (x.to(torch.float32) - mean) / std
    h, w = x.shape[1], x.shape[2]
    return F.pad(x, (0, 0, 0, img_size - w, 0, img_size - h))


def postprocess_masks(masks: torch.Tensor, encoder_size: int, input_size,
                      original_size) -> torch.Tensor:
    """Upscale decoder masks to the encoder size, strip the padding, resize
    to the original size (plain bilinear). Channel-last."""
    masks = resize(masks, (encoder_size, encoder_size), "bilinear", antialias=False)
    masks = masks[:, : input_size[0], : input_size[1]]
    return resize(masks, tuple(original_size), "bilinear", antialias=False)


class Sam(nn.Module):
    """ViT image encoder, prompt encoder and one mask decoder; serving runs
    them through :class:`SamPredictor`."""

    def __init__(self, img_size: int = 512, num_classes: int = 3, encoder_embed_dim: int = 768,
                 encoder_depth: int = 12, encoder_num_heads: int = 12,
                 encoder_global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11),
                 mask_threshold: float = 0.0):
        super().__init__()
        embed_dim, patch = 256, 16
        self.img_size = img_size
        self.mask_threshold = mask_threshold
        self.image_encoder = ImageEncoderViT(
            img_size=img_size, patch_size=patch, embed_dim=encoder_embed_dim,
            depth=encoder_depth, num_heads=encoder_num_heads, out_chans=embed_dim,
            window_size=14, global_attn_indexes=tuple(encoder_global_attn_indexes),
        )
        side = img_size // patch
        self.prompt_encoder = PromptEncoder(
            embed_dim=embed_dim, image_embedding_size=(side, side),
            input_image_size=(img_size, img_size), mask_in_chans=16,
        )
        self.mask_decoder = MaskDecoder(
            transformer_dim=embed_dim,
            transformer=TwoWayTransformer(depth=2, embedding_dim=embed_dim, num_heads=8,
                                          mlp_dim=2048),
            num_multimask_outputs=num_classes,
        )

    def get_image_embeddings(self, batched_input: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` pixels (H, W ≤ img_size) → ``(B, S, S, 256)``."""
        return self.image_encoder(preprocess_image(batched_input, self.img_size))
