"""SAM mask decoders (counterpart of ``mia_tpu/models/sam/mask_decoder.py``):
the plain 2-stage ``MaskDecoder`` and CPC-SAM's 4-stage
``MaskDecoderPromptLarge``. Channel-last; parameters carry the reference
names (``iou_token.weight``, ``output_upscaling.{0,1,3,...}``,
``output_hypernetworks_mlps.{i}.layers.{j}``, ``iou_prediction_head``). The
k2/s2 transposed convolutions are ``EinsumConvTranspose2x`` stages: one GEMM
each by default (the JAX package's ``interleave`` layout), or kernel K10 and
its backward K10b (``ops/upsample2x.py``) on a stage whose ``use_kernel`` is
set to ``"always"``. ``compute_dtype`` is flax's ``dtype``: the Linears,
the upscaler and the mask logits in it (the hypernetwork product sums in
float32), the tokens and the prompt sums as their operands promote."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..unet import EinsumConvTranspose2x
from .common import LayerNorm2d, gelu, linear


class MLP(nn.Module):
    """Three Linear layers with ReLU between them."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dims = (input_dim, hidden_dim, hidden_dim, output_dim)
        self.layers = nn.ModuleList(linear(a, b, compute_dtype=compute_dtype)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = torch.relu(x)
        return x


class _Upscaler(nn.Sequential):
    """k2/s2 transposed-conv stages, each followed by exact GELU: two (4x,
    LayerNorm2d after the first; plain SAM) or four (16x, LayerNorm2d after
    all but the last; prompt-large). Stage widths d/4, d/8 (then d/16, d/16)."""

    def __init__(self, transformer_dim: int, stages: int = 2,
                 compute_dtype: torch.dtype = torch.float32):
        d = transformer_dim
        plan = ([(d // 4, True), (d // 8, False)] if stages == 2 else
                [(d // 4, True), (d // 8, True), (d // 16, True), (d // 16, False)])
        layers, c_in = [], d
        for c_out, norm in plan:
            layers.append(EinsumConvTranspose2x(c_in, c_out, compute_dtype=compute_dtype))
            if norm:
                layers.append(LayerNorm2d(c_out, compute_dtype=compute_dtype))
            layers.append(nn.GELU())
            c_in = c_out
        super().__init__(*layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self:
            if isinstance(layer, nn.GELU):
                x = gelu(x)
            else:
                x = layer(x)
        return x


class _DecoderCore(nn.Module):
    """Tokens, upscaler, hypernetwork MLPs and IoU head; ``predict`` returns
    all mask tokens."""

    def __init__(self, transformer_dim: int, transformer: nn.Module, num_multimask_outputs: int = 3,
                 upscale_stages: int = 2, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.transformer_dim = transformer_dim
        self.transformer = transformer
        self.compute_dtype = compute_dtype
        self.num_mask_tokens = num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, transformer_dim)
        self.mask_tokens = nn.Embedding(self.num_mask_tokens, transformer_dim)
        self.output_upscaling = _Upscaler(transformer_dim, upscale_stages, compute_dtype)
        # the hypernetwork output matches the upscaler's last width
        hyper_out = transformer_dim // (8 if upscale_stages == 2 else 16)
        self.output_hypernetworks_mlps = nn.ModuleList(
            MLP(transformer_dim, transformer_dim, hyper_out, compute_dtype)
            for _ in range(self.num_mask_tokens)
        )
        self.iou_prediction_head = MLP(transformer_dim, 256, self.num_mask_tokens, compute_dtype)

    def predict(self, image_embeddings, image_pe, sparse_prompt, dense_prompt):
        """image_embeddings ``(1 or B, H, W, C)`` → masks ``(B, sH, sW, T)``,
        iou ``(B, T)``, upscaled features ``(B, sH, sW, C')`` (s = 4 or 16)."""
        bs = sparse_prompt.shape[0]
        output_tokens = torch.cat([self.iou_token.weight, self.mask_tokens.weight], dim=0)
        tokens = torch.cat([output_tokens[None].expand(bs, -1, -1), sparse_prompt], dim=1)

        src = image_embeddings + dense_prompt
        b, h, w, c = src.shape
        pos_src = image_pe.expand(b, -1, -1, -1)
        hs, src = self.transformer(src, pos_src, tokens)
        iou_token_out = hs[:, 0, :]
        mask_tokens_out = hs[:, 1: 1 + self.num_mask_tokens, :]

        upscaled = self.output_upscaling(src.reshape(b, h, w, c))
        hyper_in = torch.stack(
            [mlp(mask_tokens_out[:, i, :]) for i, mlp in enumerate(self.output_hypernetworks_mlps)],
            dim=1,
        )
        masks = torch.einsum("btc,bhwc->bhwt", hyper_in.float(), upscaled.float())
        return masks.to(self.compute_dtype), self.iou_prediction_head(iou_token_out), upscaled


class MaskDecoder(_DecoderCore):
    """Plain SAM decoder: multimask output drops token 0, single output keeps it."""

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool):
        masks, iou_pred, _ = self.predict(
            image_embeddings, image_pe, sparse_prompt_embeddings, dense_prompt_embeddings
        )
        mask_slice = slice(1, None) if multimask_output else slice(0, 1)
        return masks[..., mask_slice], iou_pred[:, mask_slice]


class MaskDecoderPromptLarge(_DecoderCore):
    """CPC-SAM decoder: 4-stage upscaler (output at 16x the embedding grid),
    hypernetwork width ``dim // 16``; returns every mask token's logits, the
    IoU predictions and the upscaled dense features."""

    def __init__(self, transformer_dim: int, transformer: nn.Module, num_multimask_outputs: int = 3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(transformer_dim, transformer, num_multimask_outputs, upscale_stages=4,
                         compute_dtype=compute_dtype)

    def forward(self, image_embeddings, image_pe, sparse_prompt_embeddings,
                dense_prompt_embeddings, multimask_output: bool = True):
        return self.predict(image_embeddings, image_pe, sparse_prompt_embeddings,
                            dense_prompt_embeddings)
