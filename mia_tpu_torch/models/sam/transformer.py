"""TwoWayTransformer (counterpart of ``mia_tpu/models/sam/transformer.py``):
sparse tokens self-attend and cross-attend to the image tokens both ways,
with a downsampled internal attention width. Image embeddings are
channel-last ``(B, H, W, C)`` and flatten to ``(B, HW, C)``. LayerNorms
follow flax's arithmetic (eps 1e-5). ``compute_dtype`` is flax's ``dtype``:
the Linears and the LayerNorms' outputs in it, the attention scores and
softmax in float32, the probabilities cast to v's dtype before P·V, which
sums in float32."""

from __future__ import annotations

import math

import torch
from torch import nn

from .common import LayerNorm, linear

DOWNSAMPLE = 2  # internal width divisor of the cross-attention layers


class Attention(nn.Module):
    """Attention with an optional downsampled internal width."""

    def __init__(self, embedding_dim: int, num_heads: int, downsample_rate: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.internal_dim = embedding_dim // downsample_rate
        self.num_heads = num_heads
        self.compute_dtype = compute_dtype
        self.q_proj = linear(embedding_dim, self.internal_dim, compute_dtype=compute_dtype)
        self.k_proj = linear(embedding_dim, self.internal_dim, compute_dtype=compute_dtype)
        self.v_proj = linear(embedding_dim, self.internal_dim, compute_dtype=compute_dtype)
        self.out_proj = linear(self.internal_dim, embedding_dim, compute_dtype=compute_dtype)

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        return x.view(b, n, self.num_heads, c // self.num_heads).transpose(1, 2)

    def forward(self, q, k, v):
        q = self._heads(self.q_proj(q))
        k = self._heads(self.k_proj(k))
        v = self._heads(self.v_proj(v))
        attn = (q.float() @ k.float().transpose(-2, -1)) / math.sqrt(q.shape[-1])
        out = (attn.softmax(-1).to(v.dtype).float() @ v.float()).to(self.compute_dtype)
        b, h, n, c = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, n, h * c))


class MLPReLU(nn.Module):
    """The transformer's MLP: Linear → ReLU → Linear."""

    def __init__(self, embedding_dim: int, mlp_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lin1 = linear(embedding_dim, mlp_dim, compute_dtype=compute_dtype)
        self.lin2 = linear(mlp_dim, embedding_dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.lin2(torch.relu(self.lin1(x)))


class TwoWayAttentionBlock(nn.Module):
    """(1) sparse self-attention, (2) sparse → image cross-attention,
    (3) MLP, (4) image → sparse cross-attention."""

    def __init__(self, embedding_dim: int, num_heads: int, mlp_dim: int,
                 skip_first_layer_pe: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        dt = compute_dtype
        self.skip_first_layer_pe = skip_first_layer_pe
        self.self_attn = Attention(embedding_dim, num_heads, compute_dtype=dt)
        self.norm1 = LayerNorm(embedding_dim, 1e-5, dt)
        self.cross_attn_token_to_image = Attention(embedding_dim, num_heads, DOWNSAMPLE, dt)
        self.norm2 = LayerNorm(embedding_dim, 1e-5, dt)
        self.mlp = MLPReLU(embedding_dim, mlp_dim, dt)
        self.norm3 = LayerNorm(embedding_dim, 1e-5, dt)
        self.norm4 = LayerNorm(embedding_dim, 1e-5, dt)
        self.cross_attn_image_to_token = Attention(embedding_dim, num_heads, DOWNSAMPLE, dt)

    def forward(self, queries, keys, query_pe, key_pe):
        if self.skip_first_layer_pe:
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = self.norm1(queries)

        q, k = queries + query_pe, keys + key_pe
        queries = self.norm2(queries + self.cross_attn_token_to_image(q, k, keys))
        queries = self.norm3(queries + self.mlp(queries))

        q, k = queries + query_pe, keys + key_pe
        keys = self.norm4(keys + self.cross_attn_image_to_token(k, q, queries))
        return queries, keys


class TwoWayTransformer(nn.Module):
    def __init__(self, depth: int, embedding_dim: int, num_heads: int, mlp_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.ModuleList(
            TwoWayAttentionBlock(embedding_dim, num_heads, mlp_dim, skip_first_layer_pe=(i == 0),
                                 compute_dtype=compute_dtype)
            for i in range(depth)
        )
        self.final_attn_token_to_image = Attention(embedding_dim, num_heads, DOWNSAMPLE,
                                                   compute_dtype)
        self.norm_final_attn = LayerNorm(embedding_dim, 1e-5, compute_dtype)

    def forward(self, image_embedding, image_pe, point_embedding):
        """image_embedding, image_pe ``(B, H, W, C)``; point_embedding
        ``(B, N, C)`` → (queries ``(B, N, C)``, keys ``(B, HW, C)``)."""
        b, h, w, c = image_embedding.shape
        keys = image_embedding.reshape(b, h * w, c)
        key_pe = image_pe.reshape(image_pe.shape[0], h * w, c)
        queries = point_embedding
        for layer in self.layers:
            queries, keys = layer(queries, keys, point_embedding, key_pe)
        q, k = queries + point_embedding, keys + key_pe
        queries = self.norm_final_attn(queries + self.final_attn_token_to_image(q, k, keys))
        return queries, keys
