"""SAM ViT image encoder (counterpart of ``mia_tpu/models/sam/image_encoder.py``).

Channel-last throughout, parameters under the reference SAM names
(``blocks.{i}.attn.qkv.weight``, ``neck.0.weight``, ...). The port keeps
the JAX package's default path, which is the path its TPU kernels run:

- windowed blocks: ``window_partition(LayerNorm(x))`` is K4
  (``ops/ln_window.py``), the qkv Linear runs on the windowed tokens, and
  K2 (``ops/attention.py``) attends within each window with the rel terms
  computed in the kernel; pad tokens are real keys, as in the reference;
- global blocks: LayerNorm, the qkv Linear, the factored rel terms from
  :func:`decomposed_rel_terms_packed`, then K3;
- the patch embed is a reshape and one matmul (``_PatchEmbedMM``);
- with ``lora_rank > 0`` each block's attention carries rank-r adapters on
  q and v (``lora_a_{q,v}``, ``lora_b_{q,v}``, B zero at init) added to the
  qkv Linear's output slices, as the JAX package's ``Attention(lora_rank)``.

K2, K3 and K4 are differentiable through their backward kernels
(``torch.autograd.Function``s in ``ops/``), so the LoRA-tuned encoder
trains through them.

Relative positions, the absolute position embedding and the qkv bias are
always on, and the MLP is 4x wide, as ``Sam`` builds the encoder. Not
ported: the dense-bias attention of ``use_rel_pos=False`` (K7), shared
window runs, the fused exit kernel (K9) and the grid-native windowed kernel
(K8) — none is on the default path.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...ops.attention import fused_attention_rel_packed, fused_attention_rel_packed_ik
from ...ops.ln_window import ln_window_partition_fused, window_partition
from .common import LayerNorm, LayerNorm2d, MLPBlock

__all__ = [
    "Attention",
    "Block",
    "ImageEncoderViT",
    "decomposed_rel_terms_packed",
    "resize_rel_pos",
    "window_partition",
    "window_unpartition",
]


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw, hw) -> torch.Tensor:
    """(B·nW, ws, ws, C) → (B, H, W, C), dropping the padding."""
    hp, wp = pad_hw
    h, w = hw
    ws = window_size
    b = windows.shape[0] // (hp * wp // ws // ws)
    x = windows.reshape(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _rel_pos_indices(q_size: int, k_size: int) -> np.ndarray:
    """Gather indices into a (2·max(q,k)−1, C) rel-pos table."""
    q_coords = np.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k_coords = np.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel.astype(np.int64)


@functools.lru_cache(maxsize=32)
def _rel_pos_index(q_size: int, k_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rel_pos_indices(q_size, k_size)).to(device)


def resize_rel_pos(rel_pos: torch.Tensor, max_rel_dist: int) -> torch.Tensor:
    """Linear 1-D interpolation of a rel-pos table to a new length
    (``F.interpolate(mode="linear", align_corners=False)``)."""
    n = rel_pos.shape[0]
    if n == max_rel_dist:
        return rel_pos
    pos = (torch.arange(max_rel_dist, device=rel_pos.device) + 0.5) * n / max_rel_dist - 0.5
    lo = pos.floor().clamp(0, n - 1).long()
    hi = (lo + 1).clamp(0, n - 1)
    frac = (pos - lo).clamp(0.0, 1.0)[:, None]
    return rel_pos[lo] * (1 - frac) + rel_pos[hi] * frac


def _rel_table(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """(q_size, k_size, C) gathered rel-pos table."""
    table = resize_rel_pos(rel_pos, 2 * max(q_size, k_size) - 1)
    return table[_rel_pos_index(q_size, k_size, rel_pos.device)]


def decomposed_rel_terms_packed(q4, rel_pos_h, rel_pos_w, q_size, k_size):
    """Factored rel-pos terms from token-major q ``(B, N, heads, C)``, returned
    head-major as ``(B·heads, N, k_h)`` and ``(B·heads, N, k_w)`` for K3."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = _rel_table(rel_pos_h, q_h, k_h)
    rw = _rel_table(rel_pos_w, q_w, k_w)
    b, n, heads, c = q4.shape
    r_q = q4.reshape(b, q_h, q_w, heads, c)
    rel_h = torch.einsum("byxhc,ykc->bhyxk", r_q, rh)
    rel_w = torch.einsum("byxhc,xkc->bhyxk", r_q, rw)
    return rel_h.reshape(b * heads, n, k_h), rel_w.reshape(b * heads, n, k_w)


class Attention(nn.Module):
    """Multi-head attention with decomposed rel-pos, on the packed qkv layout.

    ``window_size > 0``: the input is K4's windowed ``(B·nW, ws, ws, C)``
    tensor with zero pad tokens; the context is unpartitioned to
    ``grid_hw`` before the proj Linear (which commutes with it). Otherwise
    the input is the ``(B, H, W, C)`` grid.
    """

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 window_size: int = 0, lora_rank: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.window_size = window_size
        self.lora_rank = lora_rank
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, self.head_dim))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, self.head_dim))
        if lora_rank > 0:
            self.lora_a_q = nn.Linear(dim, lora_rank, bias=False)
            self.lora_b_q = nn.Linear(lora_rank, dim, bias=False)
            self.lora_a_v = nn.Linear(dim, lora_rank, bias=False)
            self.lora_b_v = nn.Linear(lora_rank, dim, bias=False)
            nn.init.zeros_(self.lora_b_q.weight)
            nn.init.zeros_(self.lora_b_v.weight)

    def _qkv(self, y: torch.Tensor) -> torch.Tensor:
        """``(B', N, C)`` tokens → packed ``(B', N, 3·C)`` qkv, with the LoRA
        terms ``y·A_q·B_q`` and ``y·A_v·B_v`` added to the q and v slices."""
        qkv = self.qkv(y)
        if self.lora_rank == 0:
            return qkv
        dim = y.shape[-1]
        q, k, v = qkv.split(dim, -1)
        return torch.cat([q + self.lora_b_q(self.lora_a_q(y)), k,
                          v + self.lora_b_v(self.lora_a_v(y))], -1)

    def forward(self, x: torch.Tensor, grid_hw: Tuple[int, int] | None = None) -> torch.Tensor:
        bw, h, w, dim = x.shape
        n = h * w
        qkv = self._qkv(x.reshape(bw, n, dim))
        if self.window_size > 0:
            ws = self.window_size
            rh = _rel_table(self.rel_pos_h, ws, ws).reshape(ws * ws, self.head_dim)
            rw = _rel_table(self.rel_pos_w, ws, ws).reshape(ws * ws, self.head_dim)
            out = fused_attention_rel_packed_ik(qkv, rh, rw, self.scale, (h, w), self.num_heads)
            pad_hw = (-(-grid_hw[0] // ws) * ws, -(-grid_hw[1] // ws) * ws)
            out = window_unpartition(out.view(bw, h, w, dim), ws, pad_hw, grid_hw)
        else:
            rel_h, rel_w = decomposed_rel_terms_packed(
                qkv[..., :dim].reshape(bw, n, self.num_heads, self.head_dim),
                self.rel_pos_h, self.rel_pos_w, (h, w), (h, w),
            )
            out = fused_attention_rel_packed(qkv, rel_h, rel_w, self.scale, (h, w), self.num_heads)
            out = out.view(bw, h, w, dim)
        return self.proj(out)


class Block(nn.Module):
    """Transformer block with window or global attention; windowed blocks
    run their first LayerNorm and the partition as K4."""

    def __init__(self, dim: int, num_heads: int, window_size: int, input_size: Tuple[int, int],
                 lora_rank: int = 0):
        super().__init__()
        self.window_size = window_size
        self.norm1 = LayerNorm(dim, 1e-6)
        self.attn = Attention(
            dim, num_heads,
            input_size=input_size if window_size == 0 else (window_size, window_size),
            window_size=window_size, lora_rank=lora_rank,
        )
        self.norm2 = LayerNorm(dim, 1e-6)
        self.mlp = MLPBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.window_size > 0:
            windows = ln_window_partition_fused(
                x, self.norm1.weight, self.norm1.bias, self.window_size, self.norm1.eps
            )
            y = self.attn(windows, grid_hw=(x.shape[1], x.shape[2]))
        else:
            y = self.attn(self.norm1(x))
        x = x + y
        return x + self.mlp(self.norm2(x))


class _PatchEmbedMM(nn.Module):
    """Non-overlapping patch embed as a reshape and one matmul: the same
    contraction as the reference's stride-P convolution, whose parameters
    it keeps under ``proj`` (weight ``(D, C, P, P)``)."""

    def __init__(self, patch: int, in_chans: int, dim: int):
        super().__init__()
        self.patch = patch
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // p, w // p, p * p * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return x @ kernel + self.proj.bias


class ImageEncoderViT(nn.Module):
    """(B, H, W, 3) → (B, H/16, W/16, out_chans) embeddings."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, out_chans: int = 256,
                 window_size: int = 0, global_attn_indexes: Tuple[int, ...] = (),
                 lora_rank: int = 0):
        super().__init__()
        self.img_size = img_size
        side = img_size // patch_size
        self.patch_embed = _PatchEmbedMM(patch_size, 3, embed_dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, side, side, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads,
                  window_size=0 if i in global_attn_indexes else window_size,
                  input_size=(side, side), lora_rank=lora_rank)
            for i in range(depth)
        )
        self.neck = nn.ModuleList([
            nn.Conv2d(embed_dim, out_chans, 1, bias=False),
            LayerNorm2d(out_chans),
            nn.Conv2d(out_chans, out_chans, 3, padding=1, bias=False),
            LayerNorm2d(out_chans),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        conv1, norm1, conv2, norm2 = self.neck
        x = norm1(conv1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return norm2(conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
