"""SAM ViT image encoder (counterpart of ``mia_tpu/models/sam/image_encoder.py``).

Channel-last throughout, parameters under the reference SAM names
(``blocks.{i}.attn.qkv.weight``, ``neck.0.weight``, ...). The default path
is the JAX package's default, the path its TPU kernels run:

- windowed blocks: ``window_partition(LayerNorm(x))`` is K4
  (``ops/ln_window.py``), the qkv Linear runs on the windowed tokens, and
  K2 (``ops/attention.py``) attends within each window with the rel terms
  computed from the rel-pos tables on the card; pad tokens are real keys,
  as in the reference;
- global blocks: LayerNorm, the qkv Linear, the factored rel terms from
  :func:`decomposed_rel_terms_packed`, then K3;
- the patch embed is a reshape and one matmul (``_PatchEmbedMM``);
- with ``lora_rank > 0`` each block's attention carries rank-r adapters on
  q and v (``lora_a_{q,v}``, ``lora_b_{q,v}``, B zero at init) added to the
  qkv Linear's output slices, as the JAX package's ``Attention(lora_rank)``.

K2, K3 and K4 are differentiable through their backward kernels
(``torch.autograd.Function``s in ``ops/``), so the LoRA-tuned encoder
trains through them.

The other routes of the JAX encoder are constructor options; parameter
names do not change with the route, so one state dict loads into every
variant (bar the rel-pos tables, absent with ``use_rel_pos=False``):

- ``fuse_ln_window``: ``"auto"``/``"always"`` run K4; ``"never"`` runs a
  LayerNorm and, inside the attention, a plain partition.
- ``attn_route`` (the rel-pos attention's route; the TPU's 128-lane
  predicate that picks the head-major kernel there means nothing on this
  card, so it is explicit here): ``"packed"`` is K2/K3; ``"grid_native"``
  runs K8 in the windowed blocks (the qkv Linear on the **unpadded** grid,
  windows carved in the kernel, pad slots filled with the qkv Linear's
  output for a zero token) and K3 in the global ones, and needs
  ``fuse_ln_window="never"`` (asking for it together with K4 raises at
  construction); ``"head_major"`` runs K6 in every block. Left at None,
  the route is packed, unless ``MIA_WINDOWED_ATTN=1`` is set when the block
  is called **and** the block was built with ``fuse_ln_window="never"``:
  then it is grid-native. While K4 feeds the block the switch does
  nothing, exactly as in the JAX package, so ``Sam`` as it is built never
  reaches K8. On a grid smaller than one window K8 is not taken (as
  ``windowed_attention_available``) and the block partitions for K2.
- ``use_rel_pos=False``: no rel-pos parameters; every block attends with
  K7 on head-major operands and a zero ``(B·H, N, N)`` bias, as the JAX
  encoder hands its dense-bias kernel.
- ``fuse_unpart_residual="always"`` (needs K4): the proj Linear runs on
  the windowed tokens, pad slots included, and K9
  (``ops/unpartition_residual.py``) joins unpartition, residual add and
  norm2.

Every route trains: K6, K8 and K9 are differentiable through their backward
kernels (K6b, K8b, K9b) like K2-K4, and K7 through the plain tensor VJP the
JAX package uses there too. In the grid-native route ``bias_kv`` is the qkv
Linear applied to a zero token, so the pad slots' ``dk`` and ``dv`` reach
``qkv.bias`` through autograd.

The absolute position embedding and the qkv bias are always on, and the MLP
is 4x wide, as ``Sam`` builds the encoder. Not ported: shared window runs
(``share_window_runs``) and the convolutional patch embed
(``patch_embed_mm=False``).

``compute_dtype=torch.bfloat16`` is the JAX encoder's ``dtype``: float32
parameters cast at each call, the residual stream, qkv, the rel terms and
tables, every attention kernel's operands and the embeddings in bfloat16,
the LayerNorms in float32 with bfloat16 outputs. Every route runs in it,
forward and backward, through the bfloat16 instances of its kernels (K2-K4
and K2b-K4b; K6/K6b, K7, K8/K8b, K9/K9b), casting where the JAX encoder
casts: K8's rel terms are bfloat16 einsums on the unpadded grid and its
``bias_kv`` the qkv Linear of a bfloat16 zero token, K6's rel terms those
of the packed route, K7's bias float32 zeros, and K9 joins the bfloat16
windowed proj output and the bfloat16 stream. So the LoRA adapters, the
blocks and the neck train in it through every route.
"""

from __future__ import annotations

import functools
import os
from typing import Tuple

import numpy as np
import torch
from torch import nn

from ...ops.attention import (
    attention_rel_with_padding,
    attention_with_padding,
    fused_attention_rel_packed,
    fused_attention_rel_packed_ik,
    fused_attention_rel_win,
)
from ...ops.ln_window import ln_window_partition_fused, window_partition
from ...ops.unpartition_residual import unpartition_add_ln
from ..layers import Conv2d
from .common import LayerNorm, LayerNorm2d, MLPBlock, linear

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
    # a normal tensor even when first asked for under inference mode (set_image):
    # a later training forward saves it for backward
    with torch.inference_mode(False):
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
    head-major as ``(B·heads, N, k_h)`` and ``(B·heads, N, k_w)`` for K3, in
    q's dtype (the tables cast to it)."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = _rel_table(rel_pos_h, q_h, k_h)
    rw = _rel_table(rel_pos_w, q_w, k_w)
    b, n, heads, c = q4.shape
    r_q = q4.reshape(b, q_h, q_w, heads, c)
    rel_h = torch.einsum("byxhc,ykc->bhyxk", r_q, rh.to(q4.dtype))
    rel_w = torch.einsum("byxhc,xkc->bhyxk", r_q, rw.to(q4.dtype))
    return rel_h.reshape(b * heads, n, k_h), rel_w.reshape(b * heads, n, k_w)


ATTN_ROUTES = ("packed", "grid_native", "head_major")
_FUSE_LN_WINDOW = ("auto", "always", "never")
_FUSE_UNPART = ("always", "never")


def _win_attn_opted_in() -> bool:
    # read at call time, so that toggling MIA_WINDOWED_ATTN after import takes effect
    return os.environ.get("MIA_WINDOWED_ATTN", "0") not in ("0", "", "false")


class Attention(nn.Module):
    """Multi-head attention with decomposed rel-pos (or none), by one of the
    routes of the module docstring.

    ``window_size > 0`` with ``windowed_input``: the input is K4's windowed
    ``(B·nW, ws, ws, C)`` tensor with zero pad tokens; the context is
    unpartitioned to ``grid_hw`` before the proj Linear (which commutes
    with it), unless ``windowed_output``: then proj runs on the windowed
    tokens and the ``(B·nW, ws, ws, C)`` layout is returned for K9 (pad-slot
    rows are garbage the consumer drops). ``window_size > 0`` without
    ``windowed_input``: the input is the normalised ``(B, H, W, C)`` grid
    and the windows are made here (a plain partition, or none with K8).
    ``window_size == 0``: global attention on the grid.
    """

    def __init__(self, dim: int, num_heads: int, input_size: Tuple[int, int],
                 window_size: int = 0, lora_rank: int = 0, use_rel_pos: bool = True,
                 attn_route: str | None = None, windowed_input: bool = True,
                 windowed_output: bool = False, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if attn_route is not None and attn_route not in ATTN_ROUTES:
            raise ValueError(f"attn_route must be one of {ATTN_ROUTES} or None, got {attn_route!r}")
        if attn_route == "grid_native" and window_size > 0 and windowed_input:
            raise ValueError(
                'attn_route="grid_native" carves its windows from the unpartitioned grid and '
                'cannot take the windowed tokens of K4: build it with fuse_ln_window="never"')
        if windowed_output and not (window_size > 0 and windowed_input):
            raise ValueError("windowed_output needs a windowed block fed by K4 (windowed_input)")
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        self.scale = self.head_dim ** -0.5
        self.window_size = window_size
        self.lora_rank = lora_rank
        self.use_rel_pos = use_rel_pos
        self.attn_route = attn_route
        self.windowed_input = windowed_input and window_size > 0
        self.windowed_output = windowed_output
        self.compute_dtype = compute_dtype
        self.qkv = linear(dim, dim * 3, compute_dtype=compute_dtype)
        self.proj = linear(dim, dim, compute_dtype=compute_dtype)
        if use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1, self.head_dim))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1, self.head_dim))
        if lora_rank > 0:
            self.lora_a_q = linear(dim, lora_rank, False, compute_dtype)
            self.lora_b_q = linear(lora_rank, dim, False, compute_dtype)
            self.lora_a_v = linear(dim, lora_rank, False, compute_dtype)
            self.lora_b_v = linear(lora_rank, dim, False, compute_dtype)
            nn.init.zeros_(self.lora_b_q.weight)
            nn.init.zeros_(self.lora_b_v.weight)

    def _qkv(self, y: torch.Tensor) -> torch.Tensor:
        """``(..., C)`` tokens → packed ``(..., 3·C)`` qkv, with the LoRA
        terms ``y·A_q·B_q`` and ``y·A_v·B_v`` added to the q and v slices."""
        qkv = self.qkv(y)
        if self.lora_rank == 0:
            return qkv
        dim = y.shape[-1]
        q, k, v = qkv.split(dim, -1)
        return torch.cat([q + self.lora_b_q(self.lora_a_q(y)), k,
                          v + self.lora_b_v(self.lora_a_v(y))], -1)

    def _route(self) -> str:
        if self.attn_route is not None:
            return self.attn_route
        if self.window_size > 0 and not self.windowed_input and _win_attn_opted_in():
            return "grid_native"
        return "packed"

    def _grid_native(self, x: torch.Tensor) -> torch.Tensor:
        """K8 on the normalised, unpadded ``(B, H, W, C)`` grid → context grid;
        the rel terms are einsums in qkv's dtype, the tables cast to it."""
        b, h, w, dim = x.shape
        ws, heads, hd = self.window_size, self.num_heads, self.head_dim
        qkv = self._qkv(x)
        rh = _rel_table(self.rel_pos_h, ws, ws).to(qkv.dtype)  # (ws, ws, head_dim)
        rw = _rel_table(self.rel_pos_w, ws, ws).to(qkv.dtype)
        ys = torch.arange(h, device=x.device) % ws
        xs = torch.arange(w, device=x.device) % ws
        q5 = qkv[..., :dim].reshape(b, h, w, heads, hd)
        rel_h = torch.einsum("byxhc,ykc->bhyxk", q5, rh[ys]).reshape(b * heads, h, w, ws)
        rel_w = torch.einsum("byxhc,xkc->bhyxk", q5, rw[xs]).reshape(b * heads, h, w, ws)
        # W·0 + b: what a zero pad token would get from the qkv Linear (LoRA adds 0)
        bias_kv = self._qkv(x.new_zeros(1, dim)).reshape(3, dim)
        return fused_attention_rel_win(qkv, rel_h, rel_w, bias_kv, self.scale, ws, heads)

    def _attend(self, qkv: torch.Tensor, hw: Tuple[int, int], route: str) -> torch.Tensor:
        """Packed ``(B', N, 3·C)`` qkv of ``B'`` windows or images with an
        ``hw`` token grid each → context ``(B', N, C)``."""
        bw, n, three_dim = qkv.shape
        dim, heads, hd = three_dim // 3, self.num_heads, self.head_dim
        if self.use_rel_pos and route != "head_major":
            if self.window_size > 0:
                ws = self.window_size
                rh = _rel_table(self.rel_pos_h, ws, ws).reshape(ws * ws, hd).to(qkv.dtype)
                rw = _rel_table(self.rel_pos_w, ws, ws).reshape(ws * ws, hd).to(qkv.dtype)
                return fused_attention_rel_packed_ik(qkv, rh, rw, self.scale, hw, heads)
            rel_h, rel_w = decomposed_rel_terms_packed(
                qkv[..., :dim].reshape(bw, n, heads, hd), self.rel_pos_h, self.rel_pos_w, hw, hw)
            return fused_attention_rel_packed(qkv, rel_h, rel_w, self.scale, hw, heads)
        # head-major operands (B'·H, N, D): K6 with the rel terms, K7 without
        q, k, v = (t.reshape(bw * heads, n, hd)
                   for t in qkv.view(bw, n, 3, heads, hd).permute(2, 0, 3, 1, 4).contiguous())
        if self.use_rel_pos:
            rel_h, rel_w = decomposed_rel_terms_packed(
                qkv[..., :dim].reshape(bw, n, heads, hd), self.rel_pos_h, self.rel_pos_w, hw, hw)
            out = attention_rel_with_padding(q, k, v, rel_h, rel_w, self.scale, hw)
        else:
            # the JAX encoder hands its kernel float32 zeros too, in every dtype
            bias = qkv.new_zeros(bw * heads, n, n, dtype=torch.float32)
            out = attention_with_padding(q, k, v, bias, self.scale)
        return out.view(bw, heads, n, hd).transpose(1, 2).reshape(bw, n, dim)

    def forward(self, x: torch.Tensor, grid_hw: Tuple[int, int] | None = None) -> torch.Tensor:
        ws = self.window_size
        route = self._route()
        if ws > 0 and not self.windowed_input:
            b, h, w, dim = x.shape
            if self.use_rel_pos and route == "grid_native" and h >= ws and w >= ws:
                return self.proj(self._grid_native(x))
            x, _ = window_partition(x, ws)
            grid_hw = (h, w)
        bw, h, w, dim = x.shape
        out = self._attend(self._qkv(x.reshape(bw, h * w, dim)), (h, w), route)
        if ws == 0:
            return self.proj(out.view(bw, h, w, dim))
        if self.windowed_output:
            return self.proj(out).view(bw, h, w, dim)
        pad_hw = (-(-grid_hw[0] // ws) * ws, -(-grid_hw[1] // ws) * ws)
        return self.proj(window_unpartition(out.view(bw, h, w, dim), ws, pad_hw, grid_hw))


class Block(nn.Module):
    """Transformer block with window or global attention. Windowed blocks
    run their first LayerNorm and the partition as K4 unless
    ``fuse_ln_window="never"``, and with ``fuse_unpart_residual="always"``
    their exit (unpartition, residual add, norm2) as K9."""

    def __init__(self, dim: int, num_heads: int, window_size: int, input_size: Tuple[int, int],
                 lora_rank: int = 0, use_rel_pos: bool = True, attn_route: str | None = None,
                 fuse_ln_window: str = "auto", fuse_unpart_residual: str = "never",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        if fuse_ln_window not in _FUSE_LN_WINDOW:
            raise ValueError(f"fuse_ln_window must be one of {_FUSE_LN_WINDOW}, got {fuse_ln_window!r}")
        if fuse_unpart_residual not in _FUSE_UNPART:
            raise ValueError(
                f"fuse_unpart_residual must be one of {_FUSE_UNPART}, got {fuse_unpart_residual!r}")
        if fuse_unpart_residual == "always" and fuse_ln_window == "never":
            raise ValueError(
                'fuse_unpart_residual="always" joins the windowed tokens K4 produces: it needs '
                'fuse_ln_window="auto" or "always"')
        self.window_size = window_size
        self.use_lnw = window_size > 0 and fuse_ln_window != "never"
        self.use_upr = self.use_lnw and fuse_unpart_residual == "always"
        self.norm1 = LayerNorm(dim, 1e-6, compute_dtype)
        self.attn = Attention(
            dim, num_heads,
            input_size=input_size if window_size == 0 else (window_size, window_size),
            window_size=window_size, lora_rank=lora_rank, use_rel_pos=use_rel_pos,
            attn_route=attn_route, windowed_input=self.use_lnw, windowed_output=self.use_upr,
            compute_dtype=compute_dtype,
        )
        self.norm2 = LayerNorm(dim, 1e-6, compute_dtype)
        self.mlp = MLPBlock(dim, 4 * dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_lnw:
            windows = ln_window_partition_fused(
                x, self.norm1.weight, self.norm1.bias, self.window_size, self.norm1.eps
            )
            y = self.attn(windows, grid_hw=(x.shape[1], x.shape[2]))
        else:
            y = self.attn(self.norm1(x))
        if self.use_upr:
            x, y = unpartition_add_ln(y, x, self.norm2.weight, self.norm2.bias, self.window_size,
                                      self.norm2.eps)
            return x + self.mlp(y)
        x = x + y
        return x + self.mlp(self.norm2(x))


class _PatchEmbedMM(nn.Module):
    """Non-overlapping patch embed as a reshape and one matmul: the same
    contraction as the reference's stride-P convolution, whose parameters
    it keeps under ``proj`` (weight ``(D, C, P, P)``), cast to
    ``compute_dtype``."""

    def __init__(self, patch: int, in_chans: int, dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch = patch
        self.compute_dtype = compute_dtype
        self.proj = nn.Conv2d(in_chans, dim, patch, stride=patch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        p = self.patch
        b, h, w, c = x.shape
        x = x.reshape(b, h // p, p, w // p, p, c).permute(0, 1, 3, 2, 4, 5)
        x = x.reshape(b, h // p, w // p, p * p * c)
        kernel = self.proj.weight.permute(2, 3, 1, 0).reshape(p * p * c, -1)
        return x @ kernel.to(self.compute_dtype) + self.proj.bias.to(self.compute_dtype)


class ImageEncoderViT(nn.Module):
    """(B, H, W, 3) → (B, H/16, W/16, out_chans) embeddings."""

    def __init__(self, img_size: int = 1024, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, out_chans: int = 256,
                 window_size: int = 0, global_attn_indexes: Tuple[int, ...] = (),
                 lora_rank: int = 0, use_rel_pos: bool = True, attn_route: str | None = None,
                 fuse_ln_window: str = "auto", fuse_unpart_residual: str = "never",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.img_size = img_size
        self.compute_dtype = compute_dtype
        side = img_size // patch_size
        self.patch_embed = _PatchEmbedMM(patch_size, 3, embed_dim, compute_dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, side, side, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads,
                  window_size=0 if i in global_attn_indexes else window_size,
                  input_size=(side, side), lora_rank=lora_rank, use_rel_pos=use_rel_pos,
                  attn_route=attn_route, fuse_ln_window=fuse_ln_window,
                  fuse_unpart_residual=fuse_unpart_residual, compute_dtype=compute_dtype)
            for i in range(depth)
        )
        self.neck = nn.ModuleList([
            Conv2d(embed_dim, out_chans, 1, bias=False, compute_dtype=compute_dtype),
            LayerNorm2d(out_chans, compute_dtype=compute_dtype),
            Conv2d(out_chans, out_chans, 3, padding=1, bias=False, compute_dtype=compute_dtype),
            LayerNorm2d(out_chans, compute_dtype=compute_dtype),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.patch_embed(x.to(self.compute_dtype)) + self.pos_embed.to(self.compute_dtype)
        for blk in self.blocks:
            x = blk(x)
        conv1, norm1, conv2, norm2 = self.neck
        x = norm1(conv1(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
        return norm2(conv2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
