"""Shared SAM modules (counterpart of ``mia_tpu/models/sam/common.py``):
``MLPBlock``, the flax-order ``LayerNorm`` and ``LayerNorm2d``. Channel-last
layout makes ``LayerNorm2d`` a LayerNorm over the last axis."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.ln_window import layer_norm


class MLPBlock(nn.Module):
    """Linear → exact GELU → Linear."""

    def __init__(self, embedding_dim: int, mlp_dim: int):
        super().__init__()
        self.lin1 = nn.Linear(embedding_dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, embedding_dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x), approximate="none"))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: fast variance ``max(E[x²] − μ², 0)``."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class LayerNorm2d(nn.Module):
    """The reference ``LayerNorm2d`` on channel-last input: two-pass
    variance over the channel axis, eps 1e-6."""

    def __init__(self, num_channels: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
