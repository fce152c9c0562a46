"""Shared SAM modules (counterpart of ``mia_tpu/models/sam/common.py``):
``Linear``, ``MLPBlock``, the flax-order ``LayerNorm`` and ``LayerNorm2d``.
Channel-last layout makes ``LayerNorm2d`` a LayerNorm over the last axis.

``compute_dtype`` on each module is flax's ``dtype=``: the float32
parameters are cast to it at each call and the output comes out in it; the
norms compute in float32 whatever it is."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.ln_window import layer_norm
from ..layers import Linear


def linear(in_features: int, out_features: int, bias: bool = True,
           compute_dtype: torch.dtype = torch.float32) -> Linear:
    return Linear(in_features, out_features, bias=bias, compute_dtype=compute_dtype)


class _GeluLowPrecision(torch.autograd.Function):
    """``jax.nn.gelu(x, approximate=False)`` op by op in x's dtype, and its
    VJP as JAX's autodiff writes it (``erfc``'s derivative ``−2/√π ·
    exp(−e²)`` with the constant rounded to that dtype), each operation
    rounding its result."""

    @staticmethod
    def forward(ctx, x):
        sqrt_half = torch.tensor(math.sqrt(0.5), dtype=x.dtype)
        half_x = 0.5 * x
        e = -x * sqrt_half
        erfc = torch.erfc(e)
        ctx.save_for_backward(half_x, e, erfc, sqrt_half)
        return half_x * erfc

    @staticmethod
    def backward(ctx, g):
        half_x, e, erfc, sqrt_half = ctx.saved_tensors
        d_erfc = torch.tensor(-2.0 / math.sqrt(math.pi), dtype=g.dtype)
        d_e = ((half_x * g) * d_erfc) * torch.exp(-(e * e))
        return 0.5 * (g * erfc) - d_e * sqrt_half


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact GELU. Outside float32 it is computed as ``jax.nn.gelu(x,
    approximate=False)`` writes it, op by op in x's dtype:
    ``0.5 · x · erfc(−x · √½)`` with √½ rounded to that dtype, and so is its
    gradient (:class:`_GeluLowPrecision`)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="none")
    return _GeluLowPrecision.apply(x)


class MLPBlock(nn.Module):
    """Linear → exact GELU → Linear."""

    def __init__(self, embedding_dim: int, mlp_dim: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.lin1 = linear(embedding_dim, mlp_dim, compute_dtype=compute_dtype)
        self.lin2 = linear(mlp_dim, embedding_dim, compute_dtype=compute_dtype)

    def forward(self, x):
        return self.lin2(gelu(self.lin1(x)))


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm``: fast variance ``max(E[x²] − μ², 0)``, in
    float32, the output in ``compute_dtype``."""

    def __init__(self, dim: int, eps: float, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x.float(), self.weight, self.bias, self.eps).to(self.compute_dtype)


class LayerNorm2d(nn.Module):
    """The reference ``LayerNorm2d`` on channel-last input: two-pass
    variance over the channel axis, eps 1e-6, in float32, the output in
    ``compute_dtype``."""

    def __init__(self, num_channels: int, eps: float = 1e-6,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = (x - mean).square().mean(-1, keepdim=True)
        y = (x - mean) / torch.sqrt(var + self.eps) * self.weight + self.bias
        return y.to(self.compute_dtype)
