"""Layers with flax's ``dtype=``: float32 parameters, computed in
``compute_dtype``.

In float32 each layer is its ``torch.nn`` base, unchanged. In bfloat16 the
input, weight and bias are cast at each call (flax's ``promote_dtype``) and
the bias is added after the product, each result rounded to bfloat16, as
flax's layers compute (a dot or a convolution, then ``+ bias``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class CastParams:
    """Mixin before a ``torch.nn`` layer with ``weight`` and ``bias``: takes
    ``compute_dtype`` in its constructor; a subclass gives ``_op(x, weight,
    bias)`` and ``channel_dim``, where the output's channels lie."""

    channel_dim = 1

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.compute_dtype == torch.float32:
            return super().forward(x)
        return self._compute(self._op, x)

    def _compute(self, op, x: torch.Tensor) -> torch.Tensor:
        """``op(x, weight, bias)`` with flax's roundings."""
        if self.compute_dtype == torch.float32:
            return op(x, self.weight, self.bias)
        dt = self.compute_dtype
        y = op(x.to(dt), self.weight.to(dt), None)
        if self.bias is None:
            return y
        return y + self.bias.to(dt).view(-1, *(1,) * (y.ndim - 1 - self.channel_dim % y.ndim))


class Linear(CastParams, nn.Linear):
    channel_dim = -1

    def _op(self, x, w, b):
        return F.linear(x, w, b)


class Conv2d(CastParams, nn.Conv2d):
    def _op(self, x, w, b):
        return self._conv_forward(x, w, b)


class Conv3d(CastParams, nn.Conv3d):
    def _op(self, x, w, b):
        return self._conv_forward(x, w, b)


class ConvTranspose2d(CastParams, nn.ConvTranspose2d):
    def _op(self, x, w, b):
        return F.conv_transpose2d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class ConvTranspose3d(CastParams, nn.ConvTranspose3d):
    def _op(self, x, w, b):
        return F.conv_transpose3d(x, w, b, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)
