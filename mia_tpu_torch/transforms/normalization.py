"""Per-sample z-score normalisation (counterpart of
``mia_tpu/transforms/normalization.py``): torch ``Tensor.std()`` is
Bessel-corrected, and the std is clipped at 1e-8."""

from __future__ import annotations

import torch


def zscore_normalize(images: torch.Tensor) -> torch.Tensor:
    """Z-score each sample of ``(B, ...)`` over all its other axes."""
    x = images.to(torch.float32)
    dims = tuple(range(1, x.ndim))
    n = x[0].numel()
    mean = x.mean(dims, keepdim=True)
    var = torch.square(x - mean).sum(dims, keepdim=True) / max(n - 1, 1)
    return (x - mean) / torch.sqrt(var).clamp_min(1e-8)
