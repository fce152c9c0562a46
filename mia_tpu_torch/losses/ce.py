"""Cross-entropy (counterpart of ``mia_tpu/losses/ce.py::cross_entropy``,
plain mean reduction as the AL path uses it). Logits ``(B, H, W, C)``,
integer targets ``(B, H, W)``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """torch ``F.cross_entropy`` over the last axis, mean over pixels."""
    return F.cross_entropy(logits.to(torch.float32).movedim(-1, 1), targets.long())
