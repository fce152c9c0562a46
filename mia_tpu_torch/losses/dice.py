"""Soft Dice loss of the AL path (counterpart of
``mia_tpu/losses/dice.py::soft_dice_loss``). Logits ``(B, H, W, C)``,
integer targets ``(B, H, W)`` (or targets of the logits' shape, taken as
they are: soft or one-hot); returns ``1 - dice`` averaged over (batch,)
classes."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def soft_dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    smooth: float = 1e-5,
    do_bg: bool = False,
    softmax: bool = True,
    batch: bool = False,
    squared: bool = False,
) -> torch.Tensor:
    probs = torch.softmax(logits, -1) if softmax else logits
    probs = probs.to(torch.float32)
    if targets.shape == logits.shape:
        onehot = targets.to(torch.float32)
    else:
        onehot = F.one_hot(targets.long(), logits.shape[-1]).to(torch.float32)
    if not do_bg:
        probs = probs[..., 1:]
        onehot = onehot[..., 1:]

    spatial = tuple(range(1, probs.ndim - 1))
    intersect = (probs * onehot).sum(spatial)
    if squared:
        sum_p = torch.square(probs).sum(spatial)
        sum_t = torch.square(onehot).sum(spatial)
    else:
        sum_p = probs.sum(spatial)
        sum_t = onehot.sum(spatial)
    if batch:
        intersect, sum_p, sum_t = intersect.mean(0), sum_p.mean(0), sum_t.mean(0)

    dice = 1.0 - (2.0 * intersect + smooth) / (sum_p + sum_t + smooth)
    return dice.mean()
