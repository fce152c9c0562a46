"""Compound Dice + CE losses, channel-last (counterpart of
``mia_tpu/losses/compound.py``).

- ``DiceAndCELoss``, the AL supervised loss: ``ce_weight*CE +
  dice_weight*Dice``; ``__call__`` returns ``(total, ce, dice)``. Per-call
  ``dice_weight``/``ce_weight`` override the configured ones (a falsy value
  keeps the configured weight, as in the JAX package); CPC-SAM calls it so.
- ``DualBranchDiceAndCELoss``: two SAM branches, the reference's 7-tuple.
- The nnU-Net lineage, with ignore-label masking: ``DCAndCELoss``,
  ``DCAndBCELoss`` (sigmoid regions, an ignore channel last) and
  ``DCAndTopKLoss``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .ce import bce_with_logits, cross_entropy, robust_cross_entropy, topk_loss
from .dice import memory_efficient_soft_dice_loss, soft_dice_loss


@dataclasses.dataclass(frozen=True)
class DiceAndCELoss:
    dice_weight: float = 1.0
    ce_weight: float = 1.0
    smooth: float = 1e-5
    do_bg: bool = True
    softmax: bool = True
    batch: bool = False
    squared: bool = False

    def __call__(self, logits, targets, dice_weight: float | None = None,
                 ce_weight: float | None = None):
        dw = dice_weight if dice_weight else self.dice_weight
        cw = ce_weight if ce_weight else self.ce_weight
        loss_ce = cross_entropy(logits, targets)
        loss_dice = soft_dice_loss(
            logits,
            targets,
            smooth=self.smooth,
            do_bg=self.do_bg,
            softmax=self.softmax,
            batch=self.batch,
            squared=self.squared,
        )
        return cw * loss_ce + dw * loss_dice, loss_ce, loss_dice


@dataclasses.dataclass(frozen=True)
class DualBranchDiceAndCELoss:
    """Two-branch SAM loss: ``outputs`` holds ``low_res_logits1`` and
    ``low_res_logits2``; returns ``(loss, loss1, ce1, dice1, loss2, ce2,
    dice2)`` with ``loss_i = (1 - w)*ce_i + w*dice_i``."""

    dice_weight: float = 0.5
    smooth: float = 1e-5
    do_bg: bool = True
    batch: bool = False
    squared: bool = False

    def _branch(self, logits, targets, w):
        ce = cross_entropy(logits, targets)
        dice = soft_dice_loss(logits, targets, smooth=self.smooth, do_bg=self.do_bg,
                              softmax=True, batch=self.batch, squared=self.squared)
        return (1.0 - w) * ce + w * dice, ce, dice

    def __call__(self, outputs: dict, targets, dice_weight: float | None = None):
        w = dice_weight if dice_weight else self.dice_weight
        loss1, ce1, dice1 = self._branch(outputs["low_res_logits1"], targets, w)
        loss2, ce2, dice2 = self._branch(outputs["low_res_logits2"], targets, w)
        return loss1 + loss2, loss1, ce1, dice1, loss2, ce2, dice2


def _ignore(target: torch.Tensor, ignore_label: int | None):
    """(loss mask, Dice targets with ignored pixels as class 0)."""
    if ignore_label is None:
        return None, target
    ignored = target == ignore_label
    return (~ignored).to(torch.float32), torch.where(ignored, torch.zeros_like(target), target)


@dataclasses.dataclass(frozen=True)
class DCAndCELoss:
    """nnU-Net ``DC_and_CE_loss``: integer targets ``(B, *spatial)``; with
    ``ignore_label``, a masked soft Dice and CE with that ``ignore_index``."""

    weight_ce: float = 1.0
    weight_dice: float = 1.0
    ignore_label: int | None = None
    batch_dice: bool = False
    do_bg: bool = True
    smooth: float = 1.0
    ce_kwargs: tuple = ()

    def __call__(self, net_output: torch.Tensor, target: torch.Tensor):
        ce_kwargs: dict[str, Any] = dict(self.ce_kwargs)
        mask, target_dice = _ignore(target, self.ignore_label)
        if self.ignore_label is not None:
            ce_kwargs["ignore_index"] = self.ignore_label
        dc_loss = (memory_efficient_soft_dice_loss(
            net_output, target_dice, loss_mask=mask, apply_nonlin="softmax",
            batch_dice=self.batch_dice, do_bg=self.do_bg, smooth=self.smooth)
            if self.weight_dice != 0 else 0.0)
        ce_loss = (robust_cross_entropy(net_output, target, **ce_kwargs)
                   if self.weight_ce != 0 else 0.0)
        return self.weight_ce * ce_loss + self.weight_dice * dc_loss


@dataclasses.dataclass(frozen=True)
class DCAndBCELoss:
    """nnU-Net ``DC_and_BCE_loss``: sigmoid regions of one-hot targets, with
    ``use_ignore_label`` an ignore channel last."""

    weight_ce: float = 1.0
    weight_dice: float = 1.0
    use_ignore_label: bool = False
    batch_dice: bool = False
    smooth: float = 1.0

    def __call__(self, net_output: torch.Tensor, target: torch.Tensor):
        if self.use_ignore_label:
            mask = 1.0 - target[..., -1:].to(torch.float32)
            target_regions = target[..., :-1]
        else:
            mask, target_regions = None, target
        dc_loss = memory_efficient_soft_dice_loss(
            net_output, target_regions, loss_mask=mask, apply_nonlin="sigmoid",
            batch_dice=self.batch_dice, do_bg=True, smooth=self.smooth)
        target_regions = target_regions.to(torch.float32)
        if mask is not None:
            per = bce_with_logits(net_output, target_regions, reduction="none")
            ce_loss = (per * mask).sum() / mask.sum().clamp_min(1e-8)
        else:
            ce_loss = bce_with_logits(net_output, target_regions)
        return self.weight_ce * ce_loss + self.weight_dice * dc_loss


@dataclasses.dataclass(frozen=True)
class DCAndTopKLoss:
    """nnU-Net ``DC_and_topk_loss``: the masked soft Dice of ``DCAndCELoss``
    and the top ``k`` percent of the per-pixel CE."""

    weight_ce: float = 1.0
    weight_dice: float = 1.0
    ignore_label: int | None = None
    batch_dice: bool = False
    do_bg: bool = True
    smooth: float = 1.0
    k: float = 10.0

    def __call__(self, net_output: torch.Tensor, target: torch.Tensor):
        mask, target_dice = _ignore(target, self.ignore_label)
        dc_loss = (memory_efficient_soft_dice_loss(
            net_output, target_dice, loss_mask=mask, apply_nonlin="softmax",
            batch_dice=self.batch_dice, do_bg=self.do_bg, smooth=self.smooth)
            if self.weight_dice != 0 else 0.0)
        ce_loss = (topk_loss(net_output, target, k=self.k, ignore_index=self.ignore_label)
                   if self.weight_ce != 0 else 0.0)
        return self.weight_ce * ce_loss + self.weight_dice * dc_loss
