"""``DiceAndCELoss``, the AL supervised loss (counterpart of
``mia_tpu/losses/compound.py::DiceAndCELoss``): ``ce_weight*CE +
dice_weight*Dice``; ``__call__`` returns ``(total, ce, dice)``."""

from __future__ import annotations

import dataclasses

from .ce import cross_entropy
from .dice import soft_dice_loss


@dataclasses.dataclass(frozen=True)
class DiceAndCELoss:
    dice_weight: float = 1.0
    ce_weight: float = 1.0
    smooth: float = 1e-5
    do_bg: bool = True
    softmax: bool = True
    batch: bool = False
    squared: bool = False

    def __call__(self, logits, targets):
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
        return self.ce_weight * loss_ce + self.dice_weight * loss_dice, loss_ce, loss_dice
