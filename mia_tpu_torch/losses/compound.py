"""``DiceAndCELoss``, the AL supervised loss (counterpart of
``mia_tpu/losses/compound.py::DiceAndCELoss``): ``ce_weight*CE +
dice_weight*Dice``; ``__call__`` returns ``(total, ce, dice)``. Per-call
``dice_weight``/``ce_weight`` override the configured ones (a falsy value
keeps the configured weight, as in the JAX package); CPC-SAM calls it so."""

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
