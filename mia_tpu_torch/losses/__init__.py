from .ce import cross_entropy
from .compound import DiceAndCELoss
from .dice import soft_dice_loss

__all__ = ["DiceAndCELoss", "cross_entropy", "soft_dice_loss"]
