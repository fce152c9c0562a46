from .ce import cross_entropy
from .compound import DiceAndCELoss
from .contrastive import prototype_contrastive_loss
from .dice import soft_dice_loss
from .vat import vat_loss

__all__ = ["DiceAndCELoss", "cross_entropy", "prototype_contrastive_loss", "soft_dice_loss",
           "vat_loss"]
