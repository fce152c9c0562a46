from .ce import bce_with_logits, cross_entropy, robust_cross_entropy, topk_loss
from .compound import (DCAndBCELoss, DCAndCELoss, DCAndTopKLoss, DiceAndCELoss,
                       DualBranchDiceAndCELoss)
from .contrastive import prototype_contrastive_loss
from .dice import get_tp_fp_fn_tn, memory_efficient_soft_dice_loss, soft_dice_loss
from .vat import vat_loss

__all__ = [
    "soft_dice_loss",
    "memory_efficient_soft_dice_loss",
    "get_tp_fp_fn_tn",
    "cross_entropy",
    "robust_cross_entropy",
    "topk_loss",
    "bce_with_logits",
    "DiceAndCELoss",
    "DualBranchDiceAndCELoss",
    "DCAndCELoss",
    "DCAndBCELoss",
    "DCAndTopKLoss",
    "prototype_contrastive_loss",
    "vat_loss",
]
