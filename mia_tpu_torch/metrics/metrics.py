"""Segmentation metrics with the reference's empty-mask conventions.

Counterpart of ``mia_tpu/metrics/metrics.py`` (``metric_percase``,
``metric_percase_hd95`` and what they call), plain PyTorch on the device of
its inputs:

- masks are binarised (>0); if ``pred`` is empty → (dice 0, hd NaN,
  asd NaN, jc 0);
- hd: both empty → 0, one empty → inf (``cal_hd``).
"""

from __future__ import annotations

import torch

from ..ops.distance import surface_distance_stats


def dice_coefficient(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """medpy ``dc``: 2|A∩B| / (|A|+|B|); 0 when both are empty."""
    p = (pred > 0).to(torch.float32)
    g = (gt > 0).to(torch.float32)
    intersect = (p * g).sum()
    denom = p.sum() + g.sum()
    return torch.where(denom > 0, 2.0 * intersect / denom.clamp_min(1.0), torch.zeros_like(denom))


def jaccard(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """medpy ``jc``: |A∩B| / |A∪B|."""
    p = pred > 0
    g = gt > 0
    intersect = (p & g).sum().to(torch.float32)
    union = (p | g).sum().to(torch.float32)
    return torch.where(union > 0, intersect / union.clamp_min(1.0), torch.zeros_like(union))


def metric_percase(pred: torch.Tensor, gt: torch.Tensor, spacing=None):
    """(dice, hd, asd, jc) for one binary case; anything >0 is foreground."""
    p = pred > 0
    g = gt > 0
    dice = dice_coefficient(p, g)
    jc = jaccard(p, g)
    stats = surface_distance_stats(p, g, spacing)

    p_any = p.any()
    g_any = g.any()
    zero = torch.zeros((), device=p.device)
    inf = torch.full((), float("inf"), device=p.device)
    nan = torch.full((), float("nan"), device=p.device)
    hd = torch.where(
        p_any & g_any, stats["hd"], torch.where(~p_any & ~g_any, zero, inf)
    )
    asd = torch.where(p_any & g_any, stats["asd"], inf)
    dice = torch.where(p_any, dice, zero)
    hd = torch.where(p_any, hd, nan)
    asd = torch.where(p_any, asd, nan)
    jc = torch.where(p_any, jc, zero)
    return dice, hd, asd, jc


def per_class_metrics(pred: torch.Tensor, gt: torch.Tensor, num_classes: int, spacing=None):
    """(dice, hd, asd, jc) of each foreground class 1..num_classes-1 of two
    label maps, as a ``(num_classes - 1, 4)`` float32 tensor."""
    return torch.stack([torch.stack(metric_percase(pred == c, gt == c, spacing))
                        for c in range(1, num_classes)])


def metric_percase_hd95(pred: torch.Tensor, gt: torch.Tensor):
    """(dice, hd95) for one binary case, SAM validation's pair: hd95 is NaN
    when ``pred`` is empty and inf when only ``gt`` is."""
    p = pred > 0
    g = gt > 0
    dice = dice_coefficient(p, g)
    stats = surface_distance_stats(p, g, None)
    p_any = p.any()
    g_any = g.any()
    inf = torch.full((), float("inf"), device=p.device)
    nan = torch.full((), float("nan"), device=p.device)
    hd95 = torch.where(p_any & g_any, stats["hd95"], torch.where(p_any, inf, nan))
    return torch.where(p_any, dice, torch.zeros_like(dice)), hd95
