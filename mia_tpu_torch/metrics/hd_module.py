"""FUGC lip-class Hausdorff evaluator (reference ``src/metric/metric.py:9-79``).

Counterpart of ``mia_tpu/metrics/hd_module.py``. ``HD(pred_logits, label)``
averages three Hausdorff distances over the FUGC class structure: anterior
lip only (class 2 → bg), posterior lip only (class 1 → bg, 2 → 1), and the
merged object (2 → 1). Each sub-evaluation is ``cal_hd`` (max symmetric
surface distance with the reference's empty-mask conventions) on the
device of its input.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.distance import surface_distance_stats


def cal_hd(a, b, spacing=None) -> float:
    """Reference ``cal_hd`` conventions (``metric/metric.py:82-108``):
    both empty → 0, one empty → inf, else max symmetric surface distance."""
    a = torch.as_tensor(a) > 0
    b = torch.as_tensor(b) > 0
    sum_a, sum_b = int(a.sum()), int(b.sum())
    if sum_a == 0 and sum_b == 0:
        return 0.0
    if sum_a == 0 or sum_b == 0:
        return float(np.inf)
    return float(surface_distance_stats(a, b.to(a.device), spacing)["hd"])


class HD:
    """Callable evaluator: logits (B, H, W, C) or (B, C, H, W) + label
    (B, H, W) → mean of (hd_all, hd_upper, hd_lower) for the first case,
    computed on the device of ``pred``."""

    def __call__(self, pred, label) -> float:
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        if pred.ndim == 4 and pred.shape[1] <= 8 and pred.shape[1] < pred.shape[-1]:
            pred_map = pred.argmax(1)[0]  # channel-first input
        else:
            pred_map = pred.argmax(-1)[0]
        return self.evaluation(pred_map, label[0].to(torch.int64))

    @staticmethod
    def evaluation(pred, label) -> float:
        pred = torch.as_tensor(pred)
        label = torch.as_tensor(label, device=pred.device)
        # upper: drop class 2
        pred_upper = torch.where(pred == 2, 0, pred)
        label_upper = torch.where(label == 2, 0, label)
        hd_upper = cal_hd(pred_upper, label_upper)
        # lower: keep class 2 as 1, drop class 1
        pred_lower = torch.where(pred == 1, 0, pred)
        pred_lower = torch.where(pred_lower == 2, 1, pred_lower)
        label_lower = torch.where(label == 1, 0, label)
        label_lower = torch.where(label_lower == 2, 1, label_lower)
        hd_lower = cal_hd(pred_lower, label_lower)
        # all: merge 2 into 1
        pred_all = torch.where(pred == 2, 1, pred)
        label_all = torch.where(label == 2, 1, label)
        hd_all = cal_hd(pred_all, label_all)
        return (hd_all + hd_lower + hd_upper) / 3.0
