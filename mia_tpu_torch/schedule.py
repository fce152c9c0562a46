"""Poly-warmup LR schedule (counterpart of
``mia_tpu/schedule.py::poly_warmup_schedule``, whose numpy path this is):
linear warmup ``lr*(i+1)/warmup`` then poly decay
``lr*(1 - i/(max-warmup))**0.9``, step indices quantised by ``interval``.
"""

from __future__ import annotations

import numpy as np


def poly_warmup_schedule(
    initial_lr: float,
    max_steps: int,
    warmup_steps: int = 0,
    exponent: float = 0.9,
    interval: int = 1,
):
    adj_warmup = warmup_steps // interval
    adj_max = max_steps // interval

    def schedule(step: int) -> float:
        i = int(step) // interval
        if adj_warmup > 0 and i < adj_warmup:
            return float(initial_lr * (i + 1) / adj_warmup)
        j = i - adj_warmup
        frac = np.clip(1.0 - j / max(adj_max - adj_warmup, 1), 0.0, 1.0)
        return float(initial_lr * frac**exponent)

    return schedule
