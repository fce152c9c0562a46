"""LR schedule and ramp-ups (counterparts of ``poly_warmup_schedule``,
``sigmoid_ramp_up`` and ``linear_ramp_up`` in ``mia_tpu/schedule.py``, whose
numpy paths these are): linear warmup ``lr*(i+1)/warmup`` then poly decay
``lr*(1 - i/(max-warmup))**0.9``, ``final*exp(-5*(1 - t)**2)`` and
``final*t``, step indices quantised by ``interval``.
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


def sigmoid_ramp_up(final_value: float, max_steps: int, interval: int = 1, exponent: float = 5.0):
    """``final * exp(-exponent * (1 - t)**2)`` with ``t = min(i, max)/max``."""
    adj_max = max_steps // interval

    def schedule(step: int) -> float:
        if adj_max == 0:
            return float(final_value)
        i = min(max(int(step) // interval, 0), adj_max)
        return float(final_value * np.exp(-exponent * (1.0 - i / adj_max) ** 2))

    return schedule


def linear_ramp_up(final_value: float, max_steps: int, interval: int = 1):
    """``final * t`` with ``t = min(i, max)/max``."""
    adj_max = max_steps // interval

    def schedule(step: int) -> float:
        if adj_max == 0:
            return float(final_value)
        i = min(max(int(step) // interval, 0), adj_max)
        return float(final_value * i / adj_max)

    return schedule
