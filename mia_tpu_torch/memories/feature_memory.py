"""Per-class prototype feature memory (counterpart of
``mia_tpu/memories/feature_memory.py``).

The bank is explicit state ``(bank, valid)`` of fixed shapes
``(num_classes + 1, elements_per_class, feat_dim)`` and ``(num_classes + 1,
elements_per_class)``, carried by the trainer from step to step and updated
without a gradient.

Ranking: each class keeps the ``elements_per_class`` features with the
LOWEST selector scores (the reference sorts ascending and keeps the first
rows). The JAX package takes ``top_k`` of the negated scores, which breaks
ties by index; ``torch.topk`` promises no order among ties, so a stable
ascending sort takes its place. Rows past a class's feature count are ties
at +inf there: they are marked invalid, and stored as zeros here (the JAX
package stores whichever rows the tie-break picks; no consumer reads them).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class FeatureMemoryState(NamedTuple):
    bank: torch.Tensor  # (C, E, D)
    valid: torch.Tensor  # (C, E) bool


def init_feature_memory(num_classes: int, feat_dim: int, elements_per_class: int = 32,
                        device=None) -> FeatureMemoryState:
    """``num_classes`` excludes the background (one class is added)."""
    c = num_classes + 1
    return FeatureMemoryState(
        bank=torch.zeros((c, elements_per_class, feat_dim), dtype=torch.float32, device=device),
        valid=torch.zeros((c, elements_per_class), dtype=torch.bool, device=device),
    )


@torch.no_grad()
def update_feature_memory(state: FeatureMemoryState, proj_features: torch.Tensor,
                          class_labels: torch.Tensor,
                          selector_scores: torch.Tensor) -> FeatureMemoryState:
    """Refresh each class's bank with its lowest-scored features.

    ``proj_features`` ``(N, D)`` already projected; ``class_labels`` ``(N,)``
    with -1 for rows to ignore (wrong predictions); ``selector_scores``
    ``(C, N)`` sigmoid scores of each class's selector head. A class with no
    row keeps its previous bank. Returns a new state; ``state`` is not
    written.
    """
    num_classes, elements = state.bank.shape[:2]
    if proj_features.shape[0] < elements:
        raise ValueError(f"{proj_features.shape[0]} features cannot fill {elements} bank rows")
    bank, valid = state.bank.clone(), state.valid.clone()
    slots = torch.arange(elements, device=bank.device)
    inf = torch.full((), float("inf"), dtype=selector_scores.dtype, device=bank.device)
    for c in range(num_classes):
        mask_c = class_labels == c
        count = mask_c.sum()
        score = torch.where(mask_c, selector_scores[c], inf)
        idx = torch.sort(score, stable=True).indices[:elements]  # lowest first, ties by index
        new_valid = slots < count.clamp(max=elements)
        new_feats = proj_features[idx].to(bank.dtype) * new_valid[:, None]
        keep = count > 0
        bank[c] = torch.where(keep, new_feats, bank[c])
        valid[c] = torch.where(keep, new_valid, valid[c])
    return FeatureMemoryState(bank=bank, valid=valid)
