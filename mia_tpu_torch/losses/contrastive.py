"""Prototype contrastive loss (counterpart of
``mia_tpu/losses/contrastive.py``): masked and of fixed shape, as there.

For each class the predicted features of the retained rows of that class
are pulled towards the valid rows of the class's memory bank: the mean
cosine distance over all (feature, bank row) pairs, weighted on both axes
by sigmoid selector scores rescaled to mean 1 over their set. Classes with
fewer than 2 features or fewer than 2 bank rows contribute 0. Each class's
``(N, E)`` distance matrix is recomputed in the backward
(``torch.utils.checkpoint``) rather than kept: ``N`` is every pixel of
every decoder pass in the CPC-SAM trainer.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..memories.feature_memory import FeatureMemoryState


def _unit_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=1, keepdim=True).clamp_min(1e-12)


def class_contrastive_term(feats, mask_c, bank, bank_valid, scores, scores_memory):
    """One class's term: ``feats (N, D)`` unit rows, ``mask_c (N,)`` the
    retained rows of the class, ``bank (E, D)`` with ``bank_valid (E,)``,
    raw selector ``scores (N,)`` and ``scores_memory (E,)``."""
    m_count, n_count = mask_c.sum(), bank_valid.sum()
    dists = 1.0 - feats @ _unit_rows(bank).T  # (N, E)
    zero = dists.new_zeros(())
    w_f = torch.sigmoid(scores)
    sum_w_f = torch.where(mask_c, w_f, zero).sum()
    w_f = torch.where(mask_c, m_count / sum_w_f.clamp_min(1e-12) * w_f, zero)
    w_m = torch.sigmoid(scores_memory)
    sum_w_m = torch.where(bank_valid, w_m, zero).sum()
    w_m = torch.where(bank_valid, n_count / sum_w_m.clamp_min(1e-12) * w_m, zero)
    # w_f and w_m are zero outside their masks, so the weighted sum runs over the pairs only
    weighted = dists * w_f[:, None] * w_m[None, :]
    mean = weighted.sum() / (m_count * n_count).clamp_min(1).to(dists.dtype)
    return torch.where((m_count > 1) & (n_count > 1), mean, zero)


def prototype_contrastive_loss(pred_features, class_labels, retain_mask,
                               memory: FeatureMemoryState, selector_scores,
                               selector_scores_memory, num_classes: int) -> torch.Tensor:
    """Weighted cosine distance of predicted features to the memory bank.

    ``pred_features (N, D)`` prediction-head outputs; ``class_labels (N,)``;
    ``retain_mask (N,)`` bool; ``memory`` with bank ``(C, E, D)`` and valid
    ``(C, E)``; ``selector_scores (C, N)`` and ``selector_scores_memory (C,
    E)`` raw selector outputs; ``num_classes`` excludes the background.
    """
    total_classes = num_classes + 1
    feats = _unit_rows(pred_features)
    terms = [checkpoint(class_contrastive_term, feats, retain_mask & (class_labels == c),
                        memory.bank[c], memory.valid[c], selector_scores[c],
                        selector_scores_memory[c], use_reentrant=False)
             for c in range(total_classes)]
    return torch.stack(terms).sum() / total_classes
