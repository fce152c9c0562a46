"""Selection algorithms of the AL selectors: k-center greedy and weighted
k-means++ (counterpart of ``mia_tpu/activelearning/selection.py``).

Both run on the device of their inputs as tensor programs over a dense
(N, N) distance matrix; the budgets are tens of picks, so each pick is one
short loop step with no host round trip.

``kmeans_plusplus`` draws its random numbers from a ``torch.Generator`` and
hands them to :func:`kmeans_plusplus_from_draws`, the deterministic core:
given the same first center and uniforms it picks what the JAX package
picks. The packages' generators differ, so the draws of a whole run do too.
"""

from __future__ import annotations

import math

import torch

from ..ops.distance import pairwise_distances

_NEG = -1.0e30
_POS = 1.0e30


def kcenter_greedy(
    dist_mat: torch.Tensor,
    init_mask: torch.Tensor,
    budget: int,
    criteria: str = "min",
) -> torch.Tensor:
    """Greedy k-center over a dense (N, N) distance matrix.

    ``init_mask`` marks the points already selected. Each step picks the
    unselected point whose min (or mean) distance to the selected set is
    largest; the first such index wins. Returns the ``budget`` new indices
    in selection order.
    """
    if criteria not in ("min", "mean"):
        raise RuntimeError(f"coreset_criteria {criteria} is undefined")
    dist_mat = dist_mat.to(torch.float32)
    mask = init_mask.to(device=dist_mat.device, dtype=torch.bool).clone()
    neg = torch.full((), _NEG, device=dist_mat.device)
    pos = torch.full((), _POS, device=dist_mat.device)
    picks = []
    for _ in range(budget):
        if criteria == "min":
            d = torch.where(mask[None, :], dist_mat, pos).amin(1)
        else:
            sel = mask.to(torch.float32)
            d = (dist_mat * sel[None, :]).sum(1) / sel.sum().clamp_min(1.0)
        q = torch.argmax(torch.where(mask, neg, d))
        mask[q] = True
        picks.append(q)
    return torch.stack(picks) if picks else torch.zeros(0, dtype=torch.long)


def n_local_trials_for(n_clusters: int) -> int:
    """sklearn's default number of candidates a k-means++ step: 2 + ⌊log k⌋."""
    return 2 + int(math.log(max(n_clusters, 1)) + 1e-9)


def _normalized_weight(x: torch.Tensor, sample_weight) -> torch.Tensor:
    if sample_weight is None:
        w = torch.ones(x.shape[0], dtype=torch.float32, device=x.device)
    else:
        w = torch.as_tensor(sample_weight).to(device=x.device, dtype=torch.float32)
    return w / w.sum()


def kmeans_plusplus_from_draws(
    x: torch.Tensor,
    first: int | torch.Tensor,
    uniforms: torch.Tensor,
    sample_weight=None,
) -> torch.Tensor:
    """The deterministic k-means++ core: ``first`` is the first center,
    ``uniforms`` the ``(k - 1, n_local_trials)`` draws in [0, 1) of the other
    steps. Each step draws its candidates ∝ weight · D² (the left
    ``searchsorted`` of ``u · total`` in the running potential, clipped to
    [0, N - 1]) and keeps the one with the least weighted potential (the
    first on a tie). Returns the ``k`` indices."""
    x = x.to(torch.float32)
    n = x.shape[0]
    w = _normalized_weight(x, sample_weight)
    uniforms = torch.as_tensor(uniforms).to(device=x.device, dtype=torch.float32)
    d2 = pairwise_distances(x, x, "l2").square()
    first = torch.as_tensor(first, device=x.device).to(torch.long)
    closest = d2[first]  # squared distance to the nearest chosen center
    indices = [first]
    for u in uniforms:
        pot = w * closest
        cand = torch.searchsorted(torch.cumsum(pot, 0), u * pot.sum()).clamp(0, n - 1)
        new_closest = torch.minimum(closest[None, :], d2[cand])  # (trials, N)
        chosen = cand[torch.argmin((w[None, :] * new_closest).sum(1))]
        closest = torch.minimum(closest, d2[chosen])
        indices.append(chosen)
    return torch.stack(indices)


def kmeans_plusplus(
    x: torch.Tensor,
    n_clusters: int,
    generator: torch.Generator,
    sample_weight=None,
    n_local_trials: int | None = None,
) -> torch.Tensor:
    """sklearn ``kmeans_plusplus`` semantics: the first center drawn ∝
    ``sample_weight``, then greedy local trials. The draws come from
    ``generator`` (a CPU generator: the picks do not depend on the device
    of ``x``). Returns (k,) indices, which may repeat."""
    if n_local_trials is None:
        n_local_trials = n_local_trials_for(n_clusters)
    u_first = torch.rand((), generator=generator)
    uniforms = torch.rand((n_clusters - 1, n_local_trials), generator=generator)
    w = _normalized_weight(x, sample_weight)
    cum = torch.cumsum(w, 0)
    first = torch.searchsorted(cum, u_first.to(x.device) * cum[-1]).clamp(0, x.shape[0] - 1)
    return kmeans_plusplus_from_draws(x, first, uniforms, sample_weight)
