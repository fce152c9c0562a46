"""Pairwise distances, the exact Euclidean distance transform and surface
distances, plain PyTorch.

Counterpart of ``mia_tpu/ops/distance.py`` (``pairwise_distances``,
``squared_edt``, ``binary_border``, ``surface_distance_stats``).
``pairwise_distances`` gives the AL selectors sklearn's l2 / cosine / l1
matrices through ``torch.matmul``; the EDT replaces scipy's inside medpy's
surface metrics. The EDT is separable: a nearest-feature pass along
the first axis (running max / min scans), then a dense min-plus with
parabolic offsets along each other axis, chunked to bound memory.
:func:`squared_edt_2d` runs the same passes over the last two axes of a
batch of planes (CPC-SAM's prompt generation).
"""

from __future__ import annotations

import torch

_BIG = 1.0e12
_MINPLUS_ELEMS = 1 << 24  # working-set bound of one min-plus chunk


def pairwise_distances(
    x: torch.Tensor, y: torch.Tensor | None = None, metric: str = "l2"
) -> torch.Tensor:
    """Dense (N, M) float32 distance matrix; ``metric`` in l2 / euclidean,
    cosine, l1 / manhattan / cityblock."""
    x = x.to(torch.float32)
    y = x if y is None else y.to(torch.float32)
    if metric in ("l2", "euclidean"):
        # centred on y's mean the distances stay the same, and the expansion
        # below stops cancelling when the points sit close together far from
        # the origin (its float32 error is ~eps·|x|²: on clustered features
        # it flipped k-means++ picks between the card and the CPU)
        c = y.mean(0, keepdim=True)
        x, y = x - c, y - c
        x2 = (x * x).sum(1, keepdim=True)
        y2 = (y * y).sum(1, keepdim=True)
        d2 = x2 + y2.T - 2.0 * torch.matmul(x, y.T)
        return torch.sqrt(d2.clamp_min(0.0))
    if metric == "cosine":
        xn = x / torch.linalg.vector_norm(x, dim=1, keepdim=True).clamp_min(1e-12)
        yn = y / torch.linalg.vector_norm(y, dim=1, keepdim=True).clamp_min(1e-12)
        return (1.0 - torch.matmul(xn, yn.T)).clamp(0.0, 2.0)
    if metric in ("l1", "manhattan", "cityblock"):
        return (x[:, None, :] - y[None, :, :]).abs().sum(-1)
    raise ValueError(f"unknown metric: {metric}")


def _nearest_feature_distance_1d(feature: torch.Tensor, spacing) -> torch.Tensor:
    """Distance to the nearest True along axis 0 (``_BIG`` where none)."""
    n = feature.shape[0]
    ii = torch.arange(n, dtype=torch.float32, device=feature.device)
    ii = ii.view((n,) + (1,) * (feature.ndim - 1)).expand(feature.shape)
    big = torch.full_like(ii, _BIG)
    last_fwd = torch.cummax(torch.where(feature, ii, -big), dim=0).values
    last_bwd = torch.cummin(torch.where(feature, ii, big).flip(0), dim=0).values.flip(0)
    d_fwd = (ii - last_fwd) * spacing
    d_bwd = (last_bwd - ii) * spacing
    return torch.minimum(
        torch.where(last_fwd < 0, big, d_fwd),
        torch.where(last_bwd >= _BIG, big, d_bwd),
    )


def _minplus_axis0(f2: torch.Tensor, spacing) -> torch.Tensor:
    """out[i, ...] = min_k f2[k, ...] + ((i - k) * spacing) ** 2."""
    n = f2.shape[0]
    rest = max(f2[0].numel(), 1)
    k = torch.arange(n, dtype=torch.float32, device=f2.device)
    chunk = max(1, min(n, _MINPLUS_ELEMS // (n * rest)))
    tail = (1,) * (f2.ndim - 1)
    outs = []
    for start in range(0, n, chunk):
        i = k[start : start + chunk]
        off2 = ((i[:, None] - k[None, :]) * spacing) ** 2
        outs.append(torch.amin(off2.view(off2.shape + tail) + f2[None], dim=1))
    return torch.cat(outs, dim=0)


def squared_edt(feature: torch.Tensor, spacing=None) -> torch.Tensor:
    """Exact squared EDT to the nearest True element of ``feature`` (n-D)."""
    nd = feature.ndim
    sp = (1.0,) * nd if spacing is None else tuple(float(s) for s in spacing)
    d0 = _nearest_feature_distance_1d(feature, sp[0])
    f2 = torch.where(d0 >= _BIG, torch.full_like(d0, _BIG), d0 * d0)
    for axis in range(1, nd):
        f2 = _minplus_axis0(f2.movedim(axis, 0), sp[axis]).movedim(0, axis)
    return f2


def squared_edt_2d(feature: torch.Tensor) -> torch.Tensor:
    """Exact squared EDT of each 2D plane of ``feature`` ``(..., H, W)``, unit
    spacing: leading axes are a batch (the JAX package vmaps the 2D EDT)."""
    f = feature.movedim(-2, 0)  # (H, ..., W)
    d0 = _nearest_feature_distance_1d(f, 1.0)
    f2 = torch.where(d0 >= _BIG, torch.full_like(d0, _BIG), d0 * d0)
    f2 = _minplus_axis0(f2.movedim(-1, 0), 1.0)  # (W, H, ...)
    return f2.movedim(0, -1).movedim(0, -2)


def binary_border(mask: torch.Tensor) -> torch.Tensor:
    """medpy border: mask XOR erosion(mask, cross, border 0), n-D."""
    fg = mask > 0
    eroded = fg
    for axis in range(mask.ndim):
        n = mask.shape[axis]
        pad = torch.zeros_like(fg.narrow(axis, 0, 1))
        lo = torch.cat([pad, fg.narrow(axis, 0, n - 1)], dim=axis)
        hi = torch.cat([fg.narrow(axis, 1, n - 1), pad], dim=axis)
        eroded = eroded & lo & hi
    return fg & ~eroded


def _masked_percentile(values: torch.Tensor, valid: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolated percentile of values[valid] (numpy 'linear')."""
    v = torch.where(valid, values, torch.full_like(values, float("inf")))
    v = torch.sort(v.reshape(-1)).values
    n = valid.sum()
    pos = q / 100.0 * (n.to(torch.float32) - 1.0)
    lo = torch.floor(pos).to(torch.int64).clamp(0, v.shape[0] - 1)
    hi = (lo + 1).clamp(0, v.shape[0] - 1)
    frac = pos - lo.to(torch.float32)
    vlo = v[lo]
    vhi = torch.where(hi < n, v[hi], vlo)
    return vlo + frac * (vhi - vlo)


def surface_distance_stats(pred: torch.Tensor, ref: torch.Tensor, spacing=None) -> dict:
    """hd (max symmetric), hd95 (pooled directed, medpy convention), asd
    (directed pred→ref mean) and assd. Callers handle empty masks."""
    pb = binary_border(pred)
    rb = binary_border(ref)
    dt_ref = torch.sqrt(squared_edt(rb, spacing).clamp_min(0.0))
    dt_pred = torch.sqrt(squared_edt(pb, spacing).clamp_min(0.0))

    zero = torch.zeros((), device=pred.device)
    inf = torch.full((), float("inf"), device=pred.device)
    d_p2r = torch.where(pb, dt_ref, zero)
    d_r2p = torch.where(rb, dt_pred, zero)
    n_p = pb.sum()
    n_r = rb.sum()

    hd = torch.maximum(
        torch.where(pb, dt_ref, -inf).max(), torch.where(rb, dt_pred, -inf).max()
    )
    asd = d_p2r.sum() / n_p.clamp_min(1)
    assd = (d_p2r.sum() + d_r2p.sum()) / (n_p + n_r).clamp_min(1)

    both = torch.cat([
        torch.where(pb, dt_ref, inf).reshape(-1),
        torch.where(rb, dt_pred, inf).reshape(-1),
    ])
    hd95 = _masked_percentile(both, torch.isfinite(both), 95.0)
    return {"hd": hd, "hd95": hd95, "asd": asd, "assd": assd}
