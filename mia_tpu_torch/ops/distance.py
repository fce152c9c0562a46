"""Exact Euclidean distance transform and surface distances, plain PyTorch.

Counterpart of ``mia_tpu/ops/distance.py`` (``squared_edt``,
``binary_border``, ``surface_distance_stats``), replacing scipy's EDT inside
medpy's surface metrics. The EDT is separable: a nearest-feature pass along
the first axis (running max / min scans), then a dense min-plus with
parabolic offsets along each other axis, chunked to bound memory.
"""

from __future__ import annotations

import torch

_BIG = 1.0e12
_MINPLUS_ELEMS = 1 << 24  # working-set bound of one min-plus chunk


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
