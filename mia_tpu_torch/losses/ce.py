"""Cross-entropy family, channel-last (counterpart of ``mia_tpu/losses/ce.py``).

``logits`` are ``(B, *spatial, C)``; ``targets`` ``(B, *spatial)`` int.
Class weights and ``ignore_index`` follow torch's semantics: the mean is
weighted by each pixel's class weight, ignored pixels weigh zero.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    weight: torch.Tensor | None = None,
    ignore_index: int | None = None,
    label_smoothing: float = 0.0,
    reduction: str = "mean",
) -> torch.Tensor:
    """torch ``F.cross_entropy`` over the last axis of ``logits``.

    The plain call (the AL path's) is ``F.cross_entropy`` itself. With an
    option it is gather-free like the JAX package's: targets are clipped to
    ``[0, C-1]`` for the one-hot, so an ignored label outside that range
    needs no valid class (``F.cross_entropy`` raises on one), and label
    smoothing and class weights combine as the JAX package combines them.
    """
    lf = logits.to(torch.float32)
    if weight is None and ignore_index is None and label_smoothing == 0.0 and reduction == "mean":
        return F.cross_entropy(lf.movedim(-1, 1), targets.long())
    num_classes = lf.shape[-1]
    targets = targets.long()
    onehot = F.one_hot(targets.clamp(0, num_classes - 1), num_classes).to(torch.float32)
    lse = torch.logsumexp(lf, -1)
    nll = lse - (lf * onehot).sum(-1)
    if label_smoothing > 0.0:
        # -mean(log p) = lse - mean(logits)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * (lse - lf.mean(-1))

    pix_w = torch.ones_like(nll)
    if weight is not None:
        pix_w = onehot @ torch.as_tensor(weight, dtype=torch.float32, device=lf.device)
    if ignore_index is not None:
        pix_w = pix_w * (targets != ignore_index).to(torch.float32)
    nll = nll * pix_w

    if reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if weight is not None or ignore_index is not None:
        return nll.sum() / pix_w.sum().clamp_min(1e-8)
    return nll.mean()


def robust_cross_entropy(logits: torch.Tensor, targets: torch.Tensor, **kwargs) -> torch.Tensor:
    """nnU-Net's ``RobustCrossEntropyLoss``: a trailing singleton channel on
    the targets is dropped."""
    if targets.ndim == logits.ndim:
        if targets.shape[-1] != 1:
            raise ValueError(f"targets of shape {tuple(targets.shape)} have no singleton channel")
        targets = targets[..., 0]
    return cross_entropy(logits, targets, **kwargs)


def topk_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    k: float = 10.0,
    ignore_index: int | None = None,
    label_smoothing: float = 0.0,
) -> torch.Tensor:
    """nnU-Net's ``TopKLoss``: the mean of the top ``k`` percent of the
    per-pixel cross-entropies (a count fixed by the shape, one ``torch.topk``)."""
    if targets.ndim == logits.ndim:
        targets = targets[..., 0]
    flat = cross_entropy(logits, targets, ignore_index=ignore_index,
                         label_smoothing=label_smoothing, reduction="none").reshape(-1)
    num = max(1, int(flat.shape[0] * k / 100))
    return torch.topk(flat, num, sorted=False).values.mean()


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor, *,
                    reduction: str = "mean") -> torch.Tensor:
    """torch ``BCEWithLogitsLoss`` in the JAX package's stable form."""
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    loss = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.mean()
