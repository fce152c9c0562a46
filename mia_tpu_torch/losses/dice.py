"""Soft Dice losses, channel-last (counterpart of ``mia_tpu/losses/dice.py``).

- ``soft_dice_loss``: the AL path's, ``1 - dice`` averaged over (batch,)
  classes.
- ``memory_efficient_soft_dice_loss``: the nnU-Net lineage's, ``-dice``,
  with a loss mask, batch statistics summed, the denominator clipped at
  1e-8.
- ``get_tp_fp_fn_tn``: soft confusion counts per (batch, class).

Logits ``(B, *spatial, C)``; integer targets ``(B, *spatial)``, or targets
of the logits' shape, taken as they are (soft or one-hot).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _one_hot_like(targets: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Targets as float32 one-hot with the channel count of ``logits``."""
    if targets.shape == logits.shape:
        return targets.to(torch.float32)
    return F.one_hot(targets.long(), logits.shape[-1]).to(torch.float32)


def soft_dice_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    *,
    smooth: float = 1e-5,
    do_bg: bool = False,
    softmax: bool = True,
    batch: bool = False,
    squared: bool = False,
) -> torch.Tensor:
    probs = torch.softmax(logits, -1) if softmax else logits
    probs = probs.to(torch.float32)
    onehot = _one_hot_like(targets, logits)
    if not do_bg:
        probs = probs[..., 1:]
        onehot = onehot[..., 1:]

    spatial = tuple(range(1, probs.ndim - 1))
    intersect = (probs * onehot).sum(spatial)
    if squared:
        sum_p = torch.square(probs).sum(spatial)
        sum_t = torch.square(onehot).sum(spatial)
    else:
        sum_p = probs.sum(spatial)
        sum_t = onehot.sum(spatial)
    if batch:
        intersect, sum_p, sum_t = intersect.mean(0), sum_p.mean(0), sum_t.mean(0)

    dice = 1.0 - (2.0 * intersect + smooth) / (sum_p + sum_t + smooth)
    return dice.mean()


def memory_efficient_soft_dice_loss(
    x: torch.Tensor,
    y: torch.Tensor,
    loss_mask: torch.Tensor | None = None,
    *,
    apply_nonlin: str | None = "softmax",
    batch_dice: bool = False,
    do_bg: bool = True,
    smooth: float = 1.0,
) -> torch.Tensor:
    """nnU-Net-lineage soft Dice, returning ``-dice``. ``apply_nonlin`` is
    ``"softmax"``, ``"sigmoid"`` or None; ``loss_mask`` is ``(B, *spatial)``
    or ``(B, *spatial, 1)``, 1 where valid. The one-hot targets carry no
    gradient."""
    if apply_nonlin == "softmax":
        x = torch.softmax(x, -1)
    elif apply_nonlin == "sigmoid":
        x = torch.sigmoid(x)
    x = x.to(torch.float32)
    y_onehot = _one_hot_like(y, x).detach()
    if not do_bg:
        x, y_onehot = x[..., 1:], y_onehot[..., 1:]
    if loss_mask is not None:
        if loss_mask.ndim == x.ndim - 1:
            loss_mask = loss_mask[..., None]
        loss_mask = loss_mask.to(torch.float32)
        y_onehot = y_onehot * loss_mask

    spatial = tuple(range(1, x.ndim - 1))
    sum_gt = y_onehot.sum(spatial)
    intersect = (x * y_onehot).sum(spatial)
    sum_pred = (x if loss_mask is None else x * loss_mask).sum(spatial)
    if batch_dice:
        intersect, sum_pred, sum_gt = intersect.sum(0), sum_pred.sum(0), sum_gt.sum(0)

    dc = (2.0 * intersect + smooth) / (sum_gt + sum_pred + smooth).clamp_min(1e-8)
    return -dc.mean()


def get_tp_fp_fn_tn(
    net_output: torch.Tensor,
    gt: torch.Tensor,
    axes: tuple[int, ...] | None = None,
    mask: torch.Tensor | None = None,
    square: bool = False,
):
    """Soft true/false positives and negatives per (batch, class):
    ``net_output`` ``(B, *spatial, C)`` probabilities, ``gt`` an integer
    label map or one-hot; ``axes=None`` sums over the spatial axes."""
    if axes is None:
        axes = tuple(range(1, net_output.ndim - 1))
    y_onehot = _one_hot_like(gt, net_output).detach()
    tp = net_output * y_onehot
    fp = net_output * (1.0 - y_onehot)
    fn = (1.0 - net_output) * y_onehot
    tn = (1.0 - net_output) * (1.0 - y_onehot)
    if mask is not None:
        if mask.ndim == tp.ndim - 1:
            mask = mask[..., None]
        mask = mask.to(tp.dtype).detach()
        tp, fp, fn, tn = tp * mask, fp * mask, fn * mask, tn * mask
    if square:
        tp, fp, fn, tn = tp ** 2, fp ** 2, fn ** 2, tn ** 2
    if axes:
        tp, fp, fn, tn = tp.sum(axes), fp.sum(axes), fn.sum(axes), tn.sum(axes)
    return tp, fp, fn, tn
