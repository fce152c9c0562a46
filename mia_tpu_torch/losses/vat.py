"""Virtual adversarial training (counterpart of ``mia_tpu/losses/vat.py``).

Power iteration on noise added to ``x`` (the image embeddings in the
CPC-SAM trainer): the gradient, with respect to the noise, of the Dice
distance between the ensembled decoder softmaxes of the perturbed and the
clean input, normalised per sample, ``ip`` times; then the same distance at
radius ``epi`` is the loss. The reference feeds softmax outputs to a Dice
loss that applies a softmax again; that double softmax is kept.
"""

from __future__ import annotations

from typing import Callable

import torch

from .dice import soft_dice_loss


def _l2_normalize(d: torch.Tensor) -> torch.Tensor:
    """Per-sample L2 norm over all non-batch dims."""
    norm = torch.linalg.norm(d.reshape(d.shape[0], -1), dim=1)
    return d / (norm.reshape((-1,) + (1,) * (d.dim() - 1)) + 1e-8)


def _ensemble_softmax(logits_list) -> torch.Tensor:
    present = [m for m in logits_list if m is not None]
    return sum(m.to(torch.float32).softmax(-1) for m in present) / max(len(present), 1)


def vat_loss(forward_fn: Callable, x: torch.Tensor, xi: float = 10.0, epi: float = 6.0,
             ip: int = 1, clean_logits_list=None, dice_kwargs: dict | None = None,
             generator: torch.Generator | None = None) -> torch.Tensor:
    """``forward_fn(x_perturbed) -> list of decoder logits`` (channel-last).

    ``clean_logits_list`` may carry the unperturbed outputs to avoid
    recomputing them. The start noise is uniform in [-0.5, 0.5) from
    ``generator`` (a generator of ``x``'s device). The power iteration's
    gradient goes to the noise only (``x`` is detached there); the returned
    loss is differentiable with respect to ``x`` and the parameters behind
    ``forward_fn``.
    """
    dice_kwargs = dice_kwargs or dict(do_bg=True)
    if clean_logits_list is None:
        clean_logits_list = forward_fn(x)
    pred = _ensemble_softmax(clean_logits_list).detach()

    def adv_distance(x_in, d_in, radius):
        # softmax outputs into a Dice loss that applies softmax again: the reference's behaviour
        return soft_dice_loss(_ensemble_softmax(forward_fn(x_in + d_in * radius)), pred,
                              softmax=True, **dice_kwargs)

    d = _l2_normalize(torch.rand(x.shape, generator=generator, device=x.device,
                                 dtype=torch.float32) - 0.5)
    for _ in range(ip):
        d.requires_grad_(True)
        with torch.enable_grad():
            (grad,) = torch.autograd.grad(adv_distance(x.detach(), d, xi), d)
        d = _l2_normalize(grad.detach())
    return adv_distance(x, d, epi)
