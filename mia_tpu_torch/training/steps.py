"""Train / eval / predict steps, eager PyTorch.

Counterpart of ``mia_tpu/training/steps.py``: preprocess (augmentation +
z-score) → forward (BN statistics update in train mode) → loss → backward
→ global-norm clip → Adam. The JAX package jits each step into one XLA
program; here each runs eagerly, its kernels queued on the current stream.
"""

from __future__ import annotations

from typing import Callable

import torch

from .state import TrainState


def make_train_step(loss_fn: Callable, preprocess_fn: Callable | None = None):
    """Build ``step(state, images, labels, generator) -> metrics``.

    ``loss_fn(logits, labels) -> (total, ce, dice)``; ``images`` NHWC,
    ``labels`` ``(B, H, W)``. ``preprocess_fn(generator, images, labels)``
    runs first (augmentation and normalisation on the device). Metrics are
    device scalars: loss, loss_ce, loss_dice, grad_norm (before the clip).
    """

    def train_step(state: TrainState, images, labels, generator=None):
        if preprocess_fn is not None:
            images, labels = preprocess_fn(generator, images, labels)
        model = state.model
        model.train()
        logits = model(images, generator)
        total, ce, dice = loss_fn(logits, labels)
        grads = torch.autograd.grad(total, state.params)
        grad_norm = state.optimizer.step(grads)
        state.step += 1
        return {
            "loss": total.detach(),
            "loss_ce": ce.detach(),
            "loss_dice": dice.detach(),
            "grad_norm": grad_norm,
        }

    return train_step


@torch.no_grad()
def eval_step(state: TrainState, images) -> torch.Tensor:
    """Softmax probabilities ``(B, H, W, K)`` in eval mode."""
    state.model.eval()
    return torch.softmax(state.model(images).to(torch.float32), -1)


@torch.no_grad()
def predict(state: TrainState, images):
    """``(probs, argmax)`` in eval mode."""
    probs = eval_step(state, images)
    return probs, probs.argmax(-1)
