"""Train state and the optimizers, with optax's exact update order.

Counterpart of ``mia_tpu/training/state.py``. Every optimizer of the JAX
package starts with ``clip_by_global_norm(10)`` and ends with ``-lr(step)``;
between them

- ``adam``: ``add_decayed_weights(wd)`` → ``scale_by_adam(0.9, 0.999, 1e-8)``
  (torch's ``Adam(weight_decay=...)``: L2 into the gradient after the clip);
- ``adamw``: ``scale_by_adam`` → ``add_decayed_weights(wd)`` (decoupled decay:
  ``p -= lr · (adam_update + wd · p)``);
- ``sgd``: ``add_decayed_weights(wd)`` → ``trace(0.9)`` (momentum without
  dampening or Nesterov: ``t = g + 0.9 · t``).

This module applies the same steps to PyTorch parameters:

- the clip is optax's (``g`` if ``norm < max`` else ``g / norm * max``),
  NOT ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm;
- Adam's bias corrections divide the moments before the square root, as
  optax does.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

# torch-parity Adam betas and eps, SGD momentum (reference ``al_trainer.py:744-765``)
B1, B2, EPS = 0.9, 0.999, 1e-8
MOMENTUM = 0.9


class ClippedAdam:
    """Global-norm clip + weight decay + Adam + scheduled learning rate.
    ``decoupled`` applies the decay to the update (adamw) instead of the
    gradient (adam)."""

    def __init__(
        self,
        params,
        learning_rate: float | Callable[[int], float],
        grad_clip: float | None = 10.0,
        weight_decay: float = 0.0,
        decoupled: bool = False,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.lr = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.decoupled = decoupled
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = self._second_moments()

    def _second_moments(self) -> list[torch.Tensor]:
        return [torch.zeros_like(p) for p in self.params]

    def _clipped(self, grads):
        """optax's global-norm clip → (grads, pre-clip norm)."""
        grads = list(grads)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        if self.grad_clip is not None:
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm * self.grad_clip) for g in grads]
        return grads, norm

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """Apply one update from ``grads`` (one per param); return the
        pre-clip global gradient norm (a device scalar)."""
        grads, norm = self._clipped(grads)
        lr = self.lr(self.count)
        self.count += 1
        bc1 = 1.0 - B1**self.count
        bc2 = 1.0 - B2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if self.weight_decay and not self.decoupled:
                g = g + self.weight_decay * p
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            if self.weight_decay and self.decoupled:
                update = update + self.weight_decay * p
            p.add_(update, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore the step count and the moments (copied into place)."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError(f"optimizer state has {len(state['mu'])} moment tensors, "
                             f"expected {len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip((*self.mu, *self.nu), (*state["mu"], *state["nu"])):
            dst.copy_(src)


class ClippedSGD(ClippedAdam):
    """Global-norm clip + L2 decay + momentum 0.9 + scheduled learning rate;
    ``mu`` is optax's trace, ``nu`` stays empty."""

    def _second_moments(self) -> list[torch.Tensor]:
        return []

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        grads, norm = self._clipped(grads)
        lr = self.lr(self.count)
        self.count += 1
        for p, g, trace in zip(self.params, grads, self.mu):
            if self.weight_decay:
                g = g + self.weight_decay * p
            trace.mul_(MOMENTUM).add_(g)
            p.add_(trace, alpha=-lr)
        return norm


def make_optimizer(
    name: str,
    params,
    learning_rate: float | Callable[[int], float] = 1e-3,
    grad_clip: float | None = 10.0,
    weight_decay: float = 0.0,
) -> ClippedAdam:
    if name == "adam":
        return ClippedAdam(params, learning_rate, grad_clip, weight_decay)
    if name == "adamw":
        return ClippedAdam(params, learning_rate, grad_clip, weight_decay, decoupled=True)
    if name == "sgd":
        return ClippedSGD(params, learning_rate, grad_clip, weight_decay)
    raise ValueError(f'Optimizer "{name}" not supported')


class TrainState:
    """The model (parameters + BN buffers), its optimizer and the step."""

    def __init__(self, model: nn.Module, optimizer: ClippedAdam):
        self.model = model
        self.optimizer = optimizer
        self.step = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params
