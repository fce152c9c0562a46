"""Train state and the optimizer, with optax's exact update order.

Counterpart of ``mia_tpu/training/state.py``. The JAX package chains
``clip_by_global_norm(10)`` → ``add_decayed_weights(wd)`` →
``scale_by_adam(0.9, 0.999, 1e-8)`` → ``-lr(step)``. This module applies
the same four steps to PyTorch parameters:

- the clip is optax's (``g`` if ``norm < max`` else ``g / norm * max``),
  NOT ``torch.nn.utils.clip_grad_norm_``, which adds 1e-6 to the norm;
- the L2 weight decay is added to the gradient after the clip, as torch's
  ``Adam(weight_decay=...)`` and optax's chain both do;
- Adam's bias corrections divide the moments before the square root, as
  optax does.

Only ``adam`` is ported.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn as nn

# torch-parity Adam betas and eps (reference ``al_trainer.py:744-765``)
B1, B2, EPS = 0.9, 0.999, 1e-8


class ClippedAdam:
    """Global-norm clip + L2 decay + Adam + scheduled learning rate."""

    def __init__(
        self,
        params,
        learning_rate: float | Callable[[int], float],
        grad_clip: float | None = 10.0,
        weight_decay: float = 0.0,
    ):
        self.params = [p for p in params if p.requires_grad]
        self.lr = learning_rate if callable(learning_rate) else (lambda _: learning_rate)
        self.grad_clip = grad_clip
        self.weight_decay = weight_decay
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads) -> torch.Tensor:
        """Apply one update from ``grads`` (one per param); return the
        pre-clip global gradient norm (a device scalar)."""
        grads = list(grads)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        if self.grad_clip is not None:
            keep = norm < self.grad_clip
            grads = [torch.where(keep, g, g / norm * self.grad_clip) for g in grads]
        lr = self.lr(self.count)
        self.count += 1
        bc1 = 1.0 - B1**self.count
        bc2 = 1.0 - B2**self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            if self.weight_decay:
                g = g + self.weight_decay * p
            mu.mul_(B1).add_(g, alpha=1.0 - B1)
            nu.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            update = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            p.add_(update, alpha=-lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": self.mu, "nu": self.nu}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Restore the step count and both moments (copied into place)."""
        if len(state["mu"]) != len(self.mu) or len(state["nu"]) != len(self.nu):
            raise ValueError(f"optimizer state has {len(state['mu'])} moment tensors, "
                             f"expected {len(self.mu)}")
        self.count = int(state["count"])
        for dst, src in zip((*self.mu, *self.nu), (*state["mu"], *state["nu"])):
            dst.copy_(src)


def make_optimizer(
    name: str,
    params,
    learning_rate: float | Callable[[int], float] = 1e-3,
    grad_clip: float | None = 10.0,
    weight_decay: float = 0.0,
) -> ClippedAdam:
    if name != "adam":
        raise NotImplementedError(f'optimizer "{name}" is not ported (use adam)')
    return ClippedAdam(params, learning_rate, grad_clip, weight_decay)


class TrainState:
    """The model (parameters + BN buffers), its optimizer and the step."""

    def __init__(self, model: nn.Module, optimizer: ClippedAdam):
        self.model = model
        self.optimizer = optimizer
        self.step = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params
