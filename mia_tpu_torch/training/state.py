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

:func:`to_optax_state` and :func:`load_optax_state` carry the state of a
UNet's optimizer (what the trainers train) to and from the tree that
``flax.serialization.to_state_dict`` makes of the JAX package's optax state
(its ``opt_state.msgpack``): the moments keyed by flax parameter path, with
the parameters' transposes.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn as nn

from ..models.flax_bridge import unet_state_dict_from_flax, unet_state_dict_to_flax

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
        # optax keeps a step count for a schedule, none for a constant rate
        self.scheduled = callable(learning_rate)
        self.lr = learning_rate if self.scheduled else (lambda _: learning_rate)
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


def _param_names(opt: ClippedAdam, model: nn.Module) -> list[str]:
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    if len(named) != len(opt.params) or any(p is not q for (_, p), q in zip(named, opt.params)):
        raise ValueError("the optimizer does not hold the model's trainable parameters in order")
    return [n for n, _ in named]


def _layout(opt: ClippedAdam, moments: dict) -> dict:
    """optax's state tree of ``opt`` around ``moments`` (``count`` with ``mu``
    and ``nu``, or ``trace``): ``clip_by_global_norm`` → [decay] → adam or
    trace → [decay] → learning rate, as ``mia_tpu/training/state.py`` chains
    them; a schedule keeps a count, a constant rate nothing."""
    rate = {"count": np.asarray(opt.count, np.int32)} if opt.scheduled else {}
    if isinstance(opt, ClippedSGD):
        inner = {"0": {}, "1": {"0": moments, "1": rate}}
    elif opt.decoupled:  # optax.adamw: adam → decay → learning rate
        inner = {"0": moments, "1": {}, "2": rate}
    else:
        inner = {"0": {}, "1": moments, "2": rate}
    return inner if opt.grad_clip is None else {"0": {}, "1": inner}


def _nodes(opt: ClippedAdam, state: dict) -> tuple[dict, dict]:
    """The moments node and the learning-rate node of a tree laid out by :func:`_layout`."""
    inner = state if opt.grad_clip is None else state["1"]
    if isinstance(opt, ClippedSGD):
        return inner["1"]["0"], inner["1"]["1"]
    if opt.decoupled:
        return inner["0"], inner["2"]
    return inner["1"], inner["2"]


def to_optax_state(opt: ClippedAdam, model: nn.Module) -> dict:
    """``opt``'s state over the UNet ``model`` as the flax state dict of the
    JAX package's optax state for the same optimizer (``opt_state.msgpack``)."""
    names = _param_names(opt, model)

    def tree(tensors):
        return unet_state_dict_to_flax(dict(zip(names, tensors)))["params"]

    if isinstance(opt, ClippedSGD):
        return _layout(opt, {"trace": tree(opt.mu)})
    return _layout(opt, {"count": np.asarray(opt.count, np.int32), "mu": tree(opt.mu),
                         "nu": tree(opt.nu)})


def load_optax_state(opt: ClippedAdam, model: nn.Module, state: dict) -> None:
    """Restore ``opt`` from an optax state dict (the inverse of
    :func:`to_optax_state`). SGD at a constant rate keeps no count: ``opt``'s
    stays as it is."""
    names = _param_names(opt, model)
    moments, rate = _nodes(opt, state)

    def tensors(tree):
        sd = unet_state_dict_from_flax({"params": tree})
        return [sd[n] for n in names]

    sgd = isinstance(opt, ClippedSGD)
    count = rate.get("count", opt.count) if sgd else moments["count"]
    opt.load_state_dict({"count": int(count), "mu": tensors(moments["trace" if sgd else "mu"]),
                         "nu": [] if sgd else tensors(moments["nu"])})


class TrainState:
    """The model (parameters + BN buffers), its optimizer and the step."""

    def __init__(self, model: nn.Module, optimizer: ClippedAdam):
        self.model = model
        self.optimizer = optimizer
        self.step = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.optimizer.params
