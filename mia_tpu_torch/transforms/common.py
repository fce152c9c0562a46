"""Transform algebra on batches: draw parameters, then apply them.

Counterpart of ``mia_tpu/transforms/common.py``. The JAX transforms draw
per sample from a key under ``vmap``. Here each transform splits the two
steps:

- ``draw(gen, shape, device) -> params`` draws ``(B,)`` parameter tensors
  (and gate masks) for images of ``shape`` ``(B, H, W, C)`` from an
  explicit ``torch.Generator``, on the generator's device;
- ``apply(params, images, labels)`` applies them to the whole batch.

``transform(gen, images, labels)`` does both. Tests hand ``apply`` the
same parameters the JAX functions get, which the two frameworks' random
streams could never give.

Layout: images ``(B, H, W, C)`` float32 in [0, 1]; labels ``(B, H, W)``
int64.
"""

from __future__ import annotations

import torch


def uniform(gen: torch.Generator, shape, lo: float, hi: float, device) -> torch.Tensor:
    """U(lo, hi) float32 draws, like ``jax.random.uniform(..., lo, hi)``."""
    u = torch.rand(shape, generator=gen, device=device, dtype=torch.float32)
    return u * (hi - lo) + lo


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.view(mask.shape + (1,) * (like.ndim - 1))


class Transform:
    def draw(self, gen: torch.Generator, shape: tuple, device) -> dict:
        return {}

    def apply(self, params: dict, images: torch.Tensor, labels: torch.Tensor):
        raise NotImplementedError

    def __call__(self, gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor):
        return self.apply(self.draw(gen, tuple(images.shape), images.device), images, labels)

    def get_params_dict(self) -> dict:
        return {type(self).__name__: {}}


class Identity(Transform):
    def apply(self, params, images, labels):
        return images, labels


class RandomTransform(Transform):
    """Apply ``transform`` to the samples whose gate ``u < p`` fires."""

    def __init__(self, transform: Transform, p: float):
        self.p = float(min(max(p, 0.0), 1.0))
        self.transform = transform

    def draw(self, gen, shape, device):
        fire = torch.rand(shape[0], generator=gen, device=device) < self.p
        return {"fire": fire, "inner": self.transform.draw(gen, shape, device)}

    def apply(self, params, images, labels):
        fire = params["fire"]
        out_img, out_lbl = self.transform.apply(params["inner"], images, labels)
        images = torch.where(_bcast(fire, images), out_img, images)
        labels = torch.where(_bcast(fire, labels), out_lbl, labels)
        return images, labels

    def get_params_dict(self):
        return {
            "RandomTransform": {
                "p": self.p,
                "transform": self.transform.get_params_dict(),
            }
        }


class RandomChoiceTransform(Transform):
    """Apply one of ``transforms`` per sample, picked with probabilities
    proportional to ``weight`` (``jax.random.categorical`` over the log
    weights in the JAX package). Every branch runs on the whole batch and
    each sample keeps its pick's output."""

    def __init__(self, transforms: list[Transform], weight: list | None = None):
        self.transforms = list(transforms)
        if weight is None:
            weight = [1.0] * len(transforms)
        self.weight = [float(w) for w in weight]

    def draw(self, gen, shape, device):
        probs = torch.tensor(self.weight, dtype=torch.float32, device=device)
        pick = torch.multinomial(probs, shape[0], replacement=True, generator=gen)
        return {"pick": pick, "inner": [t.draw(gen, shape, device) for t in self.transforms]}

    def apply(self, params, images, labels):
        pick = params["pick"]
        out_img, out_lbl = images, labels
        for i, (t, p) in enumerate(zip(self.transforms, params["inner"])):
            img_i, lbl_i = t.apply(p, images, labels)
            chosen = pick == i
            out_img = torch.where(_bcast(chosen, img_i), img_i, out_img)
            out_lbl = torch.where(_bcast(chosen, lbl_i), lbl_i, out_lbl)
        return out_img, out_lbl

    def get_params_dict(self):
        return {
            "RandomChoiceTransform": {
                "weights": self.weight,
                "transforms": [t.get_params_dict() for t in self.transforms],
            }
        }


class ComposeTransform(Transform):
    def __init__(self, transforms: list[Transform]):
        self.transforms = list(transforms)

    def draw(self, gen, shape, device):
        return {"stages": [t.draw(gen, shape, device) for t in self.transforms]}

    def apply(self, params, images, labels):
        for t, p in zip(self.transforms, params["stages"]):
            images, labels = t.apply(p, images, labels)
        return images, labels

    def get_params_dict(self):
        return {
            "ComposeTransform": {
                "transforms": [t.get_params_dict() for t in self.transforms]
            }
        }
