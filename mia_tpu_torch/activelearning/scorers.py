"""Pool scoring: softmax probabilities and the entropy score.

Counterpart of ``mia_tpu/activelearning/scorers.py`` (``entropy_score``,
``ModelScorer``'s probability sweep with in-sweep z-score, ``sweep_pool``),
eager PyTorch in eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..transforms.normalization import zscore_normalize


def entropy_score(probs: torch.Tensor, smooth: float = 1e-8) -> torch.Tensor:
    """Mean over classes of -p·log2(p+eps), then spatial mean → (B,)."""
    ent = (-probs * torch.log2(probs + smooth)).mean(-1)
    return ent.mean((-2, -1))


_SCORES = {"entropy": entropy_score}


class ModelScorer:
    """Scores images with a model: uint8 images become ``/255`` floats,
    z-scored per image when ``normalize`` (the pool is scored on the inputs
    the model was trained on)."""

    def __init__(self, model: torch.nn.Module, device: torch.device, normalize: bool = False):
        self.model = model
        self.device = torch.device(device)
        self.normalize = normalize

    def _prep(self, images) -> torch.Tensor:
        images = torch.as_tensor(images).to(self.device)
        images = images.to(torch.float32) / 255.0 if images.dtype == torch.uint8 else images.to(torch.float32)
        return zscore_normalize(images) if self.normalize else images

    @torch.no_grad()
    def probs(self, images) -> torch.Tensor:
        self.model.eval()
        return torch.softmax(self.model(self._prep(images)).to(torch.float32), -1)

    def uncertainty(self, images, kind: str) -> torch.Tensor:
        if kind not in _SCORES:
            raise NotImplementedError(f"uncertainty score {kind!r} is not ported")
        return _SCORES[kind](self.probs(images))


def sweep_pool(dataset, batch_size: int, fn, device) -> tuple[np.ndarray, list[str]]:
    """Run ``fn(images) -> (B, ...)`` over a whole dataset in order; return
    the stacked outputs [N, ...] and the case names [N]."""
    from ..data.loader import BatchLoader

    loader = BatchLoader(
        dataset, batch_size, shuffle=False, drop_last=False, device=device
    )
    outputs, names = [], []
    for batch in loader:
        outputs.append(fn(batch["image"]))
        names.extend(batch["case_name"])
    return torch.cat(outputs).cpu().numpy(), names
