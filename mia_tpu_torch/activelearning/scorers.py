"""Pool scoring: the uncertainty scores, the bottleneck features and BADGE's
gradient embeddings.

Counterpart of ``mia_tpu/activelearning/scorers.py`` (``entropy_score``,
``confidence_score``, ``margin_score``, ``ModelScorer`` with its in-sweep
z-score, ``sweep_pool``), eager PyTorch in eval mode.
"""

from __future__ import annotations

import numpy as np
import torch

from ..losses import cross_entropy, soft_dice_loss
from ..transforms.normalization import zscore_normalize


def entropy_score(probs: torch.Tensor, smooth: float = 1e-8) -> torch.Tensor:
    """Mean over classes of -p·log2(p+eps), then spatial mean → (B,)."""
    ent = (-probs * torch.log2(probs + smooth)).mean(-1)
    return ent.mean((-2, -1))


def confidence_score(probs: torch.Tensor) -> torch.Tensor:
    """Least confidence: spatial mean of -max_c p → (B,)."""
    return (-probs.amax(-1)).mean((-2, -1))


def margin_score(probs: torch.Tensor) -> torch.Tensor:
    """Spatial mean of -(top1 - top2) → (B,)."""
    top2 = torch.topk(probs, 2, dim=-1).values
    return (-(top2[..., 0] - top2[..., 1])).mean((-2, -1))


_SCORES = {
    "entropy": entropy_score,
    "confidence": confidence_score,
    "margin": margin_score,
}


class ModelScorer:
    """Scores images with a model: uint8 images become ``/255`` floats,
    z-scored per image when ``normalize`` (the pool is scored on the inputs
    the model was trained on). The AL trainer keeps one scorer for the run
    and points ``model`` at each round's model."""

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
        return _SCORES[kind](self.probs(images))

    @torch.no_grad()
    def enc_feature(self, images) -> torch.Tensor:
        """Bottleneck features averaged over space, ``(B, C)``."""
        self.model.eval()
        return self.model.enc_feature(self._prep(images)).to(torch.float32)

    def badge_grad_embedding(self, images, preds=None) -> torch.Tensor:
        """Per image, the gradient of ``CE + soft Dice (with background)``
        against the model's own argmax (or the label maps ``preds`` given,
        ``(B, H, W)``) with respect to the seg head's 1×1 weight, flattened
        in flax's ``(Cin, Cout)`` order → ``(B, Cin·Cout)``.

        The head is linear in the pre-head features ``f``, so the weight
        gradient of image b is ``Σ_pixels f ⊗ ∂L_b/∂logits``: one forward,
        then one backward through the loss alone. Both losses of a batch are
        the mean of the per-image losses, so ``B`` times the batch loss gives
        each image its own gradient."""
        self.model.eval()
        with torch.no_grad():
            logits, feature = self.model.pixel_feature(self._prep(images))
        logits = logits.to(torch.float32).requires_grad_(True)
        if preds is None:
            preds = logits.detach().argmax(-1)
        with torch.enable_grad():
            loss = cross_entropy(logits, preds) + soft_dice_loss(logits, preds, do_bg=True)
            (g,) = torch.autograd.grad(loss * logits.shape[0], logits)
        # in the model's compute dtype, as the head's weight gradient is there
        emb = torch.einsum("bhwc,bhwk->bck", feature, g.to(feature.dtype)).to(torch.float32)
        return emb.reshape(emb.shape[0], -1)


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
