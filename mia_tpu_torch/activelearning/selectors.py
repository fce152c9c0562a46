"""Active-learning selectors (counterpart of
``mia_tpu/activelearning/selectors.py``).

API: ``select_next_batch(active_dataset, select_num, scorer, seed) ->
list[case_name]``. ``scorer`` is a ``ModelScorer`` or ``None`` where the
reference passes no model. The uncertainty, coreset and BADGE selectors fall
back to a uniform-random pick when the labeled set is empty, like the
reference; k-means runs k-means++ on the pool without weights then.

Features, distances, k-center greedy and k-means++ run on the scorer's
device (the CPU without a scorer). k-means++ draws from
``torch.Generator().manual_seed(seed or 0)`` where the JAX package uses
``PRNGKey(seed or 0)``, so its picks over a run differ between the
packages; ``selection.kmeans_plusplus_from_draws`` given the same draws
picks the same.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..ops.distance import pairwise_distances
from .scorers import ModelScorer, sweep_pool
from .selection import kcenter_greedy, kmeans_plusplus


class ActiveSelector:
    def select_next_batch(self, active_dataset, select_num, scorer, seed=None) -> list:
        raise NotImplementedError

    @staticmethod
    def _random_pick(active_dataset, select_num, seed):
        """Uniform-random top-k over the pool (cold-start fallback)."""
        pool = active_dataset.pool_dataset.image_idx
        rng = np.random.default_rng(seed)
        scores = rng.random(len(pool))
        order = np.argsort(-scores)
        return [pool[i] for i in order[:select_num]]

    @staticmethod
    def _device(scorer) -> torch.device:
        return torch.device("cpu") if scorer is None else scorer.device

    @staticmethod
    def _generator(seed) -> torch.Generator:
        return torch.Generator().manual_seed(seed or 0)


class RandomSelector(ActiveSelector):
    def __init__(self, **_):
        pass  # accepts (and ignores) the common selector kwargs

    def select_next_batch(self, active_dataset, select_num, scorer=None, seed=None):
        return self._random_pick(active_dataset, select_num, seed)


class _UncertaintySelector(ActiveSelector):
    KIND = ""

    def __init__(self, batch_size: int = 8, **_):
        self.batch_size = batch_size

    def select_next_batch(self, active_dataset, select_num, scorer: ModelScorer, seed=None):
        labeled_size, _ = active_dataset.get_size()
        if labeled_size == 0:
            return self._random_pick(active_dataset, select_num, seed)
        scores, case_names = sweep_pool(
            active_dataset.get_pool_dataset(),
            self.batch_size,
            lambda images: scorer.uncertainty(images, self.KIND),
            scorer.device,
        )
        order = np.argsort(-scores, kind="stable")
        return [case_names[i] for i in order[:select_num]]


class EntropySelector(_UncertaintySelector):
    KIND = "entropy"


class ConfidenceSelector(_UncertaintySelector):
    KIND = "confidence"


class MarginSelector(_UncertaintySelector):
    KIND = "margin"


def _load_features(case_names, feature_path=None, feature_dict=None):
    """Per-case foundation features from ``<feature_path>/<case>.h5`` files
    (dataset ``feature``) or an in-memory dict, stacked as float32; ``None``
    when neither is given."""
    if feature_path is not None:
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                "feature_path needs h5py, which is not installed; pass the "
                "features as feature_dict instead"
            ) from e
        feats = []
        for case in case_names:
            with h5py.File(Path(feature_path) / f"{case}.h5", "r") as h5f:
                feats.append(np.asarray(h5f["feature"]))
        return np.stack(feats, axis=0).astype(np.float32)
    if feature_dict is not None:
        return np.stack([np.asarray(feature_dict[c]) for c in case_names]).astype(np.float32)
    return None


def _zscore_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-sample z-score across the feature axis, numpy's biased std."""
    return (x - x.mean(1, keepdim=True)) / x.std(1, keepdim=True, unbiased=False)


class CoresetSelector(ActiveSelector):
    """k-center greedy over model bottleneck features ± loaded foundation
    features, fused by a normalized-distance blend ("add") or a scaled
    concatenation ("cat")."""

    def __init__(
        self,
        batch_size: int = 8,
        metric: str = "cosine",
        coreset_criteria: str = "min",
        coreset_fusion: str = "add",
        feature_path=None,
        loaded_feature_weight: float = 0.0,
        **_,
    ):
        self.batch_size = batch_size
        self.metric = metric
        self.coreset_criteria = coreset_criteria
        self.coreset_fusion = coreset_fusion
        self.feature_path = feature_path
        self.loaded_feature_weight = loaded_feature_weight

    def _features_and_dist(self, active_dataset, scorer, device):
        labeled = active_dataset.get_train_dataset()
        pool = active_dataset.get_pool_dataset()
        core_list = list(labeled.image_idx)
        all_list = core_list + list(pool.image_idx)

        feats = None
        if scorer is not None:
            feats_l, _ = sweep_pool(labeled, self.batch_size, scorer.enc_feature, device)
            feats_p, _ = sweep_pool(pool, self.batch_size, scorer.enc_feature, device)
            feats = torch.from_numpy(np.concatenate([feats_l, feats_p], axis=0)).to(device)

        loaded = _load_features(all_list, self.feature_path)
        if loaded is not None:
            loaded = torch.from_numpy(loaded).to(device)

        w = self.loaded_feature_weight
        if self.coreset_fusion == "add":
            final = 0.0
            if loaded is not None:
                d = pairwise_distances(loaded, metric=self.metric)
                final = final + w * (d / d.sum())
            if feats is not None:
                d = pairwise_distances(feats, metric=self.metric)
                final = final + (1 - w) * (d / d.sum())
        else:
            parts = [] if feats is None else [feats]
            if loaded is not None:
                scale = 1.0 if feats is None else np.sqrt(feats.shape[-1] / loaded.shape[-1] * w)
                parts.append(loaded * scale)
            final = pairwise_distances(torch.cat(parts, 1), metric=self.metric)
        return core_list, np.array(all_list), loaded, final

    def select_next_batch(self, active_dataset, select_num, scorer, seed=None):
        labeled_size, _ = active_dataset.get_size()
        if labeled_size == 0 and self.loaded_feature_weight == 0:
            return self._random_pick(active_dataset, select_num, seed)
        device = self._device(scorer)
        if labeled_size == 0:
            if self.feature_path:
                # cold start: k-means++ on the loaded foundation features
                _, all_list, loaded, _ = self._features_and_dist(active_dataset, None, device)
                idx = kmeans_plusplus(loaded, select_num, self._generator(seed))
                return list(all_list[idx.cpu().numpy()])
            return self._random_pick(active_dataset, select_num, seed)

        core_list, all_list, _, dist = self._features_and_dist(active_dataset, scorer, device)
        init_mask = torch.arange(len(all_list), device=device) < len(core_list)
        picks = kcenter_greedy(dist, init_mask, select_num, self.coreset_criteria)
        return list(all_list[picks.cpu().numpy()])


class KMeanSelector(ActiveSelector):
    """Weighted k-means++ over z-scored model ⊕ loaded features, the
    pool→labeled distance (min or mean) sharpened by a power or a softmax as
    the sample weight."""

    def __init__(
        self,
        batch_size: int = 8,
        metric: str = "cosine",
        feature_path=None,
        feature_dict: dict | None = None,
        coreset_criteria: str = "min",
        loaded_feature_weight: float = 1.0,
        loaded_feature_only: bool = False,
        sharp_factor: float = 1.0,
        softmax: bool = False,
        **_,
    ):
        self.batch_size = batch_size
        self.metric = metric
        self.feature_path = feature_path
        self.feature_dict = feature_dict
        self.coreset_criteria = coreset_criteria
        self.loaded_feature_weight = loaded_feature_weight
        self.loaded_feature_only = loaded_feature_only
        self.sharp_factor = sharp_factor
        self.softmax = softmax

    def _get_features(self, dataset, scorer, device):
        case_names = dataset.case_names()
        parts = []
        feats = None
        if scorer is not None and not self.loaded_feature_only:
            feats, case_names = sweep_pool(dataset, self.batch_size, scorer.enc_feature, device)
            feats = _zscore_rows(torch.from_numpy(feats).to(device))
            parts.append(feats)
        loaded = _load_features(case_names, self.feature_path, self.feature_dict)
        if loaded is not None:
            loaded = _zscore_rows(torch.from_numpy(loaded).to(device))
            scale = (1.0 if feats is None else
                     np.sqrt(feats.shape[-1] / loaded.shape[-1] * self.loaded_feature_weight))
            parts.append(loaded * scale)
        return torch.cat(parts, 1), np.array(case_names)

    def select_next_batch(self, active_dataset, select_num, scorer, seed=None):
        device = self._device(scorer)
        labeled_size, _ = active_dataset.get_size()
        pool_feats, pool_case_names = self._get_features(
            active_dataset.get_pool_dataset(), scorer, device
        )

        sample_weight = None
        if labeled_size > 0:
            labeled_feats, _ = self._get_features(active_dataset.get_train_dataset(), scorer, device)
            d = pairwise_distances(pool_feats, labeled_feats, self.metric)
            w = d.amin(1) if self.coreset_criteria == "min" else d.mean(1)
            if self.softmax:
                e = torch.exp(w * self.sharp_factor - (w * self.sharp_factor).max())
                sample_weight = e / e.sum()
            else:
                w = w**self.sharp_factor
                sample_weight = w / w.sum()

        idx = kmeans_plusplus(pool_feats, select_num, self._generator(seed), sample_weight)
        # k-means++ can repeat an index: keep the first of each, in order
        out = []
        for i in idx.cpu().tolist():
            if pool_case_names[i] not in out:
                out.append(pool_case_names[i])
        return out


class BADGESelector(ActiveSelector):
    """k-means++ over per-image seg-head gradient embeddings."""

    def __init__(self, batch_size: int = 1, multiple_loss: str = "add", **_):
        self.batch_size = batch_size
        self.multiple_loss = multiple_loss

    def select_next_batch(self, active_dataset, select_num, scorer, seed=None):
        labeled_size, _ = active_dataset.get_size()
        if labeled_size == 0:
            return self._random_pick(active_dataset, select_num, seed)
        embeds, case_names = sweep_pool(
            active_dataset.get_pool_dataset(),
            self.batch_size,
            scorer.badge_grad_embedding,
            scorer.device,
        )
        idx = kmeans_plusplus(torch.from_numpy(embeds).to(scorer.device), select_num,
                              self._generator(seed))
        # no dedup, as in the reference: a repeated index is picked twice
        return [case_names[i] for i in idx.cpu().tolist()]


SELECTORS = {
    "random": RandomSelector,
    "entropy": EntropySelector,
    "confidence": ConfidenceSelector,
    "margin": MarginSelector,
    "coreset-l2": lambda **kw: CoresetSelector(metric="l2", **kw),
    "coreset-cosine": lambda **kw: CoresetSelector(metric="cosine", **kw),
    "kmean-l2": lambda **kw: KMeanSelector(metric="l2", **kw),
    "kmean-cosine": lambda **kw: KMeanSelector(metric="cosine", **kw),
    "badge": BADGESelector,
}
