"""Active-learning selectors (counterpart of
``mia_tpu/activelearning/selectors.py``): ``RandomSelector`` and
``EntropySelector``. API: ``select_next_batch(active_dataset, select_num,
scorer, seed) -> list[case_name]``; both fall back to a uniform-random pick
when the labeled set is empty, like the reference.
"""

from __future__ import annotations

import numpy as np

from .scorers import ModelScorer, sweep_pool


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


class RandomSelector(ActiveSelector):
    def __init__(self, **_):
        pass  # accepts (and ignores) the common selector kwargs

    def select_next_batch(self, active_dataset, select_num, scorer=None, seed=None):
        return self._random_pick(active_dataset, select_num, seed)


class EntropySelector(ActiveSelector):
    KIND = "entropy"

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


# confidence, margin, coreset, k-means++ and BADGE are not ported yet
SELECTORS = {"random": RandomSelector, "entropy": EntropySelector}
