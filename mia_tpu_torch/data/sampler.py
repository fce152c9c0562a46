"""Batch index samplers, including the semi-supervised two-stream sampler
(``src/datasets/acdc/acdc_dataset.py:198-252``).

Copied from ``mia_tpu/data/sampler.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

import itertools

import numpy as np


class TwoStreamBatchSampler:
    """Fixed labeled/unlabeled quota per batch: primary indices once per
    epoch, secondary indices cycled eternally."""

    def __init__(
        self,
        primary_indices,
        secondary_indices,
        batch_size: int,
        secondary_batch_size: int,
        seed: int | None = None,
    ):
        self.primary_indices = list(primary_indices)
        self.secondary_indices = list(secondary_indices)
        self.secondary_batch_size = secondary_batch_size
        self.primary_batch_size = batch_size - secondary_batch_size
        self._rng = np.random.default_rng(seed)

        assert len(self.primary_indices) >= self.primary_batch_size > 0
        assert len(self.secondary_indices) >= self.secondary_batch_size > 0

    def __iter__(self):
        primary_iter = iter(self._rng.permutation(self.primary_indices))
        secondary_iter = _iterate_eternally(self.secondary_indices, self._rng)
        return (
            list(primary_batch) + list(secondary_batch)
            for primary_batch, secondary_batch in zip(
                _grouper(primary_iter, self.primary_batch_size),
                _grouper(secondary_iter, self.secondary_batch_size),
            )
        )

    def __len__(self):
        return len(self.primary_indices) // self.primary_batch_size


def _iterate_eternally(indices, rng):
    def infinite_shuffles():
        while True:
            yield rng.permutation(indices)

    return itertools.chain.from_iterable(infinite_shuffles())


def _grouper(iterable, n):
    args = [iter(iterable)] * n
    return zip(*args)
