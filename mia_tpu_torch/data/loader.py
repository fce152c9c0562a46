"""Host → device batch pipeline in PyTorch.

Counterpart of ``mia_tpu/data/loader.py``: a thread-prefetching loader that
decodes and collates numpy batches and, with a ``device``, stages them on
it while the previous step computes. Datasets with per-sample paths, a
fixed image size and no host transform keep decoded samples in a cache on
the base dataset under a byte budget (``MIA_DECODE_CACHE_MB``, default
2048); they decode with the native C++ decoder (``mia_tpu_torch.native``,
the JAX package's ``native/mia_host.cpp``) into uint8 images when its
library builds, else with PIL into float32 images (4x the bytes per
host-to-device copy); ``decode_path()`` names the mode in use. For a CUDA
device the batch is copied into pinned host memory and sent with a
non-blocking copy. Augmentation is not done here: it runs on the device
inside the train step.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from .. import native
from .base import BaseDataset

# guards decoded-cache creation/inserts/byte accounting across loader
# prefetch threads (decode itself runs outside the lock)
_DECODE_CACHE_LOCK = threading.Lock()


def collate(samples: list[dict]) -> dict:
    """Stack a list of sample dicts into batch arrays (case names as list)."""
    out: dict = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        elif isinstance(vals[0], (int, float)):
            out[key] = np.asarray(vals)
        else:
            out[key] = vals
    return out


def _decode_cache_budget_bytes() -> int:
    try:
        return int(os.environ.get("MIA_DECODE_CACHE_MB", "2048")) * 2 ** 20
    except ValueError:
        return 2048 * 2 ** 20


def decode_path() -> str:
    """The decode mode of the cached path, for logs and reports."""
    if native.is_available():
        return "native C++ decoder, uint8 images"
    return f"PIL, float32 images (native decoder unavailable: {native.unavailable_reason()})"


def _decode(base, indices: list[int]) -> list[tuple] | None:
    """(image, uint8 label) pairs of ``base``'s samples at ``indices``."""
    if not native.is_available():
        out = []
        for i in indices:
            s = base.get_sample(i)
            out.append((s["image"].astype(np.float32), s["label"].astype(np.uint8)))
        return out
    size = base.image_size
    if isinstance(size, int):
        size = (size, size)
    paths = [base.sample_paths(i) for i in indices]
    try:
        images, labels = native.load_image_batch(
            [p[0] for p in paths],
            [p[1] for p in paths],
            image_size=tuple(size),
            channels=getattr(base, "image_channels", 3),
        )
    except RuntimeError:  # a file the native decoder cannot read: PIL path
        return None
    # byte-valued PNG sources: rounding the float resize back to uint8
    # matches PIL's uint8 resize and ships 4x fewer bytes
    images = np.clip(np.rint(images * 255.0), 0, 255).astype(np.uint8)
    labels = labels.astype(np.uint8)  # class ids < 256
    return list(zip(images, labels))


def to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """numpy → tensor on ``device``; pinned + non-blocking for CUDA."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class BatchLoader:
    """Iterates batches from a dataset.

    ``shuffle`` + ``drop_last`` mirror the reference train loader and use
    the same numpy permutation as the JAX package's loader for a given
    ``seed``; ``oversample`` replicates a labeled set smaller than one batch.
    With ``device`` set, ``image`` and ``label`` arrive as tensors on it
    (labels compacted to uint8 first); with ``device=None`` they stay numpy.
    """

    def __init__(
        self,
        dataset: BaseDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int | None = None,
        sampler: Iterable | None = None,
        device: torch.device | str | None = None,
        num_prefetch: int = 2,
        oversample: bool = False,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.sampler = sampler
        self.device = torch.device(device) if device is not None else None
        self.num_prefetch = num_prefetch
        self.oversample = oversample
        self._rng = np.random.default_rng(seed)

    def _index_batches(self) -> Iterator[list[int]]:
        if self.sampler is not None:
            yield from self.sampler
            return
        n = len(self.dataset)
        idx = list(range(n))
        if self.oversample and 0 < n < self.batch_size:
            idx = idx * int(np.ceil(self.batch_size / n))
        if self.shuffle:
            idx = list(self._rng.permutation(idx))
        num_full = len(idx) // self.batch_size
        for b in range(num_full):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]
        rem = len(idx) % self.batch_size
        if rem and not self.drop_last:
            yield idx[num_full * self.batch_size :]

    def __len__(self):
        if self.sampler is not None and hasattr(self.sampler, "__len__"):
            return len(self.sampler)
        n = len(self.dataset)
        if self.oversample and 0 < n < self.batch_size:
            n = int(np.ceil(self.batch_size / n)) * n
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _cached_batch(self, indices: list[int]) -> dict | None:
        """Batch from the decoded-sample cache of the base dataset, for
        datasets exposing ``sample_paths`` with a fixed ``image_size`` and
        no host transform/normalize (so a decoded sample never changes);
        None otherwise. Misses decode natively when the native library is
        available (uint8 images), else through the dataset's own PIL path
        (float32 images)."""
        ds = self.dataset
        base = getattr(ds, "dataset", ds)  # unwrap ExtendableDataset views
        if (
            getattr(base, "transform", None) is not None
            or getattr(base, "normalize", None) is not None
            or getattr(base, "image_size", None) is None
            or not hasattr(base, "sample_paths")
        ):
            return None
        if base is ds:
            base_indices = [int(i) for i in indices]
        else:
            base_indices = [ds.case_name_to_idx[ds.image_idx[int(i)]] for i in indices]

        with _DECODE_CACHE_LOCK:
            cache = getattr(base, "_decoded_cache", None)
            if cache is None:
                cache = base._decoded_cache = {}
                base._decoded_cache_bytes = 0
        budget = _decode_cache_budget_bytes()
        miss = [i for i in dict.fromkeys(base_indices) if i not in cache]
        local: dict[int, tuple] = {}
        if miss:
            decoded = _decode(base, miss)
            if decoded is None:
                return None
            for i, pair in zip(miss, decoded):
                with _DECODE_CACHE_LOCK:
                    if i in cache:
                        continue
                    if base._decoded_cache_bytes < budget:
                        cache[i] = pair
                        base._decoded_cache_bytes += pair[0].nbytes + pair[1].nbytes
                    else:  # over budget: keep batch-local only
                        local[i] = pair
        pairs = [local[i] if i in local else cache[i] for i in base_indices]
        return {
            "image": np.stack([p[0] for p in pairs]),
            "label": np.stack([p[1] for p in pairs]),
            "case_name": [base.samples_list[i] for i in base_indices],
        }

    def _load_batch(self, indices: list[int]) -> dict:
        batch = self._cached_batch(indices)
        if batch is None:
            batch = collate([self.dataset.get_sample(int(i)) for i in indices])
        if self.device is not None:
            lbl = np.asarray(batch["label"])
            if lbl.dtype.itemsize > 1 and lbl.min() >= 0 and lbl.max() < 256:
                batch["label"] = lbl.astype(np.uint8)
            for key in ("image", "label"):
                batch[key] = to_device(np.asarray(batch[key]), self.device)
        return batch

    def __iter__(self) -> Iterator[dict]:
        if self.num_prefetch <= 0:
            for indices in self._index_batches():
                yield self._load_batch(indices)
            return

        q: queue.Queue = queue.Queue(maxsize=self.num_prefetch)
        sentinel = object()
        error: list[BaseException] = []
        stop = threading.Event()

        def producer():
            try:
                for indices in self._index_batches():
                    if stop.is_set():
                        break
                    q.put(self._load_batch(indices))
            except BaseException as e:  # handed to the consumer, re-raised there
                error.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                yield item
        finally:
            # consumer stopped early (break / error): let the producer finish
            stop.set()
            while t.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            t.join()
        if error:
            raise error[0]
