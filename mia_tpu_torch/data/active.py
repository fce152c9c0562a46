"""ActiveDataset: the AL labeled/pool state object
(``src/datasets/active_dataset.py``).

Copied from ``mia_tpu/data/active.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

import json
from pathlib import Path

from .base import get_path
from .common import ExtendableDataset


class ActiveDataset:
    def __init__(
        self,
        labeled_dataset: ExtendableDataset,
        pool_dataset: ExtendableDataset,
    ):
        self.labeled_dataset = labeled_dataset
        self.pool_dataset = pool_dataset

    def data_list(self) -> dict:
        return {
            "labeled_image_idx": self.labeled_dataset.image_idx,
            "pool_image_idx": self.pool_dataset.image_idx,
        }

    def save_data_list(self, save_path: Path | str):
        save_path = get_path(save_path)
        save_path.parent.mkdir(parents=True, exist_ok=True)
        with open(save_path, "w") as f:
            json.dump(self.data_list(), f)

    def load_data_list(self, data_list: Path | str | dict):
        if isinstance(data_list, (Path, str)):
            with open(data_list) as f:
                data_dict = json.load(f)
        else:
            data_dict = data_list
        self.labeled_dataset.image_idx = data_dict["labeled_image_idx"]
        self.pool_dataset.image_idx = data_dict["pool_image_idx"]

    def extend_train_set(self, new_image_idx: list | None = None):
        new_image_idx = new_image_idx or []
        self.labeled_dataset.image_idx.extend(new_image_idx)
        for idx in new_image_idx:
            self.pool_dataset.image_idx.remove(idx)

    def get_train_dataset(self) -> ExtendableDataset:
        return self.labeled_dataset

    def get_pool_dataset(self) -> ExtendableDataset:
        return self.pool_dataset

    def get_size(self) -> tuple[int, int]:
        return len(self.labeled_dataset), len(self.pool_dataset)
