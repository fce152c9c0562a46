"""Dataset views: ExtendableDataset and ImageDataset
(``src/datasets/common.py``).

Copied from ``mia_tpu/data/common.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from .base import BaseDataset, host_joint_resize, load_image_grayscale


class ExtendableDataset(BaseDataset):
    """View over a base dataset keyed by a mutable case-name list — the AL
    unit of labeled/pool membership (``common.py:12-40``).

    The reference builds ``case_name_to_idx`` by loading every sample once;
    here datasets expose ``case_names()`` so registration is I/O-free.
    """

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        raise RuntimeError("ExtendableDataset does not have find_samples function")

    def __init__(self, dataset: BaseDataset, image_idx: list | None = None):
        self.dataset = dataset
        names = dataset.case_names()
        self.case_name_to_idx = {name: i for i, name in enumerate(names)}
        if image_idx is None:
            image_idx = list(self.case_name_to_idx.keys())
        self.image_idx = image_idx

    def __len__(self):
        return len(self.image_idx)

    def get_sample(self, index: int, normalize: bool = True):
        case_name = self.image_idx[index]
        return self.dataset.get_sample(self.case_name_to_idx[case_name], normalize)

    def case_names(self) -> list[str]:
        return list(self.image_idx)


class ImageDataset(BaseDataset):
    """Label-less image list used by the interactive demo
    (``common.py:43-102``): zero labels, case_name = path."""

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        raise RuntimeError("ImageDataset does not have find_samples function")

    def __init__(
        self,
        samples_list: list,
        normalize: Callable | None = None,
        transform: Callable | None = None,
        image_channels: int = 3,
        image_size: int | tuple[int, int] | None = None,
    ):
        self.samples_list = samples_list
        self.normalize = normalize
        self.transform = transform
        self.image_channels = image_channels
        self.image_size = image_size

    def get_sample(self, index: int, normalize: bool = True) -> dict:
        image_path = self.samples_list[index]
        image = load_image_grayscale(image_path, self.image_channels)
        label = np.zeros(image.shape[:2], dtype=np.int32)
        data = {"image": image, "label": label}
        data = self._finalize(data, normalize)
        data["case_name"] = str(image_path)
        return data
