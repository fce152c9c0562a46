"""BUSI breast ultrasound dataset (``src/datasets/busi/busi_dataset.py``).

Layout: ``{images,labels}/*.png`` + ``split.json`` with integer ids formatted
``%04d``; classes bg / tumor; test == valid split (reference TODO at
``busi_dataset.py:109-112``).

Copied from ``mia_tpu/data/busi.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader). ``process_label`` labels 8-connected components
with ``scipy.ndimage`` (a 3×3 structure of ones), as
``skimage.measure.label(connectivity=2)`` does in the JAX package.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import numpy as np

from .base import BaseDataset, get_path, load_image_grayscale, load_label


class BUSIDataset(BaseDataset):
    CLASSES = {0: "bg", 1: "tumor"}
    IMAGES_DIR = "images"
    LABELS_DIR = "labels"
    SPLIT_FILE = "split.json"
    NUM_CLASSES = 1

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        data_path = get_path(data_path)
        images_dir = data_path / BUSIDataset.IMAGES_DIR
        labels_dir = data_path / BUSIDataset.LABELS_DIR
        samples = []
        for image_path in sorted(images_dir.glob("*.jpg")):
            if not image_path.is_file():
                continue
            label_path = labels_dir / image_path.name
            labeled = label_path.is_file()
            if require_label and not labeled:
                continue
            samples.append(
                {
                    "id": image_path.stem,
                    "image_path": image_path.resolve(),
                    "label_path": label_path.resolve(),
                    "labeled": labeled,
                }
            )
        return samples

    def __init__(
        self,
        data_path: Path | str,
        split: str = "train",
        fold: int = 0,
        normalize: Callable | None = None,
        transform: Callable | None = None,
        logger=None,
        image_channels: int = 3,
        image_size: int | tuple[int, int] | None = None,
    ):
        self.data_path = get_path(data_path)
        self.split = split
        self.fold = fold
        self.normalize = normalize
        self.transform = transform
        self.logger = logger
        self.image_channels = image_channels
        self.image_size = image_size
        self._register_samples()

    def _register_samples(self):
        with open(self.data_path / self.SPLIT_FILE) as f:
            split_dict = json.load(f)
        key = {"train": "train", "valid": "valid", "test": "test"}[self.split]
        self.samples_list = [f"{sid:04}" for sid in split_dict[key]]

    def sample_paths(self, index: int):
        case = self.samples_list[index]
        return (
            self.data_path / f"{self.IMAGES_DIR}/{case}.png",
            self.data_path / f"{self.LABELS_DIR}/{case}.png",
        )

    def get_sample(self, index: int, normalize: bool = True) -> dict:
        case = self.samples_list[index]
        image = load_image_grayscale(
            self.data_path / f"{self.IMAGES_DIR}/{case}.png", self.image_channels
        )
        label = load_label(self.data_path / f"{self.LABELS_DIR}/{case}.png")
        data = {"image": image, "label": label}
        data = self._finalize(data, normalize)
        data["case_name"] = case
        return data

    @staticmethod
    def process_label(label: np.ndarray, min_size: int = 10) -> np.ndarray:
        """Drop 8-connected components smaller than ``min_size`` px (defined
        but not applied in the reference's live path; kept with the same
        status)."""
        from scipy import ndimage

        label = label.copy()
        cc, _ = ndimage.label(label, structure=np.ones((3, 3), int))
        ids, sizes = np.unique(cc, return_counts=True)
        for i, s in zip(ids, sizes):
            if i != 0 and s < min_size:
                label[cc == i] = 0
        return label
