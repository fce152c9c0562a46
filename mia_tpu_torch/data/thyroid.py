"""TN3K / TG3K thyroid ultrasound datasets
(``src/datasets/thyroid/{tn3k,tg3k}_dataset.py``).

JPG images; labels binarized at 127. TN3K: per-fold trainval split JSON +
separate test dirs. TG3K: single split file, test == valid (reference TODO,
``tg3k_dataset.py:109-112``).

Copied from ``mia_tpu/data/thyroid.py``: host-only numpy/PIL code that
cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Callable

import numpy as np

from .base import BaseDataset, get_path, load_image_grayscale, load_label


class _ThyroidBase(BaseDataset):
    NUM_CLASSES = 1

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

    def _load(self, image_path: Path, label_path: Path, normalize: bool) -> dict:
        image = load_image_grayscale(image_path, self.image_channels)
        label = load_label(label_path)
        # binarize at 127 (tn3k_dataset.py:156-159)
        label = (label > 127).astype(np.int32)
        data = {"image": image, "label": label}
        return self._finalize(data, normalize)


class TN3KDataset(_ThyroidBase):
    CLASSES = {0: "bg", 1: "thyroid"}
    TEST_IMAGES_DIR = "test-image"
    TEST_LABELS_DIR = "test-mask"
    TRAINVAL_IMAGES_DIR = "trainval-image"
    TRAINVAL_LABELS_DIR = "trainval-mask"
    TRAINVAL_SPLIT_FORMAT = "tn3k-trainval-fold{}.json"

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        data_path = get_path(data_path)
        images_dir = data_path / TN3KDataset.TRAINVAL_IMAGES_DIR
        labels_dir = data_path / TN3KDataset.TRAINVAL_LABELS_DIR
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

    def _register_samples(self):
        if self.split in ("train", "valid"):
            split_file = self.data_path / self.TRAINVAL_SPLIT_FORMAT.format(self.fold)
            with open(split_file) as f:
                split_dict = json.load(f)
            key = "train" if self.split == "train" else "val"
            self.samples_list = [f"{sid:04}" for sid in split_dict[key]]
        else:
            self.samples_list = []
            test_images_dir = self.data_path / self.TEST_IMAGES_DIR
            for image_path in sorted(test_images_dir.glob("*.jpg")):
                if image_path.is_file():
                    self.samples_list.append(image_path.stem)

    def get_sample(self, index: int, normalize: bool = True) -> dict:
        case = self.samples_list[index]
        if self.split != "test":
            image_path = self.data_path / f"{self.TRAINVAL_IMAGES_DIR}/{case}.jpg"
            label_path = self.data_path / f"{self.TRAINVAL_LABELS_DIR}/{case}.jpg"
        else:
            image_path = self.data_path / f"{self.TEST_IMAGES_DIR}/{case}.jpg"
            label_path = self.data_path / f"{self.TEST_LABELS_DIR}/{case}.jpg"
        data = self._load(image_path, label_path, normalize)
        data["case_name"] = case
        return data


class TG3KDataset(_ThyroidBase):
    CLASSES = {0: "bg", 1: "thyroid"}
    IMAGES_DIR = "thyroid-image"
    LABELS_DIR = "thyroid-mask"
    TRAINVAL_SPLIT_FILE = "tg3k-trainval.json"

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        data_path = get_path(data_path)
        images_dir = data_path / TG3KDataset.IMAGES_DIR
        labels_dir = data_path / TG3KDataset.LABELS_DIR
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

    def _register_samples(self):
        with open(self.data_path / self.TRAINVAL_SPLIT_FILE) as f:
            split_dict = json.load(f)
        key = "train" if self.split == "train" else "val"  # test == valid
        self.samples_list = [f"{sid:04}" for sid in split_dict[key]]

    def get_sample(self, index: int, normalize: bool = True) -> dict:
        case = self.samples_list[index]
        image_path = self.data_path / f"{self.IMAGES_DIR}/{case}.jpg"
        label_path = self.data_path / f"{self.LABELS_DIR}/{case}.jpg"
        data = self._load(image_path, label_path, normalize)
        data["case_name"] = case
        return data
