"""FUGC 2025 fetal ultrasound dataset (``src/datasets/fugc/fugc_dataset.py``).

Layout: ``train|val|test/{images,labels}/*.png``; classes bg / anterior lip /
posterior lip.

Copied from ``mia_tpu/data/fugc.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

from .base import BaseDataset, get_path, load_image_grayscale, load_label


class FUGCDataset(BaseDataset):
    CLASSES = {0: "bg", 1: "anterior lip", 2: "posterior lip"}
    TRAIN_DIR = "train"
    VALID_DIR = "val"
    TEST_DIR = "test"
    IMAGES_DIR = "images"
    LABELS_DIR = "labels"
    NUM_CLASSES = 2  # foreground classes (reference convention)

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        data_path = get_path(data_path)
        images_dir = data_path / FUGCDataset.TRAIN_DIR / FUGCDataset.IMAGES_DIR
        labels_dir = data_path / FUGCDataset.TRAIN_DIR / FUGCDataset.LABELS_DIR
        samples = []
        for image_path in sorted(images_dir.glob("*.png")):
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

    def _split_dir(self) -> str:
        return {
            "train": self.TRAIN_DIR,
            "valid": self.VALID_DIR,
            "test": self.TEST_DIR,
        }[self.split]

    def _register_samples(self):
        if self.split not in ("train", "valid", "test"):
            raise ValueError(f"FUGCDataset does not have {self.split} split")
        images_path = self.data_path / self._split_dir() / self.IMAGES_DIR
        self.samples_list = sorted(p.stem for p in images_path.glob("*.png"))

    def sample_paths(self, index: int):
        """(image_path, label_path) for the native batch loader."""
        case = self.samples_list[index]
        base = self.data_path / self._split_dir()
        return base / self.IMAGES_DIR / f"{case}.png", base / self.LABELS_DIR / f"{case}.png"

    def get_sample(self, index: int, normalize: bool = True) -> dict:
        case = self.samples_list[index]
        base = self.data_path / self._split_dir()
        image = load_image_grayscale(
            base / self.IMAGES_DIR / f"{case}.png", self.image_channels
        )
        label = load_label(base / self.LABELS_DIR / f"{case}.png")
        data = {"image": image, "label": label}
        data = self._finalize(data, normalize)
        data["case_name"] = case
        return data
