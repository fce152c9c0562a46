"""LA2018 left-atrium NRRD dataset (``src/datasets/la2018/la2018_dataset.py``).

Per-patient directories with lgemri/laendo/lawall NRRD volumes → labels
1 (endo) / 2 (wall). The reference returns a (image, label) tuple here (a
different convention from every other dataset); preserved.

Copied from ``mia_tpu/data/la2018.py`` (host-only; ``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np

from ..utils.images import read_nrrd
from .base import BaseDataset, get_path


class LA2018Dataset(BaseDataset):
    IMAGE_FILE = "lgemri.nrrd"
    LABEL_ENDO_FILE = "laendo.nrrd"
    LABEL_WALL_FILE = "lawall.nrrd"

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        data_path = get_path(data_path)
        samples = []
        for patient in sorted(data_path.glob("*")):
            if not patient.is_dir():
                continue
            if not (patient / LA2018Dataset.IMAGE_FILE).is_file():
                continue
            labeled = (patient / LA2018Dataset.LABEL_ENDO_FILE).is_file() and (
                patient / LA2018Dataset.LABEL_WALL_FILE
            ).is_file()
            if require_label and not labeled:
                continue
            samples.append(
                {"id": patient.stem, "path": patient.resolve(), "labeled": labeled}
            )
        return samples

    def __init__(
        self,
        data_path: Path | str,
        require_label: bool = True,
        transform: Callable | None = None,
        normalize: Callable | None = None,
        sample_ids: list[str] | None = None,
        logger=None,
    ):
        self.data_path = data_path
        self.require_label = require_label
        self.transform = transform
        self.normalize = normalize
        self.logger = logger
        self.sample_ids = sample_ids
        self._register_samples()

    def _register_samples(self):
        samples = self.find_samples(self.data_path, self.require_label)
        registered = []
        for sample in samples:
            if self.sample_ids and sample["id"] not in self.sample_ids:
                continue
            base = get_path(sample["path"])
            entry = {"image": base / self.IMAGE_FILE, "id": sample["id"]}
            if (base / self.LABEL_ENDO_FILE).is_file():
                entry["label_endo"] = base / self.LABEL_ENDO_FILE
            if (base / self.LABEL_WALL_FILE).is_file():
                entry["label_wall"] = base / self.LABEL_WALL_FILE
            registered.append(entry)
        self.samples = registered
        self.samples_list = [s["id"] for s in registered]

    def __len__(self):
        return len(self.samples)

    def get_sample(self, index: int, normalize: bool = True):
        sample = self.samples[index]
        image = read_nrrd(sample["image"]).astype(np.float32)
        try:
            label_endo = read_nrrd(sample["label_endo"])
            label_wall = read_nrrd(sample["label_wall"])
            label = np.zeros(image.shape, dtype=np.int32)
            label[label_endo > 0] = 1
            label[label_wall > 0] = 2
        except (KeyError, FileNotFoundError):
            if self.require_label:
                raise
            label = np.full(image.shape, -1, dtype=np.int32)

        if self.transform:
            image, label = self.transform(image, label)
        if self.normalize and normalize:
            image, label = self.normalize(image, label)
        return image, label
