"""ACDC cardiac MRI dataset (``src/datasets/acdc/acdc_dataset.py``).

h5 slices for train, h5 volumes for valid/test, ``.list`` split files, and a
per-case raw-spacing CSV. Train samples are ``(H, W, C)``; valid/test are
``(D, H, W, C)`` volumes (the reference's CxDxHxW, channel-last here).

Copied from ``mia_tpu/data/acdc.py`` (host-only; ``mia_tpu/data/__init__``
imports the JAX loader); ``h5py`` is imported only where a file is read.
Every case is read by :meth:`ACDCDataset.read_case`, so a subclass can serve
the same cases from memory (a machine without h5py).
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Callable

import numpy as np

from .base import BaseDataset, get_path, host_joint_resize


class ACDCDataset(BaseDataset):
    CLASSES = {0: "bg", 1: "RV", 2: "Myo", 3: "LV"}
    RAW_DIR = "ACDC_raw"
    PROCESSED_DIR = "ACDC"
    SAMPLES_DIR = f"{PROCESSED_DIR}/data"
    TRAIN_SPLIT_FILE = f"{PROCESSED_DIR}/train_slices.list"
    VALID_SPLIT_FILE = f"{PROCESSED_DIR}/val.list"
    TEST_SPLIT_FILE = f"{PROCESSED_DIR}/test.list"
    NUM_CLASSES = 3
    Z_SPACING = 1
    RAW_SPACING = [10.0, 1.4843800067901611, 1.4843800067901611]

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        import h5py

        data_path = get_path(data_path)
        samples_dir = data_path / ACDCDataset.SAMPLES_DIR
        samples = []
        for sample in sorted(samples_dir.glob("*.h5")):
            if not sample.is_file():
                continue
            with h5py.File(sample, "r") as h5f:
                if "image" not in h5f:
                    continue
                labeled = "label" in h5f
            if require_label and not labeled:
                continue
            samples.append(
                {"id": sample.stem, "path": sample.resolve(), "labeled": labeled}
            )
        return samples

    def __init__(
        self,
        data_path: Path | str,
        split: str = "train",
        num: int | None = None,
        normalize: Callable | None = None,
        transform: Callable | None = None,
        logger=None,
        image_channels: int = 3,
        image_size: int | tuple[int, int] | None = None,
    ):
        self.data_path = get_path(data_path)
        self.split = split
        self.num = num
        self.normalize = normalize
        self.transform = transform
        self.logger = logger
        self.image_channels = image_channels
        self.image_size = image_size
        self._register_samples()

    def _register_samples(self):
        split_file = {
            "train": self.TRAIN_SPLIT_FILE,
            "valid": self.VALID_SPLIT_FILE,
            "test": self.TEST_SPLIT_FILE,
        }[self.split]
        with open(self.data_path / split_file) as f:
            self.samples_list = [line.strip() for line in f if line.strip()]

        raw_spacing_path = self.data_path / self.PROCESSED_DIR / "raw_spacing.csv"
        self.raw_spacing: dict[str, list[float]] | None = None
        if raw_spacing_path.is_file():
            self.raw_spacing = {}
            with open(raw_spacing_path) as f:
                reader = csv.reader(f)
                header = next(reader)
                for row in reader:
                    self.raw_spacing[row[0]] = [float(v) for v in row[1:]]

        if self.num is not None and self.split == "train":
            self.samples_list = self.samples_list[: self.num]

    def read_case(self, case: str) -> tuple[np.ndarray, np.ndarray]:
        """The float32 image and int32 label of ``case``: an ``(H, W)``
        slice for train, a ``(D, H, W)`` volume for valid/test."""
        import h5py

        if self.split == "train":
            path = self.data_path / f"{self.SAMPLES_DIR}/slices/{case}.h5"
        else:
            path = self.data_path / f"{self.SAMPLES_DIR}/{case}.h5"
        with h5py.File(path, "r") as h5f:
            if "image" not in h5f:
                raise RuntimeError(f"Case {case}.h5 does not have image field")
            if "label" not in h5f:
                raise RuntimeError(f"Case {case}.h5 does not have label field")
            image = np.asarray(h5f["image"], dtype=np.float32)
            label = np.asarray(h5f["label"], dtype=np.int32)
        return image, label

    def get_sample(self, index: int, normalize: bool = True) -> dict:
        case = self.samples_list[index]
        image, label = self.read_case(case)

        # train: (H, W) slice → (H, W, C); valid/test: (D, H, W) → (D, H, W, C)
        image = np.repeat(image[..., None], self.image_channels, axis=-1)

        data = {"image": image, "label": label}
        if self.transform:
            data = self.transform(data)
        if self.image_size is not None:
            if image.ndim == 3:
                data["image"], data["label"] = host_joint_resize(
                    data["image"], data["label"], self.image_size
                )
            else:
                imgs, lbls = [], []
                for d in range(data["image"].shape[0]):
                    i, l = host_joint_resize(
                        data["image"][d], data["label"][d], self.image_size
                    )
                    imgs.append(i)
                    lbls.append(l)
                data["image"] = np.stack(imgs)
                data["label"] = np.stack(lbls)
        if self.normalize and normalize:
            data = self.normalize(data)

        data["case_name"] = case
        patient_frame_id = "_".join(case.split("_")[:2])
        data["spacing"] = self._get_spacing(patient_frame_id)
        return data

    def _get_spacing(self, patient_frame_id: str):
        if self.raw_spacing is None:
            return None
        sp = self.raw_spacing.get(patient_frame_id)
        if sp is None:
            return None
        return np.asarray(sp[:2] if self.split == "train" else sp)
