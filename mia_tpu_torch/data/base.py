"""Dataset foundation: the reference dict contract on numpy, channel-last.

Contract (reference ``fugc_dataset.py:117-164``): ``get_sample(i, normalize)``
returns ``{"image": (H, W, C) float32 in [0,1], "label": (H, W) int32,
"case_name": str[, "spacing": array]}``. Differences from the reference are
TPU-first by design: channel-LAST layout, numpy instead of torch (device
placement happens in the batch loader), and augmentation is expected to run
on device via the port's ``transforms`` — the host ``transform``/``normalize``
hooks are kept for parity and tooling.

Host resize uses PIL (bilinear image / nearest label), which is the
antialiased semantics torchvision ``F.resize(antialias=True)`` emulates.

Copied from ``mia_tpu/data/base.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

import abc
from pathlib import Path
from typing import Any, Callable

import numpy as np
from PIL import Image


def get_path(path: Path | str) -> Path:
    return Path(path).expanduser()


def load_image_grayscale(path: Path | str, channels: int = 3) -> np.ndarray:
    """PNG/JPG → grayscale (H, W, channels) float32 in [0, 1].

    Mirrors ``Image.open(...).convert("L")`` + ``to_tensor`` + channel repeat
    (``fugc_dataset.py:139-147``).
    """
    img = Image.open(path).convert("L")
    arr = np.asarray(img, dtype=np.float32) / 255.0
    return np.repeat(arr[..., None], channels, axis=-1)


def load_label(path: Path | str) -> np.ndarray:
    """Label PNG/JPG → (H, W) int32 raw values (``pil_to_tensor`` semantics)."""
    lbl = Image.open(path)
    arr = np.asarray(lbl)
    if arr.ndim == 3:
        arr = arr[..., 0]
    return arr.astype(np.int32)


def host_joint_resize(
    image: np.ndarray, label: np.ndarray, image_size: tuple[int, int] | int
) -> tuple[np.ndarray, np.ndarray]:
    """PIL bilinear (image) / nearest (label) resize to (H, W)."""
    if isinstance(image_size, int):
        image_size = (image_size, image_size)
    h, w = int(image_size[0]), int(image_size[1])
    if image.shape[:2] == (h, w):
        return image, label
    chans = [
        np.asarray(
            Image.fromarray(image[..., c]).resize((w, h), Image.BILINEAR),
            dtype=np.float32,
        )
        for c in range(image.shape[-1])
    ]
    image_r = np.stack(chans, axis=-1)
    label_r = np.asarray(
        Image.fromarray(label.astype(np.int32), mode="I").resize((w, h), Image.NEAREST)
    ).astype(np.int32)
    return image_r, label_r


def host_zscore(image: np.ndarray) -> np.ndarray:
    """torch ``ZScoreNormalize`` parity (Bessel-corrected std, clip 1e-8)."""
    mean = image.mean()
    std = image.std(ddof=1) if image.size > 1 else 0.0
    return (image - mean) / max(std, 1e-8)


class BaseDataset(abc.ABC):
    """Reference ``BaseDataset`` ABC (``basedataset.py:7-19``) + a cheap
    ``case_names()`` accessor so AL bookkeeping never loads pixels."""

    samples_list: list

    @staticmethod
    @abc.abstractmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        ...

    @abc.abstractmethod
    def get_sample(self, index: int, normalize: bool = True) -> Any:
        ...

    def case_names(self) -> list[str]:
        return [str(s) for s in self.samples_list]

    def __len__(self) -> int:
        return len(self.samples_list)

    def __getitem__(self, index: int):
        return self.get_sample(index)

    # -- shared sample pipeline -------------------------------------------
    image_size: tuple[int, int] | int | None = None
    transform: Callable | None = None
    normalize: Callable | None = None

    def _finalize(self, data: dict, normalize: bool = True) -> dict:
        """transform → final resize → normalize, reference order
        (``fugc_dataset.py:149-160``)."""
        if self.transform:
            data = self.transform(data)
        if self.image_size is not None:
            data["image"], data["label"] = host_joint_resize(
                data["image"], data["label"], self.image_size
            )
        if self.normalize and normalize:
            data = self.normalize(data)
        return data


class ZScoreNormalizeHost:
    """Host-dict z-score normalize (``normalization.py:9-26``)."""

    def __call__(self, data: dict) -> dict:
        data["image"] = host_zscore(data["image"].astype(np.float32))
        return data
