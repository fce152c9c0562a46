"""BTCV multi-organ CT dataset — stub, matching the reference's status
(``src/datasets/btcv/__init__.py:36-45`` is TODO-only). Copied from
``mia_tpu/data/btcv.py``."""

from __future__ import annotations

from pathlib import Path

from .base import BaseDataset


class BTCVDataset(BaseDataset):
    """Placeholder: the reference never implemented download/read for BTCV."""

    @staticmethod
    def find_samples(data_path: Path | str, require_label: bool = True) -> list[dict]:
        raise NotImplementedError("BTCV reading is unimplemented upstream as well")

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("BTCV reading is unimplemented upstream as well")

    def get_sample(self, index: int, normalize: bool = True):
        raise NotImplementedError
