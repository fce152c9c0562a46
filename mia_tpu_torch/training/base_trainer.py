"""Trainer lifecycle ABC (reference ``src/training/base_trainer.py:6-61``).

Copied from ``mia_tpu/training/base_trainer.py`` (host-only; ``mia_tpu.training``
imports JAX).
"""

from __future__ import annotations

import abc
from pathlib import Path


class BaseTrainer(abc.ABC):
    def on_train_start(self):
        pass

    def on_train_end(self):
        pass

    def on_epoch_start(self):
        pass

    def on_epoch_end(self):
        pass

    def on_train_epoch_start(self):
        pass

    def on_train_epoch_end(self):
        pass

    def on_valid_epoch_start(self):
        pass

    def on_valid_epoch_end(self):
        pass

    @abc.abstractmethod
    def train_step(self, sampled_batch):
        ...

    @abc.abstractmethod
    def valid_step(self, sampled_batch):
        ...

    @abc.abstractmethod
    def train(self):
        ...

    @abc.abstractmethod
    def perform_real_test(self):
        ...

    @abc.abstractmethod
    def state_dict(self) -> dict:
        ...

    @abc.abstractmethod
    def load_state_dict(self, save_path: str | Path):
        ...

    @abc.abstractmethod
    def save_state_dict(self, save_path: str | Path, save_training_state: bool = False):
        ...
