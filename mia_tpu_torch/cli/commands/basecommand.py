"""Subcommand ABC (counterpart of ``mia_tpu/cli/commands/basecommand.py``)."""

from __future__ import annotations

import abc
from argparse import ArgumentParser
from pathlib import Path


class BaseCommand(abc.ABC):
    def __init__(self, work_dir: Path):
        self.work_dir = work_dir

    @abc.abstractmethod
    def setup_parser(self, subparser) -> ArgumentParser:
        ...

    @abc.abstractmethod
    def __call__(self):
        ...
