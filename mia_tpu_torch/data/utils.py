"""Dataset split-dict exceptions and log helpers (reference
``src/datasets/utils/{exceptions,logging}.py``).

Copied from ``mia_tpu/data/utils.py``: host-only numpy/PIL code
that cannot be imported from there without JAX (``mia_tpu/data/__init__``
imports the JAX loader).
"""

from __future__ import annotations

from logging import Logger


class SplitDictKeyException(RuntimeError):
    def __init__(self, split) -> None:
        super().__init__(f"Invalid split_dict: split={split} not found")


def log_no_split_dict(logger: Logger):
    logger.warning("No split_dict is specified")


def log_not_found_split_dict(logger: Logger, split_dict_path, e=None):
    logger.warning(
        f'Cannot read split_dict from "{split_dict_path}"'
        + (f"due to e={e}" if e else "")
    )


def log_not_found_split_dict_key(logger: Logger, key, e=None):
    logger.warning(f"split_dict key={key} not found.")


def log_not_found_label(logger: Logger, image_id, image_path=None):
    logger.warning(
        f"Image id={image_id}"
        + (f"(path={image_path})" if image_path else "")
        + " have no label file"
    )
