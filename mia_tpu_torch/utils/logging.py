"""Rich shell + timestamped file logging.

Mirrors the reference's logger behavior (``src/utils/logging/logger.py`` and
``al_trainer.py:421-502``): a named logger with a plain-format FileHandler and
an optional Rich shell handler with keyword highlighting; collision-safe log
file names unless override is requested.

Copied from ``mia_tpu/utils/logging.py`` (whose package ``__init__`` imports
JAX through its compile-cache helper).
"""

from __future__ import annotations

import logging
from datetime import datetime
from pathlib import Path

try:  # rich is available in the image, but stay import-safe
    from rich.console import Console
    from rich.logging import RichHandler

    _HAS_RICH = True
except Exception:  # pragma: no cover
    _HAS_RICH = False

_FILE_FMT = "%(levelname)s <%(asctime)s>: %(message)s"
_KEYWORDS = ["Training summary", "Epoch", "Train", "Valid", "Round", "Test"]


def _collision_safe(path: Path, override: bool) -> Path:
    if path.exists() and not override:
        stamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        return path.parent / f"{path.stem}@{stamp}{path.suffix}"
    return path


def setup_logger(
    name: str,
    log_path: str | Path | None = None,
    verbose: bool = True,
    log_mode: str = "a",
    log_override: bool = False,
) -> logging.Logger:
    """Create a logger with a file handler and optional Rich shell handler."""
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    logger.propagate = False

    if log_path is not None:
        log_path = _collision_safe(Path(log_path), log_override)
        log_path.parent.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(log_path, log_mode)
        fh.setFormatter(logging.Formatter(fmt=_FILE_FMT))
        logger.addHandler(fh)
        logger._mia_log_path = log_path  # type: ignore[attr-defined]

    if verbose:
        if _HAS_RICH:
            sh: logging.Handler = RichHandler(
                console=Console(stderr=True),
                rich_tracebacks=True,
                show_time=False,
                show_path=False,
                show_level=False,
                keywords=_KEYWORDS,
            )
        else:  # pragma: no cover
            sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(fmt="%(message)s"))
        logger.addHandler(sh)

    return logger


def add_file_sink(logger: logging.Logger, path: str | Path, mode: str = "w") -> logging.Handler:
    """Attach a temporary plain file sink (used for config echo)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    handler = logging.FileHandler(path, mode)
    handler.setFormatter(logging.Formatter(fmt="%(message)s"))
    logger.addHandler(handler)
    return handler


def remove_sink(logger: logging.Logger, handler: logging.Handler) -> None:
    logger.removeHandler(handler)
    handler.close()
