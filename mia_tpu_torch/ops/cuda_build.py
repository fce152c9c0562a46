"""Build and load the hand-written CUDA kernels of ``mia_tpu_torch/csrc``.

The kernels have a plain C interface (no PyTorch headers), so ``nvcc``
compiles all of ``csrc/*.cu`` into one shared library in seconds, and
``ctypes`` loads it. The library lands in ``build/mia_tpu_torch/`` at the
repository root, named by a hash of the sources and flags, so an edited
source is rebuilt and an unchanged one is reused. Nothing is built or
loaded at import time; the first kernel launch builds. A failed build
raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mia_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {CSRC_DIR}")
    return sources


def library_path() -> Path:
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmia_kernels_{digest.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build ``csrc/*.cu`` if needed and return the loaded library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.is_file():
                _build(path)
            _lib = ctypes.CDLL(str(path))
        return _lib
