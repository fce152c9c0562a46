"""Build and load the hand-written CUDA kernels of ``mia_tpu_torch/csrc``.

The kernels have a plain C interface (no PyTorch headers), so ``nvcc``
compiles each of ``csrc/*.cu`` in seconds, all sources at once in parallel,
then links them into one shared library, which ``ctypes`` loads. The
library lands in ``build/mia_tpu_torch/`` at the repository root, named by
a hash of the sources, their ``csrc/*.cuh`` headers and the flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is built or
loaded at import time; the first kernel launch builds. A failed build
raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "mia_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    for src in (*_sources(), *sorted(CSRC_DIR.glob("*.cuh"))):  # the headers they include too
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmia_kernels_{digest.hexdigest()[:16]}.so"


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the stderr of each that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    failures = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{err}")
    if failures:
        raise RuntimeError("\n".join(failures))


def _build(out: Path) -> None:
    """Compile and link into ``out``. The objects and the library are made
    in a directory of this build's own (``mkdtemp``: unique whatever the
    process ids of concurrent builds, which repeat across pid namespaces),
    then published with ``os.replace``; a build that finds ``out`` already
    there when it is done keeps that one."""
    out.parent.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=out.parent, prefix=f"{out.stem}."))
    objs = [work / f"{src.stem}.o" for src in _sources()]
    tmp = work / out.name
    try:
        _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                  for src, obj in zip(_sources(), objs)])
        _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]])
        if not out.is_file():
            os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)


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
