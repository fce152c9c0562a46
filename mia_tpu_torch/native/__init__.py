"""ctypes binding of the native image decoder (``native/mia_host.cpp``).

The same C++ source and the same ``load_batch`` entry point that
``mia_tpu/native`` binds, bound here so that the port imports nothing of
the JAX package. The library is compiled with g++ at first use into
``build/mia_tpu_torch/`` (named by a hash of the source); when it cannot
be built (no g++, or no libpng/libjpeg headers) ``is_available()`` is
False, ``unavailable_reason()`` says why, and the loader decodes with PIL
into float32 images instead (``data.loader.decode_path()`` names the mode
in use; the trainer logs it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "mia_host.cpp"
_BUILD_DIR = _ROOT / "build" / "mia_tpu_torch"
_CMD = ("g++", "-O3", "-fPIC", "-shared", "{src}", "-o", "{out}", "-lpng", "-ljpeg", "-lpthread")


@functools.lru_cache(maxsize=1)
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """Build (once per process) and load the library: ``(lib, None)``, or
    ``(None, reason)`` when it cannot be built."""
    if not _SRC.is_file():
        return None, f"{_SRC} not found"
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(_CMD).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"libmia_host_{digest}.so"
    if not path.is_file():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [a.format(src=_SRC, out=tmp) for a in _CMD]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        except subprocess.CalledProcessError as e:
            tmp.unlink(missing_ok=True)
            errors = [ln for ln in e.stderr.splitlines() if "error" in ln]
            return None, f"g++ failed: {(errors or ['exit %d' % e.returncode])[0].strip()}"
        except (OSError, subprocess.SubprocessError) as e:
            tmp.unlink(missing_ok=True)
            return None, f"g++ failed: {e}"
        os.replace(tmp, path)
    lib = ctypes.CDLL(str(path))
    lib.load_batch.restype = ctypes.c_int
    lib.load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    return lib, None


def is_available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built; None when it is available."""
    return _load()[1]


def load_image_batch(image_paths, label_paths, image_size=(256, 256), channels: int = 3,
                     num_threads: int = 8):
    """Decode and resize a batch natively (PIL semantics: bilinear image,
    nearest label). Returns images ``(N, H, W, C)`` float32 in [0, 1] and
    labels ``(N, H, W)`` int32; raises RuntimeError if the library is
    unavailable or a file fails to decode."""
    lib, reason = _load()
    if lib is None:
        raise RuntimeError(f"native decoder library unavailable: {reason}")
    n = len(image_paths)
    oh, ow = image_size
    images = np.empty((n, oh, ow, channels), np.float32)
    labels = np.empty((n, oh, ow), np.int32)
    img_arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in image_paths])
    lbl_arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in label_paths])
    failures = lib.load_batch(
        img_arr, lbl_arr, n,
        images.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        oh, ow, channels, num_threads,
    )
    if failures:
        raise RuntimeError(f"native decoder failed on {failures} file(s)")
    return images, labels
