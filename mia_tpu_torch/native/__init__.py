"""ctypes binding of the native host library (``native/mia_host.cpp``).

The same C++ source and the same entry points that ``mia_tpu/native``
binds, bound here so that the port imports nothing of the JAX package:

- ``load_image_batch``: threaded PNG/JPEG decode and PIL-semantics resize;
- ``squared_edt_2d``: the exact (Felzenszwalb) squared EDT on the host, a
  cross-check of the port's device EDT (``ops/distance.py``);
- ``brush_rle_encode`` / ``brush_rle_decode``: Label Studio's brush codec.
 The library is compiled with g++ at first use into
``build/mia_tpu_torch/`` (named by a hash of the source); when it cannot
be built or loaded (no g++, no libpng/libjpeg headers, or a cached build
whose libraries this machine lacks) ``is_available()`` is False,
``unavailable_reason()`` says why, and the loader decodes with PIL into
float32 images instead (``data.loader.decode_path()`` names the mode
in use; the trainer logs it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SRC = _ROOT / "native" / "mia_host.cpp"
_BUILD_DIR = _ROOT / "build" / "mia_tpu_torch"
_CMD = ("g++", "-O3", "-fPIC", "-shared", "{src}", "-o", "{out}", "-lpng", "-ljpeg", "-lpthread")


def _build(path: Path) -> str | None:
    """Compile the library to ``path``; None on success, else why not.

    Each build compiles into a temporary file of its own (``mkstemp``,
    unique whatever the process ids of concurrent builds, which repeat
    across pid namespaces) and publishes it with ``os.replace``. A build
    that finds ``path`` already there when it is done keeps that one.
    """
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, name = tempfile.mkstemp(dir=_BUILD_DIR, prefix=f"{path.stem}.", suffix=".tmp")
    os.close(fd)
    tmp = Path(name)
    cmd = [a.format(src=_SRC, out=tmp) for a in _CMD]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True, timeout=300)
        if not path.is_file():
            os.replace(tmp, path)
    except subprocess.CalledProcessError as e:
        errors = [ln for ln in e.stderr.splitlines() if "error" in ln]
        return f"g++ failed: {(errors or ['exit %d' % e.returncode])[0].strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        if not path.is_file():
            return f"g++ failed: {e}"
    finally:
        tmp.unlink(missing_ok=True)
    return None


@functools.lru_cache(maxsize=1)
def _load() -> tuple[ctypes.CDLL | None, str | None]:
    """Build (once per process) and load the library: ``(lib, None)``, or
    ``(None, reason)`` when it cannot be built."""
    if not _SRC.is_file():
        return None, f"{_SRC} not found"
    digest = hashlib.sha1(_SRC.read_bytes() + " ".join(_CMD).encode()).hexdigest()[:16]
    path = _BUILD_DIR / f"libmia_host_{digest}.so"
    if not path.is_file():
        reason = _build(path)
        if reason is not None:
            return None, reason
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:  # e.g. built on another machine against a missing libpng
        return None, f"cannot load {path.name}: {e}"
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.load_batch.restype = ctypes.c_int
    lib.load_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
    ]
    lib.squared_edt_2d.restype = None
    lib.squared_edt_2d.argtypes = [u8, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                                   ctypes.c_double, ctypes.POINTER(ctypes.c_float)]
    lib.brush_rle_encode.restype = ctypes.c_long
    lib.brush_rle_encode.argtypes = [u8, ctypes.c_long, u8]
    lib.brush_rle_decoded_size.restype = ctypes.c_long
    lib.brush_rle_decoded_size.argtypes = [u8, ctypes.c_long]
    lib.brush_rle_decode.restype = ctypes.c_long
    lib.brush_rle_decode.argtypes = [u8, ctypes.c_long, u8, ctypes.c_long]
    return lib, None


def is_available() -> bool:
    return _load()[0] is not None


def unavailable_reason() -> str | None:
    """Why the library could not be built; None when it is available."""
    return _load()[1]


def _lib() -> ctypes.CDLL:
    lib, reason = _load()
    if lib is None:
        raise RuntimeError(f"native host library unavailable: {reason}")
    return lib


def _u8(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def load_image_batch(image_paths, label_paths, image_size=(256, 256), channels: int = 3,
                     num_threads: int = 8):
    """Decode and resize a batch natively (PIL semantics: bilinear image,
    nearest label). Returns images ``(N, H, W, C)`` float32 in [0, 1] and
    labels ``(N, H, W)`` int32; raises RuntimeError if the library is
    unavailable or a file fails to decode."""
    lib = _lib()
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


def squared_edt_2d(feature: np.ndarray, spacing=(1.0, 1.0)) -> np.ndarray:
    """Squared Euclidean distance of each pixel of a 2D mask to its nearest
    True pixel, in units of ``spacing`` (float32)."""
    lib = _lib()
    feature = np.ascontiguousarray(feature, dtype=np.uint8)
    if feature.ndim != 2:
        raise ValueError(f"a 2D mask is needed, got shape {feature.shape}")
    h, w = feature.shape
    out = np.empty((h, w), np.float32)
    lib.squared_edt_2d(_u8(feature), h, w, float(spacing[0]), float(spacing[1]),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def brush_rle_encode(arr: np.ndarray) -> list[int]:
    """Label Studio brush RLE bytes of a flat uint8 array."""
    lib = _lib()
    arr = np.ascontiguousarray(arr, dtype=np.uint8).ravel()
    out = np.empty(2 * arr.size + 64, np.uint8)
    n = lib.brush_rle_encode(_u8(arr), arr.size, _u8(out))
    return out[:n].tolist()


def brush_rle_decode(rle) -> np.ndarray:
    """The flat uint8 array of Label Studio brush RLE bytes."""
    lib = _lib()
    data = np.ascontiguousarray(rle, dtype=np.uint8)
    size = lib.brush_rle_decoded_size(_u8(data), data.size)
    if size < 0:
        raise ValueError("invalid brush RLE payload")
    out = np.empty(size, np.uint8)
    if lib.brush_rle_decode(_u8(data), data.size, _u8(out), size) != size:
        raise ValueError("brush RLE decode mismatch")
    return out
