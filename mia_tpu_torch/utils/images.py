"""Volume image I/O.

``read_nrrd`` replaces the reference's SimpleITK-backed reader
(``src/utils/images.py:6-11``) with a dependency-free NRRD parser (SimpleITK
is not available in this environment). Supports raw and gzip encodings,
returning the array in (slowest..fastest) axis order — identical to
``sitk.GetArrayFromImage`` (z, y, x).

Copied from ``mia_tpu/utils/images.py``: pure numpy and gzip, kept here so
that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import gzip
from pathlib import Path

import numpy as np

_NRRD_DTYPES = {
    "signed char": np.int8,
    "int8": np.int8,
    "int8_t": np.int8,
    "uchar": np.uint8,
    "unsigned char": np.uint8,
    "uint8": np.uint8,
    "uint8_t": np.uint8,
    "short": np.int16,
    "short int": np.int16,
    "signed short": np.int16,
    "int16": np.int16,
    "int16_t": np.int16,
    "ushort": np.uint16,
    "unsigned short": np.uint16,
    "uint16": np.uint16,
    "uint16_t": np.uint16,
    "int": np.int32,
    "signed int": np.int32,
    "int32": np.int32,
    "int32_t": np.int32,
    "uint": np.uint32,
    "unsigned int": np.uint32,
    "uint32": np.uint32,
    "uint32_t": np.uint32,
    "longlong": np.int64,
    "long long": np.int64,
    "int64": np.int64,
    "int64_t": np.int64,
    "ulonglong": np.uint64,
    "uint64": np.uint64,
    "uint64_t": np.uint64,
    "float": np.float32,
    "double": np.float64,
}


def read_nrrd(path: Path | str) -> np.ndarray:
    """Read a .nrrd file into a numpy array (z, y, x order)."""
    path = Path(path)
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path} is not a NRRD file")
        header: dict[str, str] = {}
        while True:
            line = f.readline()
            if line in (b"\n", b"\r\n", b""):
                break
            text = line.decode("ascii", errors="replace").strip()
            if text.startswith("#") or ":" not in text:
                continue
            key, _, value = text.partition(":")
            header[key.strip().lower()] = value.lstrip("=").strip()
        payload = f.read()

    if "data file" in header or "datafile" in header:
        raise NotImplementedError("detached NRRD data files are not supported")

    dtype = _NRRD_DTYPES[header["type"].lower()]
    sizes = [int(s) for s in header["sizes"].split()]
    encoding = header.get("encoding", "raw").lower()
    endian = header.get("endian", "little").lower()

    if encoding in ("gzip", "gz"):
        payload = gzip.decompress(payload)
    elif encoding != "raw":
        raise NotImplementedError(f"NRRD encoding {encoding!r} not supported")

    arr = np.frombuffer(payload, dtype=dtype, count=int(np.prod(sizes)))
    if endian == "big" and arr.dtype.itemsize > 1:
        arr = arr.byteswap()
    # NRRD sizes list fastest axis first; C-order reshape needs the reverse.
    return arr.reshape(sizes[::-1])


def write_nrrd(path: Path | str, array: np.ndarray, encoding: str = "gzip") -> None:
    """Write a numpy array (z, y, x order) as NRRD (for tests/tools)."""
    inv = {v: k for k, v in _NRRD_DTYPES.items()}
    type_name = inv[array.dtype.type]
    sizes = " ".join(str(s) for s in array.shape[::-1])
    header = (
        "NRRD0004\n"
        f"type: {type_name}\n"
        f"dimension: {array.ndim}\n"
        f"sizes: {sizes}\n"
        f"encoding: {encoding}\n"
        "endian: little\n"
        "\n"
    )
    payload = np.ascontiguousarray(array).tobytes()
    if encoding == "gzip":
        payload = gzip.compress(payload)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(payload)
