"""Reader and writer of flax's msgpack checkpoints
(``flax.serialization.to_bytes``), in pure Python: no ``msgpack`` package,
no flax, no JAX.

The layout is one msgpack map of the state dict (nested maps with string
keys). Leaves are msgpack scalars, strings, nil or bool, or flax's ext
types:

- 1, ``ndarray``: a packed ``(shape, dtype name, C-order bytes)``;
- 2, ``native_complex``: a packed ``(real, imag)``;
- 3, ``npscalar``: an ndarray of shape ``()``, returned as a numpy scalar.

Arrays larger than flax's chunk size arrive as maps marked
``__msgpack_chunked_array__`` and are joined again. ``bfloat16`` arrays are
widened to float32 (numpy has no bfloat16). :func:`read_flax_msgpack`
returns the nested dict of numpy arrays that
``models/flax_bridge.py``'s converters take.

:func:`write_flax_msgpack` / :func:`to_bytes` write such a state dict back:
numpy arrays (and 0-d arrays for optax's scalars) as ext type 1, arrays over
:data:`MAX_CHUNK_SIZE` bytes chunked as flax chunks them, each msgpack value
in the form the ``msgpack`` package picks. Map keys go out in sorted order, the order of the JAX package's own
files (its trees pass through ``jax.tree.map``; a chunked array's maps keep
flax's order), so the same state dict gives the same bytes.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# flax.serialization.MAX_CHUNK_SIZE: arrays of more bytes are written in chunks
MAX_CHUNK_SIZE = 2**30


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):  # bin 8 / 16 / 32
            return bytes(self.take(self.unpack(">" + "BHI"[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8 / 16 / 32
            n = self.unpack(">" + "BHI"[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xCF:
            return self.unpack(">" + "BHIQ"[b - 0xCC])
        if 0xD0 <= b <= 0xD3:
            return self.unpack(">" + "bhiq"[b - 0xD0])
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return str(self.take(self.unpack(">" + "BHI"[b - 0xD9])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">" + "HI"[b - 0xDC]))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">" + "HI"[b - 0xDE]))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not used by flax")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def ext(self, code: int, n: int):
        payload = bytes(self.take(n))
        if code in (_NDARRAY, _NPSCALAR):
            arr = _ndarray(payload)
            return arr[()] if code == _NPSCALAR else arr
        if code == _COMPLEX:
            real, imag = unpackb(payload)
            return complex(real, imag)
        raise ValueError(f"msgpack ext type {code} is not one of flax's")


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(payload)
    if dtype_name == "bfloat16":  # the upper half of a float32
        bits = np.frombuffer(buf, np.uint16).astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(dtype_name)).reshape(shape).copy()


def unpackb(data: bytes):
    """Decode one msgpack object (with flax's ext types) from ``data``."""
    reader = _Reader(data)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes after the msgpack object")
    return out


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(source: bytes | str | Path) -> dict:
    """The state dict of a flax msgpack checkpoint (bytes or a file path)
    as nested dicts of numpy arrays."""
    data = source if isinstance(source, (bytes, bytearray)) else Path(source).read_bytes()
    return _unchunk(unpackb(data))


# --- writer -------------------------------------------------------------------


def _header(out: list, n: int, small: int | None, fix: int, wide: tuple[int, ...]) -> None:
    """A length header: ``fix | n`` below ``small``, else the first of the
    8/16/32-bit forms ``wide`` (``None`` where a form does not exist) that holds n."""
    if small is not None and n < small:
        out.append(bytes((fix | n,)))
        return
    for code, fmt, top in zip(wide, "BHI", (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(struct.pack(">B" + fmt, code, n))
            return
    raise ValueError(f"msgpack cannot hold a length of {n}")


def _uint(out: list, v: int) -> None:
    """A non-negative integer (the only kind a flax state dict holds: shapes)."""
    if 0 <= v < 0x80:
        out.append(bytes((v,)))
        return
    for code, fmt, top in ((0xCC, "B", 0xFF), (0xCD, "H", 0xFFFF), (0xCE, "I", 0xFFFFFFFF),
                           (0xCF, "Q", 0xFFFFFFFFFFFFFFFF)):
        if 0 <= v <= top:
            out.append(struct.pack(">B" + fmt, code, v))
            return
    raise OverflowError(f"{v} is not an integer the writer writes")


def _ext(out: list, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(bytes((fixed[n],)))
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(struct.pack("b", code))
    out.append(payload)


def _ndarray_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f"arrays of dtype {arr.dtype} cannot be written")
    return packb((list(arr.shape), arr.dtype.name, arr.tobytes("C")))


def _pack(out: list, v, sort: bool = True) -> None:
    if isinstance(v, bool):
        out.append(b"\xc3" if v else b"\xc2")
    elif isinstance(v, int):
        _uint(out, v)
    elif isinstance(v, str):
        data = v.encode("utf-8")
        _header(out, len(data), 32, 0xA0, (0xD9, 0xDA, 0xDB))
        out.append(data)
    elif isinstance(v, (bytes, bytearray)):
        _header(out, len(v), None, 0, (0xC4, 0xC5, 0xC6))
        out.append(bytes(v))
    elif isinstance(v, (list, tuple)):
        _header(out, len(v), 16, 0x90, (None, 0xDC, 0xDD))
        for item in v:
            _pack(out, item, sort)
    elif isinstance(v, dict):
        # a chunked array's maps keep flax's own order
        sort = sort and _CHUNKED not in v
        _header(out, len(v), 16, 0x80, (None, 0xDE, 0xDF))
        for key in sorted(v) if sort else v:
            _pack(out, key)
            _pack(out, v[key], sort)
    elif isinstance(v, np.ndarray):
        _ext(out, _NDARRAY, _ndarray_bytes(v))
    else:
        raise TypeError(f"cannot write a {type(v).__name__} to msgpack")


def packb(value) -> bytes:
    """Encode one object as msgpack: the types of a flax state dict (maps,
    strings, non-negative integers, booleans, numpy arrays as ext type 1) and
    of an array's payload (lists, bytes)."""
    out: list[bytes] = []
    _pack(out, value)
    return b"".join(out)


def _chunk(arr: np.ndarray) -> dict:
    size = max(1, int(MAX_CHUNK_SIZE / arr.dtype.itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.size, size)]
    return {_CHUNKED: True, "shape": {str(i): n for i, n in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def _chunked(tree):
    if isinstance(tree, dict):
        return {k: _chunked(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(state_dict: dict) -> bytes:
    """A state dict (nested dicts with string keys, numpy leaves) as the
    bytes ``flax.serialization.to_bytes`` writes."""
    return packb(_chunked(state_dict))


def write_flax_msgpack(state_dict: dict, path: str | Path) -> None:
    """Write ``state_dict`` to ``path`` in flax's msgpack layout."""
    Path(path).write_bytes(to_bytes(state_dict))
