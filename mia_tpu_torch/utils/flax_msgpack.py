"""Reader of flax's msgpack checkpoints (``flax.serialization.to_bytes``),
in pure Python: no ``msgpack`` package, no flax, no JAX.

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
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


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
