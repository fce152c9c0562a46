"""Label-Studio brush RLE codec + annotation helpers.

The reference delegates to ``label_studio_converter.brush``
(``src/entry/fugc2025/preprocess/mask2rle.py:7``, ``rle2mask.py:7``); that
package is not in this image, so the bit-level brush RLE format is
implemented here (32-bit count, 5-bit word size, 4×4-bit run-size table,
then '0'-prefixed literals / '1'-prefixed runs). If the upstream package is
importable it is preferred, keeping byte-exact interop.

``mask2annotation`` reproduces the reference's Label-Studio task JSON
(``mask2rle.py:24-63``), including its width/height field order.

Copied from ``mia_tpu/tools/label_studio.py`` (host numpy; the port keeps its
own copy of what it needs from the JAX package).
"""

from __future__ import annotations

import uuid

import numpy as np

try:  # prefer the upstream codec when present (byte-exact interop)
    from label_studio_converter.brush import decode_rle as _ls_decode
    from label_studio_converter.brush import encode_rle as _ls_encode

    _HAS_LS = True
except Exception:  # pragma: no cover
    _HAS_LS = False

_RLE_SIZES = (3, 4, 8, 16)


def _runs(arr: np.ndarray):
    """(lengths, values) run-length pairs of a 1-D array."""
    n = len(arr)
    if n == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint8)
    changes = np.flatnonzero(arr[1:] != arr[:-1]) + 1
    starts = np.concatenate([[0], changes])
    ends = np.concatenate([changes, [n]])
    return ends - starts, arr[starts]


def encode_rle(arr: np.ndarray, wordsize: int = 8) -> list[int]:
    """Encode a flat uint8 array into Label-Studio brush RLE ints."""
    if _HAS_LS:
        return _ls_encode(np.asarray(arr, np.uint8))
    arr = np.asarray(arr, np.uint8).ravel()
    bits = [f"{len(arr):032b}", f"{wordsize - 1:05b}"]
    bits += [f"{s - 1:04b}" for s in _RLE_SIZES]

    lengths, values = _runs(arr)
    for length, value in zip(lengths.tolist(), values.tolist()):
        if length == 1:
            bits.append("0" + "00" + "000" + f"{value:08b}")
        elif length <= 8:
            bits.append("1" + "00" + f"{length - 1:03b}" + f"{value:08b}")
        elif length <= 16:
            bits.append("1" + "01" + f"{length - 1:04b}" + f"{value:08b}")
        elif length <= 256:
            bits.append("1" + "10" + f"{length - 1:08b}" + f"{value:08b}")
        else:
            while length > 2**16:
                bits.append("1" + "11" + f"{2**16 - 1:016b}" + f"{value:08b}")
                length -= 2**16
            if length > 0:
                bits.append("1" + "11" + f"{length - 1:016b}" + f"{value:08b}")

    total = "".join(bits)
    total += "0" * ((8 - len(total) % 8) % 8)
    return [int(total[i : i + 8], 2) for i in range(0, len(total), 8)]


class _InputStream:
    def __init__(self, data: str):
        self.data = data
        self.i = 0

    def read(self, size: int) -> int:
        out = self.data[self.i : self.i + size]
        self.i += size
        return int(out, 2)


def decode_rle(rle) -> np.ndarray:
    """Decode Label-Studio brush RLE ints into a flat uint8 array."""
    if _HAS_LS:
        return _ls_decode(rle)
    stream = _InputStream("".join(f"{b:08b}" for b in rle))
    num = stream.read(32)
    word_size = stream.read(5) + 1
    rle_sizes = [stream.read(4) + 1 for _ in range(4)]
    out = np.zeros(num, dtype=np.uint8)
    i = 0
    while i < num:
        x = stream.read(1)
        j = i + 1 + stream.read(rle_sizes[stream.read(2)])
        if x:
            out[i:j] = stream.read(word_size)
            i = j
        else:
            while i < j:
                out[i] = stream.read(word_size)
                i += 1
    return out


def mask2rle(mask: np.ndarray) -> list[int]:
    """2-D uint8 mask → brush RLE (pixels repeated ×4 for RGBA)."""
    mask = np.asarray(mask, np.uint8)
    assert mask.ndim == 2, "mask must be 2D np.array"
    return encode_rle(np.repeat(mask.ravel(), 4))


def mask2annotation(
    mask: np.ndarray,
    label_names: dict[int, str],
    from_name: str,
    to_name: str,
    ground_truth: bool = False,
    model_version=None,
    score=None,
) -> dict:
    """Per-class brush results for one mask (``mask2rle.py:24-63``; the
    reference assigns ``width, height = mask.shape`` — preserved)."""
    width, height = mask.shape
    result = {"result": []}
    for class_id, name in label_names.items():
        rle = mask2rle(((mask == class_id) * 255).astype(np.uint8))
        result["result"].append(
            {
                "id": str(uuid.uuid4())[0:8],
                "type": "brushlabels",
                "value": {"rle": rle, "format": "rle", "brushlabels": [name]},
                "origin": "manual",
                "to_name": to_name,
                "from_name": from_name,
                "image_rotation": 0,
                "original_width": width,
                "original_height": height,
            }
        )
    if model_version:
        result["model_version"] = model_version
        result["score"] = score
    else:
        result["ground_truth"] = ground_truth
    return result


def remove_noise_diagonal(image: np.ndarray, threshold: int) -> np.ndarray:
    """Flip sub-threshold connected components of a 0/255 mask.

    The reference BFS explores only DIAGONAL neighbors
    (``rle2mask.py:55-59``: ``if dx != 0 and dy != 0``) — preserved via a
    diagonal-only connectivity structure.
    """
    from scipy import ndimage

    structure = np.array([[1, 0, 1], [0, 1, 0], [1, 0, 1]], bool)
    res = image.copy()
    labels, n = ndimage.label(image > 0, structure=structure)
    if n == 0:
        return res
    sizes = np.bincount(labels.ravel())
    small = np.flatnonzero(sizes < threshold)
    small = small[small != 0]
    if small.size:
        flip = np.isin(labels, small)
        res[flip] = 255 - res[flip]
    return res
