"""Dependency-free NIfTI-1 reader/writer (.nii / .nii.gz).

Copied from ``mia_tpu/utils/nifti.py`` (host-only; ``mia_tpu/utils/__init__``
imports JAX).

Replaces the reference's SimpleITK NIfTI usage in the SAM test path
(``src/models/segment_anything/validation.py:468-493``: read raw-case
spacing, write prediction volumes) without pulling SimpleITK/nibabel into
the image. Same pattern as the NRRD codec in ``mia_tpu/utils/images.py``.

Conventions follow SimpleITK's array bridge: arrays are (z, y, x) =
(D, H, W) C-order numpy (x fastest — NIfTI's on-disk Fortran order over
(x, y, z) dims), and ``spacing`` is (sx, sy, sz) like ``GetSpacing()``.
"""

from __future__ import annotations

import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _open_bytes(path: Path | str) -> bytes:
    raw = Path(path).read_bytes()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    return raw


def read_nifti(path: Path | str) -> tuple[np.ndarray, tuple[float, float, float]]:
    """→ (volume (D, H, W) [or (H, W) for 2-D], spacing (sx, sy, sz))."""
    raw = _open_bytes(path)
    if len(raw) < 352:
        raise ValueError(f"{path}: truncated NIfTI (<352 bytes)")
    (sizeof_hdr,) = struct.unpack_from("<i", raw, 0)
    bo = "<"
    if sizeof_hdr != 348:
        (sizeof_hdr,) = struct.unpack_from(">i", raw, 0)
        if sizeof_hdr != 348:
            raise ValueError(f"{path}: not a NIfTI-1 file")
        bo = ">"
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"{path}: bad NIfTI magic {magic!r}")

    dim = struct.unpack_from(f"{bo}8h", raw, 40)
    (datatype,) = struct.unpack_from(f"{bo}h", raw, 70)
    pixdim = struct.unpack_from(f"{bo}8f", raw, 76)
    (vox_offset,) = struct.unpack_from(f"{bo}f", raw, 108)
    slope, inter = struct.unpack_from(f"{bo}2f", raw, 112)

    if datatype not in _DTYPES:
        raise ValueError(f"{path}: unsupported NIfTI datatype {datatype}")
    ndim = int(dim[0])
    if not 1 <= ndim <= 7:
        raise ValueError(f"{path}: bad ndim {ndim}")
    shape_xyz = [max(1, int(d)) for d in dim[1 : 1 + ndim]]
    dtype = np.dtype(_DTYPES[datatype]).newbyteorder(bo)
    count = int(np.prod(shape_xyz))
    data = np.frombuffer(raw, dtype=dtype, count=count, offset=int(vox_offset))
    # on-disk Fortran order over (x, y, z, ...) == C order over reversed dims
    arr = data.reshape(shape_xyz[::-1])
    if slope not in (0.0, 1.0) or inter != 0.0:
        arr = arr * np.float32(slope if slope != 0.0 else 1.0) + np.float32(inter)
    spacing = tuple(float(abs(p)) or 1.0 for p in pixdim[1:4])
    return np.ascontiguousarray(arr), spacing


def write_nifti(
    path: Path | str,
    volume: np.ndarray,
    spacing: tuple[float, float, float] = (1.0, 1.0, 1.0),
) -> None:
    """Write ``volume`` ((D, H, W) or (H, W)) with voxel ``spacing``
    (sx, sy, sz); gzip-compresses when the suffix is ``.gz``.

    int64 narrows to int32 (raising on overflow) and float64 to float32
    (precision-lossy, like SimpleITK's default float image writes)."""
    volume = np.ascontiguousarray(volume)
    if volume.dtype == np.int64:
        info = np.iinfo(np.int32)
        if volume.size and (
            volume.max() > info.max or volume.min() < info.min
        ):
            raise ValueError(
                "int64 volume exceeds int32 range; cast explicitly before "
                "write_nifti"
            )
        volume = volume.astype(np.int32)
    if volume.dtype == np.float64:
        volume = volume.astype(np.float32)
    if volume.dtype == np.bool_:
        volume = volume.astype(np.uint8)
    code = _CODES.get(volume.dtype)
    if code is None:
        raise ValueError(f"unsupported dtype for NIfTI write: {volume.dtype}")

    shape_xyz = list(volume.shape[::-1])
    dim = [volume.ndim] + shape_xyz + [1] * (7 - len(shape_xyz))
    pixdim = [1.0] + [float(s) for s in spacing[: volume.ndim]]
    pixdim += [1.0] * (8 - len(pixdim))

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, volume.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<2f", hdr, 112, 1.0, 0.0)  # scl_slope / scl_inter
    struct.pack_into("<b", hdr, 123, 2)  # xyzt_units: millimeters
    # qform/sform code 0 + identity-ish srow for maximal reader tolerance
    struct.pack_into("<2h", hdr, 252, 0, 1)  # qform_code=0, sform_code=1
    struct.pack_into("<4f", hdr, 280, spacing[0], 0, 0, 0)  # srow_x
    struct.pack_into("<4f", hdr, 296, 0, spacing[1], 0, 0)  # srow_y
    struct.pack_into("<4f", hdr, 312, 0, 0, spacing[2] if len(spacing) > 2 else 1.0, 0)
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00\x00\x00\x00" + volume.tobytes()
    path = Path(path)
    if path.suffix == ".gz":
        path.write_bytes(gzip.compress(payload, 6))
    else:
        path.write_bytes(payload)
