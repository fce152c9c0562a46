"""The exact EDT of the port against ``scipy.ndimage``, and the native host
library's EDT and brush codec (``mia_tpu_torch.native``).

- ``ops/distance.py::squared_edt`` (2D and 3D, unit, isotropic and
  anisotropic spacing) equals ``distance_transform_edt(~feature,
  sampling=spacing) ** 2``, and ``squared_edt_2d`` does so plane by plane;
- ``surface_distance_stats`` gives hd, hd95, asd and assd as medpy computes
  them from scipy's EDT of the other mask's border (1-connected erosion);
- ``native.squared_edt_2d`` equals scipy's, and ``brush_rle_encode`` /
  ``brush_rle_decode`` are byte for byte the port's Python codec
  (``tools/label_studio.py``). These skip when the library does not build.
"""

import numpy as np
import pytest
import torch
from scipy import ndimage

from mia_tpu_torch import native
from mia_tpu_torch.ops.distance import squared_edt, squared_edt_2d, surface_distance_stats
from mia_tpu_torch.tools.label_studio import decode_rle, encode_rle

CASES = {
    "2d-unit": ((37, 41), None),
    "2d-aniso": ((37, 41), (2.0, 0.5)),
    "3d-iso": ((9, 17, 13), (1.5, 1.5, 1.5)),
    "3d-aniso": ((9, 17, 13), (3.0, 0.7, 1.2)),
}


def _feature(shape, seed=0, density=0.9):
    feature = np.random.default_rng(seed).random(shape) > density
    feature.flat[0] = True  # never empty
    return feature


def _need_native():
    if not native.is_available():
        pytest.skip(f"the native host library does not build here: {native.unavailable_reason()}")


@pytest.mark.parametrize("case", CASES)
def test_squared_edt_matches_scipy(case):
    shape, spacing = CASES[case]
    feature = _feature(shape)
    got = squared_edt(torch.from_numpy(feature), spacing).numpy()
    want = ndimage.distance_transform_edt(~feature, sampling=spacing) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_batched_squared_edt_2d_matches_scipy_per_plane():
    feature = np.stack([_feature((23, 29), seed=s, density=d)
                        for s, d in ((1, 0.95), (2, 0.5), (3, 0.99))])
    got = squared_edt_2d(torch.from_numpy(feature)).numpy()
    for plane, f in zip(got, feature):
        np.testing.assert_allclose(plane, ndimage.distance_transform_edt(~f) ** 2,
                                   rtol=1e-5, atol=1e-4)


def _blob(shape, center, radius, spacing):
    grid = np.meshgrid(*[np.arange(n) * (spacing or (1.0,) * len(shape))[i]
                         for i, n in enumerate(shape)], indexing="ij")
    return sum((g - c) ** 2 for g, c in zip(grid, center)) <= radius ** 2


def _medpy_stats(pred, ref, spacing):
    structure = ndimage.generate_binary_structure(pred.ndim, 1)

    def border(mask):
        return mask ^ ndimage.binary_erosion(mask, structure=structure, border_value=0)

    def directed(a, b):
        return ndimage.distance_transform_edt(~border(b), sampling=spacing)[border(a)]

    p2r, r2p = directed(pred, ref), directed(ref, pred)
    both = np.concatenate([p2r, r2p])
    return {"hd": max(p2r.max(), r2p.max()), "hd95": np.percentile(both, 95),
            "asd": p2r.mean(), "assd": both.mean()}


@pytest.mark.parametrize("case", CASES)
def test_surface_distance_stats_match_scipy(case):
    shape, spacing = CASES[case]
    scale = np.array(spacing or (1.0,) * len(shape)) * np.array(shape)
    pred = _blob(shape, 0.45 * scale, 0.3 * scale.min(), spacing)
    ref = _blob(shape, 0.55 * scale, 0.25 * scale.min(), spacing)
    ref |= _feature(shape, seed=4, density=0.995)  # speckle: borders of single pixels
    got = surface_distance_stats(torch.from_numpy(pred), torch.from_numpy(ref), spacing)
    want = _medpy_stats(pred, ref, spacing)
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), value, rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("spacing", [(1.0, 1.0), (2.0, 0.5)])
def test_native_squared_edt_2d_matches_scipy(spacing):
    _need_native()
    feature = _feature((37, 41))
    got = native.squared_edt_2d(feature, spacing=spacing)
    want = ndimage.distance_transform_edt(~feature, sampling=spacing) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_native_brush_rle_is_the_python_codec():
    _need_native()
    rng = np.random.default_rng(5)
    long_run = np.zeros(70000, np.uint8)
    long_run[:65999] = 255  # a constant run longer than 2**16
    for arr in [(rng.random(n) > 0.5).astype(np.uint8) * 255 for n in (17, 3000, 70000)] + [long_run]:
        rle = native.brush_rle_encode(arr)
        assert rle == encode_rle(arr)
        np.testing.assert_array_equal(native.brush_rle_decode(rle), arr)
        np.testing.assert_array_equal(decode_rle(rle), arr)
    with pytest.raises(ValueError):
        native.brush_rle_decode([0, 1, 2])
