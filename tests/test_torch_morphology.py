"""The dilate/erode family and ``UnetProcessor`` against ``mia_tpu``, bit for bit.

Masks come from seeded numpy. Max/min filters, connected components and the
class-priority refill are exact in both packages, so their results are
compared with ``array_equal``. The boundary smoothing thresholds a float32
blur at 127, where the two packages may differ by an ulp: every smoothing
case first checks, on the port's own blur, that no blurred value lies within
1e-3 of 127 (a 0/255 mask under a 7-tap kernel takes few distinct values, and
the seeds used here leave none of them there), so a tie cannot decide a pixel.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.processor import UnetProcessor as JaxProcessor
from mia_tpu.ops import morphology as jmorph

import torch

from mia_tpu_torch.models import UnetProcessor
from mia_tpu_torch.ops import morphology as tmorph
from mia_tpu_torch.ops.filters import gaussian_blur


def _blobs(rng, n, h, w, classes=3, speckle=0.03):
    """Seeded class maps: a few ellipses a class, then salt-and-pepper noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    maps = np.zeros((n, h, w), np.int32)
    for i in range(n):
        for c in range(1, classes):
            for _ in range(2):
                cy, cx = rng.uniform(0.1, 0.9) * h, rng.uniform(0.1, 0.9) * w
                ry, rx = rng.uniform(0.08, 0.3) * h, rng.uniform(0.08, 0.3) * w
                maps[i][((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0] = c
        noise = rng.random((h, w)) < speckle
        maps[i][noise] = rng.integers(0, classes, noise.sum())
    return maps


def _no_tie_at_127(binary_masks, kernel_size):
    """True when the port's blur of the 0/255 masks stays 1e-3 away from 127."""
    sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    x = torch.from_numpy((binary_masks > 0).astype(np.float32))[..., None] * 255.0
    n = x.shape[0]
    blur = gaussian_blur(x, torch.full((n,), sigma), torch.full((n,), kernel_size),
                         max_kernel_size=kernel_size)
    return bool(((blur - 127.0).abs() > 1e-3).all())


@pytest.mark.parametrize("radius", [1, 2, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.int32, np.uint8])
def test_dilate_erode_fill_hole_remove_cc_bit_exact(radius, dtype):
    rng = np.random.default_rng(radius)
    masks = ((_blobs(rng, 3, 37, 45) > 0) * 255).astype(dtype)
    for name, args in (("dilate", (radius,)), ("erode", (radius,)),
                       ("fill_hole", (radius, max(radius - 1, 1))),
                       ("remove_cc", (max(radius - 1, 1), radius))):
        want = np.stack([np.asarray(getattr(jmorph, name)(jnp.asarray(m), *args)) for m in masks])
        got = getattr(tmorph, name)(torch.from_numpy(masks), *args)
        assert got.dtype == torch.from_numpy(masks).dtype, name
        assert np.array_equal(got.numpy(), want), name
    # one mask without a batch axis
    assert np.array_equal(tmorph.dilate(torch.from_numpy(masks[0]), radius).numpy(),
                          np.asarray(jmorph.dilate(jnp.asarray(masks[0]), radius)))


@pytest.mark.parametrize("connectivity,min_size", [(2, 6), (1, 6), (2, 40)])
def test_remove_small_regions_bit_exact(connectivity, min_size):
    rng = np.random.default_rng(11)
    masks = (_blobs(rng, 3, 30, 34, speckle=0.08) > 0).astype(np.int32)
    want = np.stack([np.asarray(jmorph.remove_small_regions(jnp.asarray(m), min_size, connectivity))
                     for m in masks])
    got = tmorph.remove_small_regions(torch.from_numpy(masks), min_size, connectivity).numpy()
    assert np.array_equal(got, want)
    assert 0 < got.sum() < masks.sum()  # something went and something stayed
    # converged labels: a snake that 16 sweeps do not finish
    snake = np.zeros((40, 40), np.int32)
    for r in range(0, 40, 2):
        snake[r] = 1
        if r + 1 < 40:
            snake[r + 1, 39 if (r // 2) % 2 == 0 else 0] = 1
    want = np.asarray(jmorph.connected_components(jnp.asarray(snake), connectivity=1))
    got = tmorph.connected_components(torch.from_numpy(snake), connectivity=1, max_iters=None)
    assert np.array_equal(got.numpy(), want) and set(np.unique(want)) == {-1, 0}


@pytest.mark.parametrize("kernel_size", [3, 7])
def test_gaussian_blur_threshold_smooth_bit_exact(kernel_size):
    rng = np.random.default_rng(12)
    masks = ((_blobs(rng, 4, 40, 48) > 0) * 255).astype(np.float32)
    assert _no_tie_at_127(masks, kernel_size)
    want = np.stack([np.asarray(jmorph.gaussian_blur_threshold_smooth(jnp.asarray(m), kernel_size))
                     for m in masks])
    got = tmorph.gaussian_blur_threshold_smooth(torch.from_numpy(masks), kernel_size).numpy()
    assert np.array_equal(got, want)
    assert set(np.unique(got)) == {0.0, 1.0} and (got != (masks > 0)).any()


@pytest.mark.parametrize("num_classes,seed", [(2, 13), (3, 14)])
def test_denoise_one_mask_and_postprocess_bit_exact(num_classes, seed):
    rng = np.random.default_rng(seed)
    maps = _blobs(rng, 3, 40, 48, classes=num_classes + 1)
    kw = dict(image_size=(32, 32), dilate_size=3, erode_size=3, smooth_kernel=5,
              num_denoise_classes=num_classes)
    jp, tp = JaxProcessor(**kw), UnetProcessor(**kw)
    # ties: the masks the denoise smooths are cleaned first, so check those
    cleaned = [tp._clean(torch.nn.functional.pad(torch.from_numpy((m * 255.0).astype(np.float32)),
                                                 (3, 3, 3, 3)))[..., 3:-3, 3:-3].numpy()
               for m in [maps > 0] + [maps == c for c in range(1, num_classes)]]
    assert all(_no_tie_at_127(c, 5) for c in cleaned)

    want = np.asarray(jax.vmap(jp.denoise_one_mask)(jnp.asarray(maps)))
    got = tp.denoise_one_mask(torch.from_numpy(maps))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tp.denoise_one_mask(torch.from_numpy(maps[0])).numpy(), want[0])
    assert (want != maps).any() and set(np.unique(want)) <= set(range(num_classes + 1))

    # postprocess: nearest resize back from the model size, then the denoise
    small = _blobs(rng, 2, 32, 32, classes=num_classes + 1)
    cleaned = [tp._clean(torch.nn.functional.pad(
        torch.from_numpy(np.asarray(jp.postprocess(jnp.asarray(small), (40, 48))) == c).float() * 255.0,
        (3, 3, 3, 3)))[..., 3:-3, 3:-3].numpy() for c in range(1, num_classes)]
    assert all(_no_tie_at_127(c, 5) for c in cleaned)
    for do_denoise in (False, True):
        want = np.asarray(jp.postprocess(jnp.asarray(small), (40, 48), do_denoise))
        got = tp.postprocess(torch.from_numpy(small), (40, 48), do_denoise)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want), do_denoise
    assert np.array_equal(tp.postprocess(torch.from_numpy(small[0]), (40, 48), True).numpy(),
                          np.asarray(jp.postprocess(jnp.asarray(small[0]), (40, 48), True)))


def test_preprocess_matches_jax():
    rng = np.random.default_rng(15)
    images = rng.random((2, 40, 48, 3)).astype(np.float32)
    jp, tp = JaxProcessor(image_size=32), UnetProcessor(image_size=32)
    want = np.asarray(jp.preprocess(jnp.asarray(images)))
    got = tp.preprocess(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # float32 matmul order
    one = tp.preprocess(torch.from_numpy(images[0]))
    assert one.shape == (1, 32, 32, 3)
    assert UnetProcessor(image_size=None).preprocess(torch.from_numpy(images)).shape == images.shape
