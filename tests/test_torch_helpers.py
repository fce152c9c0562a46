"""Four small public helpers of the port against the JAX package's:
``metrics.per_class_metrics``, ``schedule.linear_ramp_up``,
``ops.resize.resize_longest_side`` and ``transforms.get_valid_transform``."""

import numpy as np
import torch

import jax.numpy as jnp

from mia_tpu.metrics.metrics import per_class_metrics as jax_per_class_metrics
from mia_tpu.ops.resize import resize_longest_side as jax_resize_longest_side
from mia_tpu.schedule import linear_ramp_up as jax_linear_ramp_up
from mia_tpu.transforms import get_valid_transform as jax_get_valid_transform
from mia_tpu_torch.metrics import per_class_metrics
from mia_tpu_torch.ops.resize import resize_longest_side
from mia_tpu_torch.schedule import linear_ramp_up
from mia_tpu_torch.transforms import get_valid_transform


def test_per_class_metrics_match_jax():
    rng = np.random.default_rng(0)
    gt = np.zeros((24, 28), np.int32)
    gt[4:14, 5:15], gt[12:20, 16:26] = 1, 2
    pred = gt.copy()
    pred[rng.random(gt.shape) > 0.9] = 3  # class 3: predicted, never in gt
    pred[4:8, 5:9] = 0
    got = per_class_metrics(torch.from_numpy(pred), torch.from_numpy(gt), 5, (1.5, 0.5)).numpy()
    want = np.asarray(jax_per_class_metrics(jnp.asarray(pred), jnp.asarray(gt), 5, (1.5, 0.5)))
    assert got.shape == want.shape == (4, 4) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6, equal_nan=True)


def test_linear_ramp_up_matches_jax():
    for max_steps, interval in ((100, 1), (100, 7), (0, 1)):
        ours, ref = linear_ramp_up(0.3, max_steps, interval), jax_linear_ramp_up(0.3, max_steps, interval)
        for step in (-3, 0, 1, 13, 50, 99, 100, 250):
            assert isinstance(ours(step), float)
            np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-7)


def test_resize_longest_side_matches_jax():
    image = np.random.default_rng(1).random((2, 30, 47, 3)).astype(np.float32)
    for method in ("bilinear", "nearest"):
        got = resize_longest_side(torch.from_numpy(image), 64, method).numpy()
        want = np.asarray(jax_resize_longest_side(jnp.asarray(image), 64, method))
        assert got.shape == want.shape == (2, 41, 64, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_valid_transform_is_empty_as_in_jax():
    assert get_valid_transform().transforms == [] == jax_get_valid_transform().transforms
    image = torch.rand(2, 8, 8, 1)
    label = torch.zeros(2, 8, 8, dtype=torch.long)
    out, out_label = get_valid_transform()(torch.Generator(), image, label)
    assert out is image and out_label is label
