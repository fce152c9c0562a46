"""Metrics and entropy selection of the port against the JAX package.

- ``metric_percase`` (DSC / HD / ASD / JC with the reference empty-mask
  conventions) on random masks, empty ones included, as 2D images and as
  the depth-1 volumes the trainer's slice validation uses.
- The entropy pool sweep over a 10-image FUGC pool with weights moved from
  flax: the same scores and the same selected case ids.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.activelearning import EntropySelector as JaxEntropySelector
from mia_tpu.activelearning import ModelScorer as JaxScorer
from mia_tpu.activelearning.scorers import sweep_pool as jax_sweep_pool
from mia_tpu.data import ActiveDataset as JaxActive, ExtendableDataset as JaxExt
from mia_tpu.data import FUGCDataset as JaxFUGC
from mia_tpu.metrics.metrics import metric_percase as jax_metric_percase
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu_torch.activelearning import EntropySelector, ModelScorer, sweep_pool
from mia_tpu_torch.data import ActiveDataset, ExtendableDataset, FUGCDataset
from mia_tpu_torch.metrics import metric_percase
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_from_flax
from synth_data import make_fugc


def _blob(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    cy, cx = rng.uniform(0, h), rng.uniform(0, w)
    ry, rx = rng.uniform(2, h / 3), rng.uniform(2, w / 3)
    return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0


def _mask_pairs():
    rng = np.random.default_rng(0)
    h, w = 28, 36
    pairs = []
    for _ in range(6):
        pairs.append((_blob(rng, h, w), _blob(rng, h, w)))
    pairs.append((rng.random((h, w)) < 0.3, rng.random((h, w)) < 0.3))  # speckle
    empty = np.zeros((h, w), bool)
    pairs += [(empty, _blob(rng, h, w)), (_blob(rng, h, w), empty), (empty, empty)]
    return pairs


@pytest.mark.parametrize("spacing", [None, (1.0, 1.0, 1.0), (2.5, 0.8, 1.3)])
def test_metric_percase_matches_jax(spacing):
    jax_metrics = jax.jit(jax_metric_percase, static_argnums=2)
    for pred, gt in _mask_pairs():
        if spacing is None:  # 2D masks
            p, g, sp = pred, gt, None
        else:  # depth-1 volumes, as slice validation feeds them
            p, g, sp = pred[None], gt[None], spacing
        want = [float(v) for v in jax_metrics(jnp.asarray(p), jnp.asarray(g), sp)]
        got = [float(v) for v in metric_percase(torch.from_numpy(p), torch.from_numpy(g), sp)]
        for name, a, b, tol in zip(("dsc", "hd", "asd", "jc"), got, want,
                                   (1e-6, 1e-4, 1e-4, 1e-6)):
            np.testing.assert_allclose(a, b, rtol=0, atol=tol, equal_nan=True, err_msg=name)


# ---------------------------------------------------------------------------
# entropy selection
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3, channels_list=(8, 16, 32),
                               dropout_prob=0.0))
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = jax.tree.map(np.array, init(jax.random.key(2), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(2)
    for scope in ("encoder", "decoder"):
        for stats in variables["batch_stats"][scope].values():
            n = stats["norm"]["mean"].shape
            stats["norm"]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            stats["norm"]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return jm, variables


@pytest.fixture(scope="module")
def fugc_pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("fugc_pool")
    make_fugc(root, n_train=12, n_val=1, n_test=1, size=(40, 48))
    return root


def _active(root, dataset_cls, ext_cls, active_cls):
    base = dataset_cls(data_path=root, split="train", image_channels=3, image_size=32)
    names = base.case_names()
    return active_cls(ext_cls(base, names[:2]), ext_cls(base, names[2:]))


def test_entropy_sweep_and_selection_match_jax(fugc_pool):
    jm, variables = _weights()
    jax_state = types.SimpleNamespace(params=variables["params"],
                                      batch_stats=variables["batch_stats"])
    jscorer = JaxScorer(jm, jax_state, normalize=True)
    tm = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=(8, 16, 32),
                         dropout_prob=0.0))
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    tscorer = ModelScorer(tm, torch.device("cpu"), normalize=True)

    jactive = _active(fugc_pool, JaxFUGC, JaxExt, JaxActive)
    tactive = _active(fugc_pool, FUGCDataset, ExtendableDataset, ActiveDataset)
    assert len(tactive.get_pool_dataset()) == 10

    want, jnames = jax_sweep_pool(jactive.get_pool_dataset(), 4,
                                  lambda im: jscorer.uncertainty(im, "entropy"))
    got, tnames = sweep_pool(tactive.get_pool_dataset(), 4,
                             lambda im: tscorer.uncertainty(im, "entropy"), torch.device("cpu"))
    assert tnames == jnames
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)

    picks_j = JaxEntropySelector(batch_size=4).select_next_batch(jactive, 3, jscorer, seed=0)
    picks_t = EntropySelector(batch_size=4).select_next_batch(tactive, 3, tscorer, seed=0)
    assert picks_t == picks_j
    assert len(set(picks_t)) == 3


def test_random_pick_matches_jax_when_nothing_is_labeled(fugc_pool):
    jbase = JaxFUGC(data_path=fugc_pool, split="train", image_size=32)
    tbase = FUGCDataset(data_path=fugc_pool, split="train", image_size=32)
    jactive = JaxActive(JaxExt(jbase, []), JaxExt(jbase))
    tactive = ActiveDataset(ExtendableDataset(tbase, []), ExtendableDataset(tbase))
    want = JaxEntropySelector().select_next_batch(jactive, 4, None, seed=7)
    got = EntropySelector().select_next_batch(tactive, 4, None, seed=7)
    assert got == want
