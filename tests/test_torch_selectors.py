"""The port's feature endpoints and selectors against the JAX package.

A narrow UNet (8, 16, 32) with weights moved from flax by
``unet_state_dict_from_flax`` scores a 10-image FUGC pool (2 labeled) at
32x32, z-scored in the sweep as the AL trainer does:

- ``UNet.enc_feature`` and ``UNet.pixel_feature`` within 1e-5 of max;
- BADGE's gradient embeddings within 1e-5 of max;
- every new selector key (and the coreset / k-means options) end to end
  against ``mia_tpu``'s ``select_next_batch``: the same case ids. The
  k-means++ selectors get the draws of JAX's ``PRNGKey(seed)`` through the
  deterministic core (the packages' generators differ); the uncertainty
  scores at the cut are held apart by more than float32 noise (the tie rule);
- the cold starts: random picks, k-means++ on loaded features, unweighted
  k-means.
"""

import functools
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mia_tpu.activelearning import SELECTORS as JAX_SELECTORS
from mia_tpu.activelearning import ModelScorer as JaxScorer
from mia_tpu.activelearning.scorers import sweep_pool as jax_sweep_pool
from mia_tpu.data import ActiveDataset as JaxActive, ExtendableDataset as JaxExt
from mia_tpu.data import FUGCDataset as JaxFUGC
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu_torch.activelearning import SELECTORS, ModelScorer, selectors, sweep_pool
from mia_tpu_torch.activelearning.selection import kmeans_plusplus_from_draws
from mia_tpu_torch.data import ActiveDataset, ExtendableDataset, FUGCDataset
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_from_flax
from synth_data import make_fugc
from test_torch_selection import jax_kmeans_draws

CPU = torch.device("cpu")
CFG = dict(in_channels=3, out_classes=3, channels_list=(8, 16, 32), dropout_prob=0.0)


@functools.lru_cache(maxsize=None)
def _weights():
    jm = JaxUNet(JaxUNetConfig(**CFG))
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = jax.tree.map(np.array, init(jax.random.key(3), jnp.zeros((1, 32, 32, 3))))
    rng = np.random.default_rng(3)
    for scope in ("encoder", "decoder"):
        for stats in variables["batch_stats"][scope].values():
            n = stats["norm"]["mean"].shape
            stats["norm"]["mean"] = rng.normal(0, 0.2, n).astype(np.float32)
            stats["norm"]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
    return jm, variables


@pytest.fixture(scope="module")
def scorers():
    jm, variables = _weights()
    state = types.SimpleNamespace(params=variables["params"], batch_stats=variables["batch_stats"])
    tm = UNet(UNetConfig(**CFG))
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    return JaxScorer(jm, state, normalize=True), ModelScorer(tm, CPU, normalize=True)


@pytest.fixture(scope="module")
def fugc_pool(tmp_path_factory):
    root = tmp_path_factory.mktemp("fugc_sel")
    make_fugc(root, n_train=12, n_val=1, n_test=1, size=(40, 48))
    return root


@pytest.fixture(scope="module")
def features(tmp_path_factory, fugc_pool):
    """Seeded 12-dim foundation features of every train case: h5 files and a dict."""
    import h5py

    root = tmp_path_factory.mktemp("features")
    names = FUGCDataset(data_path=fugc_pool, split="train").case_names()
    rng = np.random.default_rng(5)
    feats = {n: rng.normal(0, 1, 12).astype(np.float32) for n in names}
    for n, f in feats.items():
        with h5py.File(root / f"{n}.h5", "w") as h5f:
            h5f.create_dataset("feature", data=f)
    return root, feats


def _actives(root, n_labeled=2):
    out = []
    for ds_cls, ext, act in ((JaxFUGC, JaxExt, JaxActive),
                             (FUGCDataset, ExtendableDataset, ActiveDataset)):
        base = ds_cls(data_path=root, split="train", image_channels=3, image_size=32)
        names = base.case_names()
        out.append(act(ext(base, names[:n_labeled]), ext(base, names[n_labeled:])))
    return out


def _images(root):
    base = FUGCDataset(data_path=root, split="train", image_channels=3, image_size=32)
    return np.stack([base.get_sample(i)["image"] for i in range(5)])


@pytest.fixture
def jax_draws(monkeypatch):
    """The port's k-means++ with the draws of JAX's ``PRNGKey(seed)``."""

    def kmeans_plusplus(x, n_clusters, generator, sample_weight=None):
        weight = None if sample_weight is None else sample_weight.cpu().numpy()
        first, uniforms = jax_kmeans_draws(generator.initial_seed(), x.shape[0], n_clusters,
                                           weight)
        return kmeans_plusplus_from_draws(x, first, torch.from_numpy(uniforms), sample_weight)

    monkeypatch.setattr(selectors, "kmeans_plusplus", kmeans_plusplus)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def test_enc_and_pixel_features_match_jax(fugc_pool):
    jm, variables = _weights()
    tm = UNet(UNetConfig(**CFG)).eval()
    tm.load_state_dict(unet_state_dict_from_flax(variables))
    x = _images(fugc_pool).astype(np.float32) / 255.0
    want = jm.apply(variables, jnp.asarray(x), train=False, method=jm.enc_feature)
    with torch.no_grad():
        got = tm.enc_feature(torch.from_numpy(x))
        logits, feature = tm.pixel_feature(torch.from_numpy(x))
        plain = tm(torch.from_numpy(x))
    assert got.shape == (5, 32)
    _close(got, want, 1e-5)
    want_logits, want_feature = jm.apply(variables, jnp.asarray(x), train=False,
                                         method=jm.pixel_feature)
    assert feature.shape == (5, 32, 32, 8)
    _close(logits, want_logits, 1e-5)
    _close(feature, want_feature, 1e-5)
    assert torch.equal(logits, plain)


def test_badge_embeddings_match_jax(scorers, fugc_pool):
    jscorer, tscorer = scorers
    images = _images(fugc_pool)  # uint8, z-scored in the scorer
    want = np.asarray(jscorer.badge_grad_embedding(jnp.asarray(images)))
    got = tscorer.badge_grad_embedding(torch.from_numpy(images))
    assert got.shape == (5, 8 * 3) and not got.requires_grad
    _close(got, want, 1e-5)
    # one image at a time gives the same rows
    one = torch.cat([tscorer.badge_grad_embedding(torch.from_numpy(images[i:i + 1]))
                     for i in range(5)])
    _close(one, got.numpy(), 1e-6)



def test_badge_embedding_takes_given_label_maps(scorers, fugc_pool):
    _, tscorer = scorers
    images = torch.from_numpy(_images(fugc_pool))
    own = tscorer.badge_grad_embedding(images)
    with torch.no_grad():
        argmax = tscorer.model.pixel_feature(tscorer._prep(images))[0].argmax(-1)
    assert torch.equal(tscorer.badge_grad_embedding(images, preds=argmax), own)
    other = tscorer.badge_grad_embedding(images, preds=(argmax + 1) % 3)
    assert other.shape == own.shape and torch.isfinite(other).all()
    assert not torch.allclose(other, own)

def test_enc_feature_sweep_matches_jax(scorers, fugc_pool):
    jscorer, tscorer = scorers
    jactive, tactive = _actives(fugc_pool)
    want, jnames = jax_sweep_pool(jactive.get_pool_dataset(), 4, jscorer.enc_feature)
    got, tnames = sweep_pool(tactive.get_pool_dataset(), 4, tscorer.enc_feature, CPU)
    assert tnames == jnames and got.shape == (10, 32)
    _close(got, want, 1e-5)


CASES = {
    "confidence": ("confidence", {}),
    "margin": ("margin", {}),
    "coreset-l2": ("coreset-l2", {}),
    "coreset-cosine": ("coreset-cosine", {}),
    "coreset-mean": ("coreset-cosine", {"coreset_criteria": "mean"}),
    "coreset-add-loaded": ("coreset-l2", {"loaded_feature_weight": 0.5, "feature_path": True}),
    "coreset-cat-loaded": ("coreset-cosine", {"coreset_fusion": "cat", "loaded_feature_weight": 0.1,
                                              "feature_path": True}),
    "kmean-l2": ("kmean-l2", {}),
    "kmean-cosine": ("kmean-cosine", {}),
    "kmean-softmax-mean": ("kmean-cosine", {"softmax": True, "sharp_factor": 2.0,
                                            "coreset_criteria": "mean"}),
    "kmean-power": ("kmean-l2", {"sharp_factor": 3.0}),
    "kmean-feature-dict": ("kmean-cosine", {"feature_dict": True, "loaded_feature_weight": 0.5}),
    "kmean-loaded-only": ("kmean-l2", {"feature_path": True, "loaded_feature_only": True}),
    "badge": ("badge", {}),
}


def _kwargs(over, features):
    root, feats = features
    kw = dict(over)
    if kw.get("feature_path"):
        kw["feature_path"] = str(root)
    if kw.get("feature_dict"):
        kw["feature_dict"] = feats
    return kw


@pytest.mark.parametrize("case", list(CASES))
def test_selector_picks_the_case_ids_jax_picks(case, scorers, fugc_pool, features, jax_draws):
    key, over = CASES[case]
    jscorer, tscorer = scorers
    jactive, tactive = _actives(fugc_pool)
    kw = _kwargs(over, features)
    if key in ("confidence", "margin"):  # the tie rule: the cut lies above float32 noise
        scores, _ = jax_sweep_pool(jactive.get_pool_dataset(), 4,
                                   lambda im: jscorer.uncertainty(im, key))
        s = np.sort(scores)[::-1]
        assert s[2] - s[3] > 1e-4 * np.abs(s).max()
    want = JAX_SELECTORS[key](batch_size=4, **kw).select_next_batch(jactive, 3, jscorer, seed=2)
    got = SELECTORS[key](batch_size=4, **kw).select_next_batch(tactive, 3, tscorer, seed=2)
    assert got == want
    assert len(set(got)) == len(got) == 3 and set(got) <= set(tactive.pool_dataset.image_idx)


@pytest.mark.parametrize("case", ["confidence", "margin", "badge", "coreset-cosine",
                                  "coreset-weight-no-features", "coreset-cold-start",
                                  "kmean-cosine", "kmean-loaded-only"])
def test_cold_start_matches_jax(case, scorers, fugc_pool, features, jax_draws):
    key, over = {
        "coreset-weight-no-features": ("coreset-l2", {"loaded_feature_weight": 0.5}),
        "coreset-cold-start": ("coreset-cosine", {"loaded_feature_weight": 0.5,
                                                  "feature_path": True}),
        "kmean-loaded-only": ("kmean-cosine", {"feature_dict": True, "loaded_feature_only": True}),
    }.get(case, (case, {}))
    jscorer, tscorer = scorers
    jactive, tactive = _actives(fugc_pool, n_labeled=0)
    kw = _kwargs(over, features)
    want = JAX_SELECTORS[key](batch_size=4, **kw).select_next_batch(jactive, 4, jscorer, seed=3)
    got = SELECTORS[key](batch_size=4, **kw).select_next_batch(tactive, 4, tscorer, seed=3)
    assert got == want and len(got) == 4


def test_load_features_reads_the_dict_and_names_a_missing_h5py(features, monkeypatch):
    import builtins

    root, feats = features
    names = sorted(feats)[:3]
    got = selectors._load_features(names, feature_dict=feats)
    assert got.dtype == np.float32 and got.shape == (3, 12)
    np.testing.assert_array_equal(got, np.stack([feats[n] for n in names]))
    np.testing.assert_array_equal(selectors._load_features(names, feature_path=root), got)
    assert selectors._load_features(names) is None

    real_import = builtins.__import__

    def no_h5py(name, *args, **kwargs):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="feature_dict"):
        selectors._load_features(names, feature_path=root)
    # the dict needs no h5py
    assert selectors._load_features(names, feature_dict=feats).shape == (3, 12)


def test_selector_table_has_every_jax_key():
    assert set(SELECTORS) == set(JAX_SELECTORS)
    assert SELECTORS["kmean-l2"]().metric == "l2" and SELECTORS["coreset-cosine"]().metric == "cosine"
