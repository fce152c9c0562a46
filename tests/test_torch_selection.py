"""The port's selection layer against the JAX package.

- ``pairwise_distances`` for every metric name (rtol 1e-5, atol 1e-6);
- ``kcenter_greedy`` with ``min`` and ``mean`` on the same matrix: the same
  picks;
- the k-means++ core fed the draws that JAX's key sequence makes: the same
  indices, with and without ``sample_weight``;
- ``confidence_score`` and ``margin_score`` (1e-6);
- ``utils/flax_msgpack.py`` against ``flax.serialization``: every leaf bit
  for bit, chunked arrays included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import serialization

from mia_tpu.activelearning import confidence_score as jax_confidence
from mia_tpu.activelearning import kcenter_greedy as jax_kcenter
from mia_tpu.activelearning import kmeans_plusplus as jax_kmeans_pp
from mia_tpu.activelearning import margin_score as jax_margin
from mia_tpu.ops import pairwise_distances as jax_pairwise
from mia_tpu_torch.activelearning import confidence_score, kcenter_greedy, kmeans_plusplus
from mia_tpu_torch.activelearning import margin_score
from mia_tpu_torch.activelearning.selection import kmeans_plusplus_from_draws, n_local_trials_for
from mia_tpu_torch.ops import pairwise_distances
from mia_tpu_torch.utils.flax_msgpack import read_flax_msgpack


def jax_kmeans_draws(seed, n, n_clusters, sample_weight=None):
    """The first center and the uniforms that ``mia_tpu``'s ``kmeans_plusplus``
    draws from ``PRNGKey(seed)``, in its order."""
    w = jnp.ones((n,), jnp.float32) if sample_weight is None else jnp.asarray(
        sample_weight, jnp.float32)
    w = w / jnp.sum(w)
    rng, first_rng = jax.random.split(jax.random.PRNGKey(seed))
    first = int(jax.random.choice(first_rng, n, p=w))
    uniforms = []
    for _ in range(1, n_clusters):
        rng, r = jax.random.split(rng)
        uniforms.append(np.asarray(jax.random.uniform(r, (n_local_trials_for(n_clusters),))))
    trials = n_local_trials_for(n_clusters)
    return first, np.asarray(uniforms, np.float32).reshape(n_clusters - 1, trials)


def _points(seed, n, d=16):
    rng = np.random.default_rng(seed)
    # clusters of different spread: distances far from ties and from zero
    centers = rng.normal(0, 3, (4, d))
    return (centers[rng.integers(0, 4, n)] + rng.normal(0, 1, (n, d))).astype(np.float32)


@pytest.mark.parametrize("metric", ["l2", "euclidean", "cosine", "l1", "manhattan", "cityblock"])
def test_pairwise_distances_match_jax(metric):
    x, y = _points(0, 12), _points(1, 9)
    want = np.asarray(jax_pairwise(jnp.asarray(x), jnp.asarray(y), metric=metric))
    got = pairwise_distances(torch.from_numpy(x), torch.from_numpy(y), metric).numpy()
    assert got.dtype == np.float32 and got.shape == (12, 9)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # y = None: the distances of x to itself
    want = np.asarray(jax_pairwise(jnp.asarray(x), metric=metric))
    got = pairwise_distances(torch.from_numpy(x), metric=metric).numpy()
    off = ~np.eye(12, dtype=bool)
    np.testing.assert_allclose(got[off], want[off], rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="unknown metric"):
        pairwise_distances(torch.from_numpy(x), metric="hamming")


@pytest.mark.parametrize("criteria", ["min", "mean"])
@pytest.mark.parametrize("n_init", [0, 3])
def test_kcenter_greedy_picks_what_jax_picks(criteria, n_init):
    x = _points(2, 20)
    dist = np.array(jax_pairwise(jnp.asarray(x)))
    init = np.arange(20) < n_init
    want = np.asarray(jax_kcenter(jnp.asarray(dist), jnp.asarray(init), 6, criteria))
    got = kcenter_greedy(torch.from_numpy(dist), torch.from_numpy(init), 6, criteria).numpy()
    assert got.tolist() == want.tolist()
    assert len(set(got.tolist())) == 6 and not init[got].any()


def test_kcenter_greedy_takes_the_first_of_equal_scores():
    dist = np.ones((5, 5), np.float32) - np.eye(5, dtype=np.float32)
    init = np.array([True, False, False, False, False])
    for criteria in ("min", "mean"):
        want = np.asarray(jax_kcenter(jnp.asarray(dist), jnp.asarray(init), 3, criteria))
        got = kcenter_greedy(torch.from_numpy(dist), torch.from_numpy(init), 3, criteria)
        assert got.tolist() == want.tolist() == [1, 2, 3]
    with pytest.raises(RuntimeError, match="undefined"):
        kcenter_greedy(torch.from_numpy(dist), torch.from_numpy(init), 1, "max")


@pytest.mark.parametrize("seed", [0, 1, 5])
@pytest.mark.parametrize("weighted", [False, True])
def test_kmeans_plusplus_core_with_jax_draws_picks_what_jax_picks(seed, weighted):
    n, k = 30, 7
    x = _points(10 + seed, n)
    weight = None
    if weighted:
        weight = np.random.default_rng(seed).uniform(0.05, 1.0, n).astype(np.float32)
    want = np.asarray(jax_kmeans_pp(jax.random.PRNGKey(seed), jnp.asarray(x), k,
                                    None if weight is None else jnp.asarray(weight)))
    first, uniforms = jax_kmeans_draws(seed, n, k, weight)
    assert uniforms.shape == (k - 1, n_local_trials_for(k)) == (6, 3)
    got = kmeans_plusplus_from_draws(torch.from_numpy(x), first, torch.from_numpy(uniforms),
                                     None if weight is None else torch.from_numpy(weight))
    assert got.tolist() == want.tolist()


@pytest.mark.parametrize("uniforms, want", [([0.25, 0.75], 1), ([0.75, 0.25], 2)])
def test_kmeans_plusplus_takes_the_first_drawn_of_tied_candidates(uniforms, want):
    # from center 0, candidates 1 and 2 each improve only the pair of them, so
    # either leaves the potential (4 + 9) / 4: an exact tie (every value here is
    # exact in float32), which goes to the candidate drawn first
    x = torch.tensor([[0.0, 0.0], [8.0, 0.0], [8.0, 2.0], [0.0, 3.0]])
    got = kmeans_plusplus_from_draws(x, 0, torch.tensor([uniforms]))
    assert n_local_trials_for(2) == 2 and got.tolist() == [0, want]


def test_kmeans_plusplus_draws_from_its_generator():
    x = torch.from_numpy(_points(3, 25))
    a = kmeans_plusplus(x, 6, torch.Generator().manual_seed(4))
    b = kmeans_plusplus(x, 6, torch.Generator().manual_seed(4))
    c = kmeans_plusplus(x, 6, torch.Generator().manual_seed(5))
    assert a.tolist() == b.tolist() and a.tolist() != c.tolist()
    assert len(set(a.tolist())) == 6 and a.dtype == torch.long
    # all the weight on one point: it is the first center
    w = torch.zeros(25)
    w[17] = 1.0
    assert kmeans_plusplus(x, 3, torch.Generator().manual_seed(0), w)[0].item() == 17


@pytest.mark.parametrize("name", ["confidence", "margin"])
def test_confidence_and_margin_scores_match_jax(name):
    rng = np.random.default_rng(7)
    logits = rng.normal(0, 2, (3, 9, 11, 4)).astype(np.float32)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    jax_fn, fn = {"confidence": (jax_confidence, confidence_score),
                  "margin": (jax_margin, margin_score)}[name]
    want = np.asarray(jax_fn(jnp.asarray(probs)))
    got = fn(torch.from_numpy(probs)).numpy()
    assert got.shape == (3,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _assert_same_tree(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), path
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


def test_flax_msgpack_reader_is_bit_exact(monkeypatch):
    from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig

    model = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3, channels_list=(8, 16)))
    variables = jax.device_get(jax.eval_shape(
        lambda: model.init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)), train=False)))
    rng = np.random.default_rng(0)
    variables = jax.tree.map(lambda s: rng.standard_normal(s.shape).astype(s.dtype), variables)
    tree = {
        **variables,
        "ints": {"i8": np.arange(-5, 5, dtype=np.int8), "u16": np.arange(70000 % 65536,
                 dtype=np.uint16)[:300], "i64": np.array([-(2**40), 2**40], np.int64)},
        "f64": rng.standard_normal((3, 2)), "empty": np.zeros((0, 4), np.float32),
        "scalar": np.float32(1.25), "step": 1234567, "neg": -3, "small": 7, "pi": 3.14159,
        "name": "unet", "long_name": "x" * 300, "none": None, "flag": False, "c": 1 - 2j,
        "bool_arr": np.array([True, False]), "list": (1, 2.5),
    }
    data = serialization.to_bytes(tree)
    _assert_same_tree(read_flax_msgpack(data), serialization.msgpack_restore(data))
    # arrays over flax's chunk size arrive chunked: joined again
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    data = serialization.to_bytes({"big": rng.standard_normal((7, 9)).astype(np.float32),
                                   "small": np.ones(3, np.float32)})
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(read_flax_msgpack(data), serialization.msgpack_restore(data))
    # bfloat16 is widened to float32 exactly
    data = serialization.to_bytes({"b": jnp.asarray([1.5, -2.0, 3.0e-3], jnp.bfloat16)})
    got = read_flax_msgpack(data)["b"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jnp.asarray([1.5, -2.0, 3.0e-3],
                                                              jnp.bfloat16), np.float32))
    with pytest.raises(ValueError, match="trailing"):
        read_flax_msgpack(data + b"\x00")
