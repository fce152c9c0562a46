"""The acdc/thyroid augmentation recipe in the PyTorch port, held against
the JAX package on the CPU.

- ``ops.warp.affine_warp`` (the direct gather) against
  ``mia_tpu.ops.warp.affine_warp``: nearest pixel for pixel on float images
  and int labels under ±20° rotations, scales, shears and translations;
  bilinear within 1e-6 (the JAX function op by op: under ``jit`` XLA
  evaluates the tap weights in another order, ~6e-6 away); ``rotate_warp``.
- Each new transform's ``apply`` gets the parameters that the JAX
  transform draws from its key (replayed from the same key splits) and
  gives the JAX transform's arrays: ``RandomRotation90``,
  ``MirrorTransform``, ``RandomRotation``, ``RandomAffine``,
  ``RandomChoiceTransform``, ``Identity``, ``JointResize`` (its bilinear
  image within 1e-6: two matmuls in another order), ``RandomCrop2D``.
- The whole recipe: JAX's ``batch_apply`` draws replayed per sample and
  handed to the port's ``apply``: equal images and labels; the
  ``get_params_dict()`` the trainer logs equals JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mia_tpu.ops import warp as jwarp
from mia_tpu.transforms import batch_apply
from mia_tpu.transforms import common as jcommon
from mia_tpu.transforms import joint as jjoint
from mia_tpu.transforms.recipes import get_train_transform as jax_recipe
from mia_tpu_torch.ops import warp as twarp
from mia_tpu_torch.transforms import (ComposeTransform, Identity, JointResize, MirrorTransform,
                                      RandomAffine, RandomChoiceTransform, RandomCrop2D,
                                      RandomRotation, RandomRotation90, RandomTransform,
                                      get_train_transform)

B, H, W = 8, 40, 40


def _batch(seed=0, h=H, w=W, c=1):
    rng = np.random.default_rng(seed)
    img = rng.random((B, h, w, c)).astype(np.float32)
    lbl = rng.integers(0, 4, (B, h, w)).astype(np.int32)
    return img, lbl


def _keys(seed=0):
    return jax.random.split(jax.random.key(seed), B)


def _jax_per_sample(transform, keys, img, lbl):
    out = [transform.apply(k, jnp.asarray(i), jnp.asarray(l)) for k, i, l in zip(keys, img, lbl)]
    return np.stack([np.asarray(o[0]) for o in out]), np.stack([np.asarray(o[1]) for o in out])


def _port(transform, params, img, lbl):
    out_img, out_lbl = transform.apply(params, torch.from_numpy(img), torch.from_numpy(lbl).long())
    return out_img.numpy(), out_lbl.numpy()


def _assert_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1].astype(got[1].dtype))


def _matrices(seed, h=H, w=W):
    """±20° rotations with scales, shears and translations, through JAX."""
    rng = np.random.default_rng(seed)
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    out = []
    for i in range(B):
        angle = rng.uniform(-20, 20) if i else 90.0
        scale = rng.uniform(0.8, 1.2) if i % 2 else 1.0
        shear = rng.uniform(-8, 8, 2) if i % 3 == 1 else (0.0, 0.0)
        tr = np.round(rng.uniform(-4, 4, 2)) if i % 4 == 3 else (0.0, 0.0)
        out.append(np.asarray(jwarp.affine_inverse_matrix(
            jnp.float32(angle), jnp.asarray(tr, jnp.float32), jnp.float32(scale),
            jnp.asarray(shear, jnp.float32), center)))
    return np.stack(out)


@pytest.mark.parametrize("shape", [(40, 40), (36, 52)])
def test_affine_warp_matches_jax(shape):
    h, w = shape
    img, lbl = _batch(1, h, w, c=2)
    mats = _matrices(2, h, w)
    got = twarp.affine_warp(torch.from_numpy(img), torch.from_numpy(mats), "nearest").numpy()
    got_lbl = twarp.affine_warp(torch.from_numpy(lbl[..., None]), torch.from_numpy(mats),
                                "nearest").numpy()
    got_bil = twarp.affine_warp(torch.from_numpy(img), torch.from_numpy(mats), "bilinear").numpy()
    assert got_lbl.dtype == np.int32
    for i in range(B):
        m = jnp.asarray(mats[i])
        np.testing.assert_array_equal(got[i], jwarp.affine_warp(jnp.asarray(img[i]), m, "nearest"))
        np.testing.assert_array_equal(got_lbl[i], jwarp.affine_warp(
            jnp.asarray(lbl[i][..., None]), m, "nearest"))
        want = np.asarray(jwarp.affine_warp(jnp.asarray(img[i]), m, "bilinear"))
        assert np.abs(got_bil[i] - want).max() <= 1e-6
    # the warp moved pixels and filled what came from outside with zeros
    assert (got != img).any() and (got == 0).any() and not (img == 0).any()


def test_rotate_warp_matches_jax():
    img, lbl = _batch(3)
    angle = np.random.default_rng(4).uniform(-20, 20, B).astype(np.float32)
    angle[0] = 90.0
    got = twarp.rotate_warp(torch.from_numpy(img), torch.from_numpy(angle), "nearest").numpy()
    for i in range(B):
        np.testing.assert_array_equal(
            got[i], jwarp.rotate_warp(jnp.asarray(img[i]), jnp.float32(angle[i]), "nearest"))
    np.testing.assert_array_equal(got[0], np.rot90(img[0], -1, (0, 1)))  # an exact quarter turn


def test_rotation90_mirror_and_choice_match_jax():
    img, lbl = _batch(5)
    keys = _keys(5)
    rot = jjoint.RandomRotation90()
    k = np.asarray([jax.random.randint(key, (), 0, 4) for key in keys])
    assert len(set(k.tolist())) > 1
    _assert_equal(_port(RandomRotation90(), {"k": torch.from_numpy(k)}, img, lbl),
                  _jax_per_sample(rot, keys, img, lbl))

    for axes in (-2, -1, (-2, -1)):
        _assert_equal(_port(MirrorTransform(axes), {}, img, lbl),
                      _jax_per_sample(jjoint.MirrorTransform(axes), keys, img, lbl))
    _assert_equal(_port(Identity(), {}, img, lbl),
                  _jax_per_sample(jcommon.Identity(), keys, img, lbl))

    weight = [1.0, 3.0]
    choice = jcommon.RandomChoiceTransform(
        [jjoint.MirrorTransform(-2), jjoint.MirrorTransform(-1)], weight)
    pick = np.asarray([jax.random.categorical(jax.random.split(key)[0],
                                              jnp.log(jnp.asarray(weight, jnp.float32)))
                       for key in keys])
    assert set(pick.tolist()) == {0, 1}
    port = RandomChoiceTransform([MirrorTransform(-2), MirrorTransform(-1)], weight)
    _assert_equal(_port(port, {"pick": torch.from_numpy(pick), "inner": [{}, {}]}, img, lbl),
                  _jax_per_sample(choice, keys, img, lbl))
    with pytest.raises(ValueError, match="square"):
        RandomRotation90().draw(torch.Generator(), (2, 32, 48, 1), "cpu")


def test_rotation_and_affine_match_jax():
    img, lbl = _batch(6)
    keys = _keys(6)
    rot = jjoint.RandomRotation(20)
    angle = np.asarray([jax.random.uniform(key, (), jnp.float32, -20.0, 20.0) for key in keys])
    _assert_equal(_port(RandomRotation(20), {"angle": torch.from_numpy(angle)}, img, lbl),
                  _jax_per_sample(rot, keys, img, lbl))

    center = ((W - 1) * 0.5, (H - 1) * 0.5)
    for kw in (dict(degrees=(-20, 20)),
               dict(degrees=10, translate=(0.1, 0.1), scale=(0.8, 1.2), shear=(-5, 5, -5, 5))):
        affine = jjoint.RandomAffine(**kw)
        mats = np.stack([np.asarray(affine._sample_matrix(key, H, W, center)) for key in keys])
        _assert_equal(_port(RandomAffine(**kw), {"matrix": torch.from_numpy(mats)}, img, lbl),
                      _jax_per_sample(affine, keys, img, lbl))


def test_resize_and_crop_match_jax():
    img, lbl = _batch(7, 36, 52, c=3)
    keys = _keys(7)
    # the bilinear image is two matmuls: another float32 summation order
    # than XLA's (1e-6); the nearest label is a pick, exact
    got = _port(JointResize((24, 32)), {}, img, lbl)
    want = _jax_per_sample(jjoint.JointResize((24, 32)), keys, img, lbl)
    assert got[0].shape == want[0].shape == (B, 24, 32, 3)
    assert np.abs(got[0] - want[0]).max() <= 1e-6
    np.testing.assert_array_equal(got[1], want[1])
    ij = [jax.random.split(key) for key in keys]
    i = np.asarray([jax.random.randint(a, (), 0, 36 - 20 + 1) for a, _ in ij])
    j = np.asarray([jax.random.randint(b, (), 0, 52 - 24 + 1) for _, b in ij])
    _assert_equal(_port(RandomCrop2D((20, 24)), {"i": torch.from_numpy(i), "j": torch.from_numpy(j)},
                        img, lbl),
                  _jax_per_sample(jjoint.RandomCrop2D((20, 24)), keys, img, lbl))
    params = RandomCrop2D((20, 24)).draw(torch.Generator().manual_seed(0), img.shape, "cpu")
    assert (params["i"] <= 16).all() and (params["j"] <= 28).all()


def _replay_recipe_draws(key, h, w):
    """The draws of the JAX acdc recipe for one sample, from its key's splits:
    Compose → (gate, Compose → (rot90 k, choice pick)), (gate, affine matrix)."""
    rng, t0 = jax.random.split(key)
    rng, t1 = jax.random.split(rng)
    gate0, inner0 = jax.random.split(t0)
    rest, s_rot = jax.random.split(inner0)
    _, s_choice = jax.random.split(rest)
    pick_rng, _ = jax.random.split(s_choice)
    gate1, inner1 = jax.random.split(t1)
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    return {
        "fire0": jax.random.uniform(gate0) < 0.5,
        "k": jax.random.randint(s_rot, (), 0, 4),
        "pick": jax.random.categorical(pick_rng, jnp.log(jnp.ones(2, jnp.float32))),
        "fire1": jax.random.uniform(gate1) < 0.5,
        "matrix": jjoint.RandomAffine(degrees=(-20, 20))._sample_matrix(inner1, h, w, center),
    }


def test_acdc_recipe_matches_jax_with_its_draws():
    rng = np.random.default_rng(8)
    n = 16
    img = rng.random((n, H, W, 1)).astype(np.float32)
    lbl = rng.integers(0, 4, (n, H, W)).astype(np.int32)
    key = jax.random.key(9)
    want_img, want_lbl = jax.jit(lambda k, i, l: batch_apply(jax_recipe("acdc"), k, i, l))(
        key, jnp.asarray(img), jnp.asarray(lbl))
    d = jax.vmap(lambda k: _replay_recipe_draws(k, H, W))(jax.random.split(key, n))
    d = {k: torch.from_numpy(np.array(v)) for k, v in d.items()}
    # every branch of the recipe is taken somewhere in the batch
    assert d["fire0"].any() and (~d["fire0"]).any() and d["fire1"].any() and (~d["fire1"]).any()
    assert set(d["k"][d["fire0"]].tolist()) >= {0, 1} and set(d["pick"].tolist()) == {0, 1}
    params = {"stages": [
        {"fire": d["fire0"], "inner": {"stages": [{"k": d["k"]},
                                                  {"pick": d["pick"], "inner": [{}, {}]}]}},
        {"fire": d["fire1"], "inner": {"matrix": d["matrix"]}},
    ]}
    recipe = get_train_transform("acdc")
    got_img, got_lbl = recipe.apply(params, torch.from_numpy(img), torch.from_numpy(lbl).long())
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(want_lbl))
    assert (got_img.numpy() != img).any()


@pytest.mark.parametrize("dataset", ["acdc", "tn3k", "tg3k", "fugc", "busi"])
def test_recipe_params_dict_is_jax(dataset):
    assert get_train_transform(dataset).get_params_dict() == jax_recipe(dataset).get_params_dict()
    assert get_train_transform(dataset, False).get_params_dict() == jax_recipe(
        dataset, False).get_params_dict()


def test_acdc_recipe_draws_and_runs_on_the_cpu():
    img, lbl = _batch(10)
    recipe = get_train_transform("tn3k")
    assert isinstance(recipe.transforms[0], RandomTransform)
    assert isinstance(recipe, ComposeTransform) and len(recipe.transforms) == 2
    out, out_lbl = recipe(torch.Generator().manual_seed(0), torch.from_numpy(img),
                          torch.from_numpy(lbl).long())
    assert out.shape == img.shape and out_lbl.shape == lbl.shape and out_lbl.dtype == torch.int64
    assert set(np.unique(out_lbl.numpy())) <= {0, 1, 2, 3}
    assert twarp.affine_warp_shift2pass_fused.launches == 0
