"""The port's SAM serving path against ``mia_tpu``'s, from the same weights.

Weights are the JAX model's (seeded init, rel-pos tables and pos-embed
drawn at random so those paths carry signal), carried over by
``sam_state_dict_from_flax``. Tolerances:

- embeddings: max |port − JAX| ≤ 1e-4 · max |JAX|;
- mask bits equal wherever |JAX logit| > 1e-3;
- iou within 1e-4;
- low-res logits (rounded through float16 on both sides) within one float16
  step of the JAX value, plus 1e-5 for the float32 noise before the
  rounding (it decides the step near zero, where float16 steps are finer).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam import ImageEncoderViT as JaxEncoder
from mia_tpu.models.sam import ResizeLongestSide as JaxResize
from mia_tpu.models.sam import Sam as JaxSam
from mia_tpu.models.sam import SamPredictor as JaxPredictor

import torch

from mia_tpu_torch.models.sam import ImageEncoderViT, Sam, SamPredictor
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

SAM_KW = dict(img_size=64, num_classes=3, encoder_embed_dim=32, encoder_depth=2,
              encoder_num_heads=2, encoder_global_attn_indexes=(1,))


def _randomize(params, rng, names=("rel_pos_h", "rel_pos_w", "pos_embed")):
    """Replace the zero-initialised tables by seeded noise."""
    return {
        k: _randomize(v, rng, names) if isinstance(v, dict)
        else (rng.standard_normal(v.shape).astype(np.float32) * 0.1 if k in names else v)
        for k, v in params.items()
    }


def _assert_embedding_close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jm = JaxSam(**SAM_KW)

    def init_all(mdl, x):  # the mask branch too, so every parameter exists
        mdl.prompt_encoder(masks=jnp.zeros((1, 16, 16, 1)))
        return mdl.forward_train(x, True, 64)

    variables = jax.jit(lambda key, x: jm.init(key, x, method=init_all))(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    variables = {"params": _randomize(jax.device_get(variables["params"]), rng)}
    tm = Sam(**SAM_KW)
    tm.load_state_dict(sam_state_dict_from_flax(variables), strict=True)
    return jm, variables, tm


@pytest.fixture(scope="module")
def predictors(models):
    jm, variables, tm = models
    image = (np.random.default_rng(1).random((48, 64, 3)) * 255).astype(np.uint8)
    jp, tp = JaxPredictor(jm, variables, max_points=4), SamPredictor(tm, max_points=4)
    jp.set_image(image)
    tp.set_image(image)
    return jp, tp


def test_bridge_loads_strict_with_the_flax_parameter_count(models):
    _, variables, tm = models
    sd = sam_state_dict_from_flax(variables)
    missing, unexpected = tm.load_state_dict(sd, strict=True)
    assert not missing and not unexpected
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(t.numel() for t in tm.state_dict().values()) == n_flax
    assert len(sd) == len(tm.state_dict())


def test_image_encoder_matches_jax_on_a_multi_window_grid():
    # 8x8 token grid, window 3: 9 windows with padding, block 1 global
    kw = dict(img_size=128, patch_size=16, embed_dim=64, depth=2, num_heads=2,
              window_size=3, global_attn_indexes=(1,))
    enc = JaxEncoder(use_rel_pos=True, **kw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 128, 128, 3)).astype(np.float32)
    params = jax.jit(enc.init)(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    params = _randomize(jax.device_get(params), rng)
    want = np.asarray(jax.jit(enc.apply)({"params": params}, jnp.asarray(x)))
    sd = sam_state_dict_from_flax({"params": {"image_encoder": params}})
    port = ImageEncoderViT(**kw)
    port.load_state_dict({k.removeprefix("image_encoder."): v for k, v in sd.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 8, 8, 256)
    _assert_embedding_close(got, want)


def test_set_image_embedding_matches_jax(predictors):
    jp, tp = predictors
    assert tp.get_image_embedding().device.type == "cpu"
    _assert_embedding_close(tp.get_image_embedding().numpy(), np.asarray(jp.get_image_embedding()))


def test_set_image_input_quantization_matches_jax():
    """The resize + uint8 truncation of ``set_image``: equal to the JAX host
    path except where the float64 resize lies within 1e-4 of an integer, where
    float32 summation order decides the truncation."""
    from mia_tpu_torch.models.sam.transforms import ResizeLongestSide
    from mia_tpu_torch.ops.resize import _resize_matrix

    image = (np.random.default_rng(3).random((48, 56, 3)) * 255).astype(np.uint8)
    want = JaxResize(64).apply_image(image)
    got = ResizeLongestSide(64).apply_image(image)
    assert got.shape == want.shape == (55, 64, 3) and got.dtype == np.uint8
    mh = _resize_matrix(55, 48, "bilinear", True).astype(np.float64)
    mw = _resize_matrix(64, 56, "bilinear", True).astype(np.float64)
    exact = np.einsum("ow,hwc->hoc", mw, np.einsum("oh,hwc->owc", mh, image.astype(np.float64)))
    near_integer = np.abs(exact - np.round(exact)) < 1e-4
    differ = got != want
    assert not (differ & ~near_integer).any()
    assert (np.abs(got.astype(int) - want.astype(int)) <= 1).all()


PROMPTS = {
    "point_multimask": dict(point_coords=np.array([[30.0, 22.0]]), point_labels=np.array([1])),
    "points_single": dict(point_coords=np.array([[30.0, 22.0], [8.0, 40.0]]),
                          point_labels=np.array([1, 0]), multimask_output=False),
    "box": dict(box=np.array([5.0, 4.0, 50.0, 40.0])),
    "point_box_mask": dict(point_coords=np.array([[30.0, 22.0]]), point_labels=np.array([1]),
                           box=np.array([5.0, 4.0, 50.0, 40.0]),
                           mask_input=np.random.default_rng(4).standard_normal((16, 16))),
}


def _check_outputs(got, want, want_logits):
    masks, iou, low_res = got
    j_masks, j_iou, j_low = want
    assert masks.shape == j_masks.shape and masks.dtype == bool
    confident = np.abs(want_logits) > 1e-3
    np.testing.assert_array_equal(masks[confident], j_masks[confident])
    np.testing.assert_allclose(iou, j_iou, rtol=0, atol=1e-4)
    assert low_res.shape == j_low.shape
    step = np.spacing(np.abs(j_low).astype(np.float16)).astype(np.float32)
    assert (np.abs(low_res - j_low) <= step + 1e-5).all()


@pytest.mark.parametrize("prompt", sorted(PROMPTS))
def test_predict_matches_jax(predictors, prompt):
    jp, tp = predictors
    kwargs = PROMPTS[prompt]
    want_logits = jp.predict(**kwargs, return_logits=True)[0]
    got_logits = tp.predict(**kwargs, return_logits=True)[0]
    assert got_logits.dtype == np.float32
    np.testing.assert_allclose(got_logits, want_logits, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want_logits).max()))
    _check_outputs(tp.predict(**kwargs), jp.predict(**kwargs), want_logits)


def test_predict_batch_matches_jax(predictors):
    jp, tp = predictors
    coords = np.array([[[10.0, 12.0]], [[30.0, 20.0]], [[44.0, 40.0]]])
    labels = np.ones((3, 1), np.int32)
    boxes = np.array([[4.0, 4.0, 30.0, 28.0], [10.0, 8.0, 50.0, 40.0], [0.0, 0.0, 63.0, 47.0]])
    for kwargs in (dict(point_coords=coords, point_labels=labels), dict(boxes=boxes)):
        want_logits = jp.predict_batch(**kwargs, return_logits=True)[0]
        got = tp.predict_batch(**kwargs)
        assert got[0].shape == (3, 3, 48, 64)
        _check_outputs(got, jp.predict_batch(**kwargs), want_logits)
