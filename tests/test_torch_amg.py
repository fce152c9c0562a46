"""The port's automatic mask generation against ``mia_tpu``'s, from one set
of weights (the narrow ``Sam`` of the JAX package's own AMG test, seeded
init with the zero-initialised tables redrawn, carried over by
``sam_state_dict_from_flax``), and its host helpers against theirs on seeded
inputs.

Tolerances: the same number of records in the same order; ``predicted_iou``
within 1e-4; masks equal but for at most 0.1% of pixels (a logit at the
threshold may fall either side in float32); the helpers exactly.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.models.sam import Sam as JaxSam
from mia_tpu.models.sam import SamAutomaticMaskGenerator as JaxAMG
from mia_tpu.models.sam import SamPredictor as JaxPredictor
from mia_tpu.models.sam import amg as jax_amg

import torch

from mia_tpu_torch.models.sam import Sam, SamAutomaticMaskGenerator, SamPredictor, amg
from mia_tpu_torch.models.sam_flax_bridge import sam_state_dict_from_flax

SAM_KW = dict(img_size=64, num_classes=3, encoder_embed_dim=32, encoder_depth=2,
              encoder_num_heads=2, encoder_global_attn_indexes=(1,))
# thresholds that keep every (point, mask) pair of an untrained model; NMS
# threshold above 1 so nothing is suppressed and only the order is decided;
# 3 points a chunk over a 2x2 grid: a short final chunk
KEEP_ALL = dict(points_per_side=2, points_per_batch=3, pred_iou_thresh=-1e9,
                stability_score_thresh=-1.0, box_nms_thresh=1.01, min_mask_region_area=0)


def _randomize(params, rng, names=("rel_pos_h", "rel_pos_w", "pos_embed")):
    return {
        k: _randomize(v, rng, names) if isinstance(v, dict)
        else (rng.standard_normal(v.shape).astype(np.float32) * 0.1 if k in names else v)
        for k, v in params.items()
    }


@pytest.fixture(scope="module")
def models():
    jm = JaxSam(**SAM_KW)
    variables = jax.jit(lambda key, x: jm.init(key, x, True, 64))(
        jax.random.PRNGKey(0), jnp.ones((1, 64, 64, 3)))
    variables = {"params": _randomize(jax.device_get(variables["params"]),
                                      np.random.default_rng(0))}
    tm = Sam(**SAM_KW)
    # the mask-input branch of the prompt encoder is not initialised by this
    # call of the JAX model and is not used by point prompts
    missing, unexpected = tm.load_state_dict(sam_state_dict_from_flax(variables), strict=False)
    assert not unexpected and all("mask_downscaling" in k for k in missing)
    image = (np.random.default_rng(1).random((48, 56, 3)) * 255).astype(np.uint8)
    return jm, variables, tm, image


@pytest.mark.parametrize("exact_prompts", [False, True])
def test_amg_matches_jax(models, exact_prompts):
    jm, variables, tm, image = models
    want = JaxAMG(JaxPredictor(jm, variables, max_points=4, exact_prompts=exact_prompts),
                  **KEEP_ALL).generate(image)
    got = SamAutomaticMaskGenerator(
        SamPredictor(tm, max_points=4, exact_prompts=exact_prompts), **KEEP_ALL).generate(image)
    assert len(got) == len(want) == 4 * 3
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["segmentation", "rle", "area", "bbox", "predicted_iou"]
        assert abs(g["predicted_iou"] - w["predicted_iou"]) <= 1e-4
        assert g["segmentation"].shape == w["segmentation"].shape == (48, 56)
        differ = int((g["segmentation"] != w["segmentation"]).sum())
        assert differ <= 1e-3 * g["segmentation"].size, differ
        np.testing.assert_array_equal(amg.rle_to_mask(g["rle"]), g["segmentation"])
        assert g["area"] == int(g["segmentation"].sum()) == amg.area_from_rle(g["rle"])
        if differ == 0:
            assert g["bbox"] == w["bbox"] and g["rle"] == w["rle"]


@pytest.mark.parametrize("exact_prompts", [False, True])
def test_amg_batched_matches_its_own_per_point_loop(models, exact_prompts):
    _, _, tm, image = models
    predictor = SamPredictor(tm, max_points=4, exact_prompts=exact_prompts)
    generator = SamAutomaticMaskGenerator(predictor, **KEEP_ALL)
    records = generator.generate(image)
    h, w = image.shape[:2]
    exp_masks, exp_iou = [], []
    for point in generator.point_grids * np.array([w, h]):
        masks, iou, _ = predictor.predict(point_coords=point[None], point_labels=np.array([1]))
        exp_masks.append(masks)
        exp_iou.append(iou)
    exp_masks, exp_iou = np.concatenate(exp_masks), np.concatenate(exp_iou)
    order = np.argsort(-exp_iou, kind="stable")  # NMS emits survivors in score order
    np.testing.assert_array_equal(np.stack([r["segmentation"] for r in records]), exp_masks[order])
    np.testing.assert_allclose([r["predicted_iou"] for r in records], exp_iou[order],
                               rtol=1e-5, atol=1e-6)


def test_amg_default_thresholds_and_filters(models):
    _, _, tm, image = models
    predictor = SamPredictor(tm, max_points=4)
    # an untrained model keeps nothing at the default thresholds: phase 1 only
    assert SamAutomaticMaskGenerator(predictor, points_per_side=2).generate(image) == []
    # NMS and small-region removal on the way to the records
    kept = SamAutomaticMaskGenerator(predictor, **{**KEEP_ALL, "box_nms_thresh": 0.5,
                                                  "min_mask_region_area": 4}).generate(image)
    assert 0 < len(kept) <= 12
    for r in kept:
        np.testing.assert_array_equal(amg.rle_to_mask(r["rle"]), r["segmentation"])
        assert r["area"] == int(r["segmentation"].sum())
    # one chunk's scores on the device interface
    predictor.set_image(image)
    generator = SamAutomaticMaskGenerator(predictor, **KEEP_ALL)
    masks, iou, stability = generator.score_chunk(generator.point_grids[:3] * np.array([56, 48]))
    assert masks.shape == (3, 3, 48, 56) and masks.dtype == torch.bool
    assert iou.shape == stability.shape == (3, 3)
    assert ((stability >= 0) & (stability <= 1)).all()


# --- host helpers, exactly ----------------------------------------------------


def test_rle_boxes_and_stability_match_jax(rng):
    for shape in ((9, 13), (16, 16), (1, 7)):
        for density in (0.0, 0.4, 1.0):
            mask = rng.random(shape) < density
            assert amg.mask_to_rle(mask) == jax_amg.mask_to_rle(mask)
            np.testing.assert_array_equal(amg.rle_to_mask(amg.mask_to_rle(mask)), mask)
            assert amg.area_from_rle(amg.mask_to_rle(mask)) == int(mask.sum())
    masks = rng.random((2, 5, 12, 10)) < 0.15
    masks[0, 0] = False
    np.testing.assert_array_equal(amg.batched_mask_to_box(masks),
                                  jax_amg.batched_mask_to_box(masks))
    boxes = amg.batched_mask_to_box(masks)
    np.testing.assert_array_equal(amg.box_xyxy_to_xywh(boxes), jax_amg.box_xyxy_to_xywh(boxes))
    logits = (rng.standard_normal((4, 3, 12, 10)) * 2).astype(np.float32)
    want = np.asarray(jax_amg.calculate_stability_score(jnp.asarray(logits), 0.0, 1.0))
    got = amg.calculate_stability_score(torch.from_numpy(logits), 0.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_point_grids_nms_and_small_regions_match_jax(rng):
    for n in (1, 4, 32):
        np.testing.assert_array_equal(amg.build_point_grid(n), jax_amg.build_point_grid(n))
    for a, b in zip(amg.build_all_layer_point_grids(8, 2, 2),
                    jax_amg.build_all_layer_point_grids(8, 2, 2)):
        np.testing.assert_array_equal(a, b)
    xy = rng.random((40, 2)) * 50
    boxes = np.concatenate([xy, xy + rng.random((40, 2)) * 30 + 1], 1)
    scores = rng.random(40).astype(np.float32)
    for thresh in (0.3, 0.7, 1.01):
        np.testing.assert_array_equal(amg._box_nms(boxes, scores, thresh),
                                      jax_amg._box_nms(boxes, scores, thresh))
    mask = rng.random((24, 24)) < 0.5
    for mode in ("holes", "islands"):
        got, changed = amg.remove_small_regions(mask, 5, mode)
        want, want_changed = jax_amg.remove_small_regions(mask, 5, mode)
        assert changed == want_changed
        np.testing.assert_array_equal(got, want)
    chunks = list(amg.batch_iterator(3, np.arange(7), np.arange(7) * 2))
    assert [len(c[0]) for c in chunks] == [3, 3, 1] and (chunks[2][1] == [12]).all()
    data = amg.MaskData(a=np.arange(4), b=list("wxyz"))
    data.filter(np.array([True, False, True, False]))
    data.cat(amg.MaskData(a=np.array([9]), b=["q"]))
    assert data["a"].tolist() == [0, 2, 9] and data["b"] == ["w", "y", "q"]
