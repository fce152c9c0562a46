"""The port's train step and augmentation math against the JAX package.

Same weights, same uint8 batches, augmentation off and dropout 0: three
steps of ``mia_tpu_torch.training.make_train_step`` and of
``mia_tpu.training.steps.make_train_step`` (adam, global-norm clip 10,
weight decay 5e-4, poly-warmup LR) must give the same losses and
parameters; one step's gradient norm exceeds 10 so the clip runs.

The augmentation transforms are held against the JAX functions with their
random parameters drawn once in numpy and handed to both (the two
frameworks' random streams never agree).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.losses import DiceAndCELoss as JaxLoss
from mia_tpu.models import UNet as JaxUNet, UNetConfig as JaxUNetConfig
from mia_tpu.ops import filters as jfilters
from mia_tpu.ops import warp as jwarp
from mia_tpu.schedule import poly_warmup_schedule as jax_schedule
from mia_tpu.training.state import create_train_state, make_optimizer as jax_optimizer
from mia_tpu.training.steps import make_train_step as jax_train_step
from mia_tpu.transforms.image import _contrast_blend as jax_contrast
from mia_tpu.transforms.normalization import zscore_normalize as jax_zscore
from mia_tpu_torch.losses import DiceAndCELoss
from mia_tpu_torch.models import UNet, UNetConfig, unet_state_dict_from_flax
from mia_tpu_torch.schedule import poly_warmup_schedule
from mia_tpu_torch.training import TrainState, make_optimizer, make_train_step
from mia_tpu_torch.transforms import (
    FusedRandomAffines,
    RandomAffine,
    RandomBrightness,
    RandomContrast,
    RandomGamma,
    RandomGaussianBlur,
    RandomGaussianNoise,
    RandomTransform,
    SimulateLowRes,
    get_train_transform,
    zscore_normalize,
)

CHANNELS = (8, 16, 32)
# a large CE weight puts the first steps' gradient norm above the clip (10)
CE_WEIGHT = 20.0


def _jax_preprocess(rng, images, labels):
    images = jax.vmap(jax_zscore)(images.astype(jnp.float32) / 255.0)
    return images, labels.astype(jnp.int32)


def _torch_preprocess(generator, images, labels):
    return zscore_normalize(images.to(torch.float32) / 255.0), labels.long()


def test_three_train_steps_match_jax():
    rng = np.random.default_rng(0)
    b, h, w = 2, 32, 32
    batches = [
        (rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8),
         rng.integers(0, 3, (b, h, w), dtype=np.uint8))
        for _ in range(3)
    ]
    lr_kw = dict(initial_lr=1e-3, max_steps=10, warmup_steps=2)

    jm = JaxUNet(JaxUNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS,
                               dropout_prob=0.0))
    tx = jax_optimizer("adam", jax_schedule(**lr_kw), grad_clip=10.0, weight_decay=5e-4)
    init = jax.jit(lambda k, x: jm.init(k, x, train=False))
    variables = jax.tree.map(np.array, init(jax.random.key(0), jnp.zeros((1, h, w, 3))))
    # A conv bias that feeds a BatchNorm has a zero true gradient (the batch
    # mean removes it): from a zero init, both frameworks hand Adam pure
    # float noise, which it scales to +-lr steps of random sign. Non-zero
    # biases make the weight-decay term dominate that noise.
    for scope in ("encoder", "decoder"):
        for name, block in variables["params"][scope].items():
            if name.startswith("level"):
                n = block["conv"]["bias"].shape
                bias = rng.choice([-1.0, 1.0], n) * rng.uniform(0.02, 0.05, n)
                block["conv"]["bias"] = bias.astype(np.float32)
    state = create_train_state(jm, None, None, tx, variables=variables)
    jstep = jax_train_step(JaxLoss(ce_weight=CE_WEIGHT), donate=False,
                           preprocess_fn=_jax_preprocess)

    tm = UNet(UNetConfig(in_channels=3, out_classes=3, channels_list=CHANNELS, dropout_prob=0.0))
    tm.load_state_dict(unet_state_dict_from_flax(
        {"params": state.params, "batch_stats": state.batch_stats}))
    opt = make_optimizer("adam", tm.parameters(), poly_warmup_schedule(**lr_kw),
                         grad_clip=10.0, weight_decay=5e-4)
    tstate = TrainState(tm, opt)
    tstep = make_train_step(DiceAndCELoss(ce_weight=CE_WEIGHT), _torch_preprocess)

    norms = []
    for images, labels in batches:
        state, jmetrics = jstep(state, jnp.asarray(images), jnp.asarray(labels), jax.random.key(1))
        tmetrics = tstep(tstate, torch.from_numpy(images), torch.from_numpy(labels))
        # relative: the total is ~25 with CE weight 20
        for key in ("loss", "loss_ce", "loss_dice"):
            np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]),
                                       rtol=1e-5, atol=1e-6, err_msg=key)
        norms.append(float(tmetrics["grad_norm"]))
    assert max(norms) > 10.0, norms

    want = unet_state_dict_from_flax({"params": state.params, "batch_stats": state.batch_stats})
    got = tm.state_dict()
    for key, value in want.items():
        if key.endswith("num_batches_tracked"):
            continue
        if ".all.0.bias" in key:
            # BN-fed conv bias: its update is driven by weight decay against
            # gradient float noise; hold it to 1% of one lr step instead
            tol = dict(rtol=0, atol=1e-5)
        else:
            tol = dict(rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got[key].numpy(), value.numpy(), err_msg=key, **tol)


# ---------------------------------------------------------------------------
# augmentation math with parameters drawn once in numpy
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _images():
    rng = np.random.default_rng(5)
    img = rng.random((4, 24, 40, 3)).astype(np.float32)
    lbl = rng.integers(0, 3, (4, 24, 40)).astype(np.int64)
    return img, lbl


def _apply(transform, params):
    img, lbl = _images()
    out, out_lbl = transform.apply(params, torch.from_numpy(img), torch.from_numpy(lbl))
    np.testing.assert_array_equal(out_lbl.numpy(), lbl)
    return out.numpy()


def _per_sample(fn, *params):
    img, _ = _images()
    return np.stack([np.asarray(fn(jnp.asarray(img[i]), *(p[i] for p in params)))
                     for i in range(img.shape[0])])


def test_blur_matches_jax():
    sigma = np.random.default_rng(0).uniform(0.5, 1.0, 4).astype(np.float32)
    c = np.ceil(4.0 * sigma + 0.5)
    kernel = np.where(c % 2 == 1, c, c - 1).astype(np.int64)
    t = RandomGaussianBlur(sigma=(0.5, 1))
    got = _apply(t, {"sigma": torch.from_numpy(sigma), "kernel": torch.from_numpy(kernel)})
    want = _per_sample(
        lambda im, s, k: jfilters.gaussian_blur(im, s, k, max_kernel_size=t.max_kernel),
        sigma, kernel)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_low_res_matches_jax():
    scales = np.random.default_rng(1).uniform(0.5, 1.0, (4, 2)).astype(np.float32)
    got = _apply(SimulateLowRes(scale=(0.5, 1)), {"scales": torch.from_numpy(scales)})
    want = _per_sample(jfilters.simulate_low_res, scales)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_gamma_brightness_contrast_match_jax():
    rng = np.random.default_rng(2)
    gamma = rng.uniform(0.7, 1.5, 4).astype(np.float32)
    got = _apply(RandomGamma(gamma=(0.7, 1.5)), {"gamma": torch.from_numpy(gamma)})
    np.testing.assert_allclose(got, _per_sample(jnp.power, gamma), rtol=0, atol=1e-5)

    factor = rng.uniform(0.75, 1.25, 4).astype(np.float32)
    want = _per_sample(jax_contrast, factor)
    for t in (RandomBrightness(brightness=0.25), RandomContrast(contrast=0.25)):
        got = _apply(t, {"factor": torch.from_numpy(factor)})
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_noise_matches_jax_with_the_same_array():
    rng = np.random.default_rng(3)
    sigma = rng.uniform(0.0, 0.1, 4).astype(np.float32)
    noise = rng.normal(size=_images()[0].shape).astype(np.float32)
    got = _apply(RandomGaussianNoise(sigma=(0, 0.1)),
                 {"sigma": torch.from_numpy(sigma), "noise": torch.from_numpy(noise)})
    want = _per_sample(lambda im, s, n: jnp.clip(im + s * n, 0.0, 1.0), sigma, noise)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_zscore_matches_jax():
    img, _ = _images()
    got = zscore_normalize(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, _per_sample(jax_zscore), rtol=0, atol=1e-5)


def test_random_transform_gate_selects_per_sample():
    gamma = np.full(4, 2.0, np.float32)
    fire = torch.tensor([True, False, True, False])
    t = RandomTransform(RandomGamma(gamma=(2.0, 2.0)), p=0.5)
    got = _apply(t, {"fire": fire, "inner": {"gamma": torch.from_numpy(gamma)}})
    img, _ = _images()
    np.testing.assert_allclose(got[0], img[0] ** 2, rtol=1e-6)
    np.testing.assert_array_equal(got[1], img[1])


def test_fused_affines_warp_the_stack_like_jax_shift2pass():
    """The fused affine applies the split-rounding warp (K1's plain version
    on CPU) to the stacked image+label; identity maps pass through."""
    img, lbl = _images()
    t = FusedRandomAffines([(RandomAffine(scale=(0.7, 1.4)), 0.2),
                            (RandomAffine(degrees=(-15, 15)), 0.2)])
    center = ((40 - 1) * 0.5, (24 - 1) * 0.5)
    zero = jnp.float32(0.0)
    mats = np.stack([
        np.asarray(jwarp.affine_inverse_matrix(jnp.float32(a), (zero, zero), jnp.float32(s),
                                               (zero, zero), center))
        for a, s in ((9.0, 1.0), (0.0, 0.8), (-12.0, 1.2), (0.0, 1.0))
    ])
    is_identity = torch.tensor([False, False, False, True])
    out, out_lbl = t.apply({"matrix": torch.from_numpy(mats), "is_identity": is_identity},
                           torch.from_numpy(img), torch.from_numpy(lbl))
    for i in range(3):
        stacked = np.concatenate([img[i], lbl[i][..., None].astype(np.float32)], -1)
        want = np.asarray(jwarp.affine_warp_shift2pass(jnp.asarray(stacked), jnp.asarray(mats[i])))
        np.testing.assert_array_equal(out[i].numpy(), want[..., :-1])
        np.testing.assert_array_equal(out_lbl[i].numpy(), np.round(want[..., -1]).astype(np.int64))
    np.testing.assert_array_equal(out[3].numpy(), img[3])
    np.testing.assert_array_equal(out_lbl[3].numpy(), lbl[3])


def test_fugc_recipe_runs_and_keeps_ranges():
    img, lbl = _images()
    recipe = get_train_transform("fugc")
    gen = torch.Generator().manual_seed(0)
    out, out_lbl = recipe(gen, torch.from_numpy(img), torch.from_numpy(lbl))
    assert out.shape == img.shape and out_lbl.shape == lbl.shape
    assert out.min() >= 0.0 and out.max() <= 1.0
    assert set(np.unique(out_lbl.numpy())) <= {0, 1, 2}
    with pytest.raises(NotImplementedError):
        get_train_transform("acdc")


def test_poly_schedule_matches_jax():
    for kw in (dict(initial_lr=1e-3, max_steps=30, warmup_steps=5),
               dict(initial_lr=1e-2, max_steps=40, warmup_steps=0, interval=3)):
        j, t = jax_schedule(**kw), poly_warmup_schedule(**kw)
        for step in range(45):
            np.testing.assert_allclose(t(step), float(j(step)), rtol=1e-12)
