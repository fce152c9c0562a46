"""The port's loss family against the JAX package's (``mia_tpu/losses``).

Each loss of ``ce.py``, ``dice.py`` and ``compound.py``, on 2D
``(2, 16, 16, C)`` and 3D ``(2, 8, 8, 8, C)`` logits from a numpy seed, with
class weights, an ignore label inside and outside the class range, label
smoothing, loss masks, batch Dice and the sigmoid regions: the value and its
gradient with respect to the logits (``jax.grad`` against autograd) within
1e-6 of the largest |value|. A tuple output is reduced to one scalar with
distinct coefficients before the gradient.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mia_tpu.losses as J
import mia_tpu_torch.losses as T

SHAPES = {"2d": (2, 16, 16), "3d": (2, 8, 8, 8)}
TOL = 1e-6
WEIGHT = np.array([1.0, 2.0, 0.5, 1.5], np.float32)


def _case(shape, c=4, seed=0, ignore=None):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape + (c,)).astype(np.float32)
    labels = rng.integers(0, c, shape).astype(np.int32)
    if ignore is not None:
        labels[0, :3] = ignore
    return logits, labels


def _regions(shape, seed=0, ignore_channel=True):
    """Sigmoid-region targets: 3 one-hot-ish region channels (+ an ignore
    channel last), and 3-channel logits."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal(shape + (3,)).astype(np.float32)
    regions = (rng.random(shape + (3,)) > 0.6).astype(np.float32)
    if ignore_channel:
        ignore = (rng.random(shape + (1,)) > 0.8).astype(np.float32)
        regions = np.concatenate([regions, ignore], -1)
    return logits, regions


def _reduce(out, xp):
    """A tuple output as one scalar, each part weighted differently."""
    if isinstance(out, tuple):
        return sum((i + 1.0) * xp.sum(o) for i, o in enumerate(out))
    return xp.sum(out)


def _mask(shape, seed=1):
    return (np.random.default_rng(seed).random(shape) > 0.25).astype(np.float32)


# name -> (inputs(shape), jax call, torch call); inputs return
# (logits, *other numpy arrays), the calls take (logits, *others)
CASES = {
    "ce": (_case, lambda x, y: J.cross_entropy(x, y), lambda x, y: T.cross_entropy(x, y)),
    "ce-weight-ignore": (
        _case,
        lambda x, y: J.cross_entropy(x, y, weight=jnp.asarray(WEIGHT), ignore_index=2),
        lambda x, y: T.cross_entropy(x, y, weight=torch.from_numpy(WEIGHT), ignore_index=2)),
    "ce-ignore-255": (
        lambda s: _case(s, ignore=255),
        lambda x, y: J.cross_entropy(x, y, ignore_index=255),
        lambda x, y: T.cross_entropy(x, y, ignore_index=255)),
    "ce-smoothing-weight": (
        _case,
        lambda x, y: J.cross_entropy(x, y, weight=jnp.asarray(WEIGHT), label_smoothing=0.1),
        lambda x, y: T.cross_entropy(x, y, weight=torch.from_numpy(WEIGHT), label_smoothing=0.1)),
    "ce-none": (
        _case,
        lambda x, y: J.cross_entropy(x, y, ignore_index=1, reduction="none"),
        lambda x, y: T.cross_entropy(x, y, ignore_index=1, reduction="none")),
    "ce-sum": (
        _case,
        lambda x, y: J.cross_entropy(x, y, label_smoothing=0.2, reduction="sum"),
        lambda x, y: T.cross_entropy(x, y, label_smoothing=0.2, reduction="sum")),
    "robust-ce": (
        lambda s: (lambda x, y: (x, y[..., None].astype(np.float32)))(*_case(s)),
        lambda x, y: J.robust_cross_entropy(x, y, weight=jnp.asarray(WEIGHT)),
        lambda x, y: T.robust_cross_entropy(x, y, weight=torch.from_numpy(WEIGHT))),
    "topk": (_case, lambda x, y: J.topk_loss(x, y, k=10.0),
             lambda x, y: T.topk_loss(x, y, k=10.0)),
    "topk-ignore": (
        lambda s: _case(s, ignore=255),
        lambda x, y: J.topk_loss(x, y, k=25.0, ignore_index=255, label_smoothing=0.1),
        lambda x, y: T.topk_loss(x, y, k=25.0, ignore_index=255, label_smoothing=0.1)),
    "bce": (lambda s: _regions(s, ignore_channel=False),
            lambda x, y: J.bce_with_logits(x, y), lambda x, y: T.bce_with_logits(x, y)),
    "me-dice": (
        _case,
        lambda x, y: J.memory_efficient_soft_dice_loss(x, y),
        lambda x, y: T.memory_efficient_soft_dice_loss(x, y)),
    "me-dice-batch-nobg-mask": (
        lambda s: (*_case(s), _mask(s)),
        lambda x, y, m: J.memory_efficient_soft_dice_loss(x, y, m, batch_dice=True, do_bg=False,
                                                          smooth=1e-5),
        lambda x, y, m: T.memory_efficient_soft_dice_loss(x, y, m, batch_dice=True, do_bg=False,
                                                          smooth=1e-5)),
    "me-dice-sigmoid": (
        lambda s: (*_regions(s, ignore_channel=False), _mask(s)[..., None]),
        lambda x, y, m: J.memory_efficient_soft_dice_loss(x, y, m, apply_nonlin="sigmoid"),
        lambda x, y, m: T.memory_efficient_soft_dice_loss(x, y, m, apply_nonlin="sigmoid")),
    "tp-fp-fn-tn": (
        lambda s: (*_case(s), _mask(s)),
        lambda x, y, m: J.get_tp_fp_fn_tn(jax.nn.softmax(x, -1), y, mask=m, square=True),
        lambda x, y, m: T.get_tp_fp_fn_tn(torch.softmax(x, -1), y, mask=m, square=True)),
    "tp-fp-fn-tn-batch-axes": (
        _case,
        lambda x, y: J.get_tp_fp_fn_tn(jax.nn.sigmoid(x), y, axes=(0,)),
        lambda x, y: T.get_tp_fp_fn_tn(torch.sigmoid(x), y, axes=(0,))),
    "dice+ce": (
        _case,
        lambda x, y: J.DiceAndCELoss(dice_weight=0.7, ce_weight=0.3)(x, y),
        lambda x, y: T.DiceAndCELoss(dice_weight=0.7, ce_weight=0.3)(x, y)),
    "dual-branch": (
        lambda s: (*_case(s), _case(s, seed=5)[0]),
        lambda x, y, x2: J.DualBranchDiceAndCELoss(dice_weight=0.8)(
            {"low_res_logits1": x, "low_res_logits2": x2}, y),
        lambda x, y, x2: T.DualBranchDiceAndCELoss(dice_weight=0.8)(
            {"low_res_logits1": x, "low_res_logits2": x2}, y)),
    "dc+ce": (_case, lambda x, y: J.DCAndCELoss()(x, y), lambda x, y: T.DCAndCELoss()(x, y)),
    "dc+ce-ignore-batch": (
        lambda s: _case(s, ignore=255),
        lambda x, y: J.DCAndCELoss(ignore_label=255, batch_dice=True, do_bg=False)(x, y),
        lambda x, y: T.DCAndCELoss(ignore_label=255, batch_dice=True, do_bg=False)(x, y)),
    "dc+ce-weight": (
        lambda s: _case(s, ignore=3),
        lambda x, y: J.DCAndCELoss(ignore_label=3, weight_ce=0.5, ce_kwargs=(
            ("weight", jnp.asarray(WEIGHT)),))(x, y),
        lambda x, y: T.DCAndCELoss(ignore_label=3, weight_ce=0.5, ce_kwargs=(
            ("weight", torch.from_numpy(WEIGHT)),))(x, y)),
    "dc+bce": (_regions, lambda x, y: J.DCAndBCELoss(use_ignore_label=True)(x, y),
               lambda x, y: T.DCAndBCELoss(use_ignore_label=True)(x, y)),
    "dc+bce-batch": (lambda s: _regions(s, ignore_channel=False),
                     lambda x, y: J.DCAndBCELoss(batch_dice=True)(x, y),
                     lambda x, y: T.DCAndBCELoss(batch_dice=True)(x, y)),
    "dc+topk": (lambda s: _case(s, ignore=255),
                lambda x, y: J.DCAndTopKLoss(ignore_label=255, k=20.0)(x, y),
                lambda x, y: T.DCAndTopKLoss(ignore_label=255, k=20.0)(x, y)),
    "dc-only-topk": (_case, lambda x, y: J.DCAndTopKLoss(weight_ce=0.0)(x, y),
                     lambda x, y: T.DCAndTopKLoss(weight_ce=0.0)(x, y)),
}


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, f"{what}: {got.shape} != {want.shape}"
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, f"{what}: max |diff| {err} > {TOL} x {scale}"


@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("name", CASES)
def test_loss_value_and_gradient_match_jax(name, dims):
    make, jax_fn, torch_fn = CASES[name]
    logits, *others = make(SHAPES[dims])

    want = jax_fn(jnp.asarray(logits), *map(jnp.asarray, others))
    want_grad = jax.grad(lambda x: _reduce(jax_fn(x, *map(jnp.asarray, others)), jnp))(
        jnp.asarray(logits))

    x = torch.from_numpy(logits).requires_grad_(True)
    got = torch_fn(x, *map(torch.from_numpy, others))
    got_grad, = torch.autograd.grad(_reduce(got, torch), x)

    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        _close(g.detach().numpy(), w, f"{name} value")
    _close(got_grad.numpy(), want_grad, f"{name} gradient")


def test_default_cross_entropy_is_torchs():
    """The AL path's call keeps the value ``F.cross_entropy`` gives, bit for bit."""
    logits, labels = _case(SHAPES["2d"])
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    want = torch.nn.functional.cross_entropy(x.movedim(-1, 1), y.long())
    assert torch.equal(T.cross_entropy(x, y), want)
    # the gather-free form (any option) gives the same value to float rounding
    np.testing.assert_allclose(float(T.cross_entropy(x, y, reduction="none").mean()),
                               float(want), rtol=1e-6)
