"""K1 (affine warp) in the PyTorch port held against the JAX package.

The CUDA kernel itself runs only on a card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``); here the port's index math and plain warp, which
the kernel reproduces bit for bit, meet ``mia_tpu.ops.warp``: its
``affine_warp_shift2pass`` and the Pallas kernel ``affine_warp_pallas`` in
interpret mode. Inputs come from numpy and pass to both as arrays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mia_tpu.ops import warp as jwarp
from mia_tpu_torch.ops import warp as twarp


def _recipe_params(rng, n):
    """FUGC-recipe affine parameters: scale 0.7-1.4, rotation ±15°, both."""
    kind = np.arange(n) % 3
    angle = np.where(kind == 0, 0.0, rng.uniform(-15, 15, n)).astype(np.float32)
    scale = np.where(kind == 1, 1.0, rng.uniform(0.7, 1.4, n)).astype(np.float32)
    return angle, scale


def _jax_matrices(angle, scale, h, w):
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    zero = jnp.float32(0.0)
    fn = jax.vmap(lambda a, s: jwarp.affine_inverse_matrix(a, (zero, zero), s, (zero, zero), center))
    return np.array(fn(jnp.asarray(angle), jnp.asarray(scale)))


def test_affine_inverse_matrix_matches_jax():
    rng = np.random.default_rng(0)
    h, w = 64, 128
    angle, scale = _recipe_params(rng, 30)
    shear = rng.uniform(-10, 10, (30, 2)).astype(np.float32)
    translate = rng.uniform(-8, 8, (30, 2)).astype(np.float32)
    center = ((w - 1) * 0.5, (h - 1) * 0.5)
    want = np.asarray(jax.vmap(
        lambda a, t, s, sh: jwarp.affine_inverse_matrix(a, t, s, sh, center)
    )(jnp.asarray(angle), jnp.asarray(translate), jnp.asarray(scale), jnp.asarray(shear)))
    got = twarp.affine_inverse_matrix(
        torch.from_numpy(angle), torch.from_numpy(translate),
        torch.from_numpy(scale), torch.from_numpy(shear), center,
    ).numpy()
    # float32 trig in two libraries: a few ulps; translations reach ~1e2 px
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-5)


def test_shift2pass_indices_match_jax():
    """Identical int32 index vectors for recipe-range matrices; a mismatch
    is allowed only where the unrounded value lies within 1e-4 of a .5
    rounding boundary (float32 evaluation order of two libraries)."""
    rng = np.random.default_rng(1)
    h, w = 64, 128
    angle, scale = _recipe_params(rng, 48)
    mats = _jax_matrices(angle, scale, h, w)
    # compose scale∘rotation pairs as the fused recipe does
    bottom = np.broadcast_to(np.array([[[0, 0, 1]]], np.float32), (24, 1, 3))
    m3 = np.concatenate([mats[:24], bottom], 1) @ np.concatenate([mats[24:], bottom], 1)
    mats = np.concatenate([mats, m3[:, :2]], 0).astype(np.float32)

    want = [np.asarray(v) for v in jax.vmap(
        lambda m: jwarp._warp_shift2pass_indices(m, h, w))(jnp.asarray(mats))]
    got = [v.numpy() for v in twarp._warp_shift2pass_indices(torch.from_numpy(mats), h, w)]

    # unrounded values in float64 from the same float32 matrix entries
    m = mats.astype(np.float64)
    m11 = np.where(np.abs(m[:, 1, 1]) < 1e-3, 1e-3, m[:, 1, 1])
    b = m[:, 0, 1] / m11
    a = m[:, 0, 0] - b * m[:, 1, 0]
    c = m[:, 0, 2] - b * m[:, 1, 2]
    ii, xx = np.arange(h)[None], np.arange(w)[None]
    raw = [b[:, None] * ii, a[:, None] * xx + c[:, None],
           m[:, 1, 0][:, None] * xx, m[:, 1, 1][:, None] * ii + m[:, 1, 2][:, None]]
    allowed = 0
    for name, g, wv, r in zip(("ts", "m1", "us", "m2"), got, want, raw):
        assert g.dtype == np.int32 and g.shape == wv.shape, name
        diff = g != wv
        near_half = np.abs(np.abs(r - np.floor(r)) - 0.5) < 1e-4
        assert not (diff & ~near_half).any(), f"{name}: {np.argwhere(diff & ~near_half)[:5]}"
        assert (np.abs(g - wv) <= 1).all(), name
        allowed += int(diff.sum())
    print(f"index mismatches at .5 boundaries: {allowed}")


def test_plain_warp_matches_jax_shift2pass_and_pallas_interpret():
    rng = np.random.default_rng(2)
    b, h, w, c = 3, 64, 128, 4
    img = rng.random((b, h, w, c)).astype(np.float32)
    img[..., -1] = rng.integers(0, 3, (b, h, w))  # label channel of the stack
    angle, scale = _recipe_params(rng, b)
    mats = _jax_matrices(angle, scale, h, w)

    got = twarp.affine_warp_shift2pass(torch.from_numpy(img), torch.from_numpy(mats)).numpy()
    fused_cpu = twarp.affine_warp_shift2pass_fused(
        torch.from_numpy(img), torch.from_numpy(mats)).numpy()
    for i in range(b):
        ref = np.asarray(jwarp.affine_warp_shift2pass(jnp.asarray(img[i]), jnp.asarray(mats[i])))
        pallas = np.asarray(jwarp.affine_warp_pallas(
            jnp.asarray(img[i]), jnp.asarray(mats[i]), interpret=True))
        np.testing.assert_array_equal(got[i], ref)
        np.testing.assert_array_equal(got[i], pallas)
        np.testing.assert_array_equal(fused_cpu[i], ref)


def test_identity_out_of_source_and_odd_size():
    rng = np.random.default_rng(3)
    img = rng.random((2, 40, 48, 3)).astype(np.float32)
    eye = np.broadcast_to(np.eye(2, 3, dtype=np.float32), (2, 2, 3)).copy()
    out = twarp.affine_warp_shift2pass(torch.from_numpy(img), torch.from_numpy(eye)).numpy()
    np.testing.assert_array_equal(out, img)

    far = eye.copy()
    far[:, :, 2] = 1e4
    out = twarp.affine_warp_shift2pass_fused(torch.from_numpy(img), torch.from_numpy(far))
    assert not out.any()

    angle, scale = _recipe_params(rng, 2)
    mats = _jax_matrices(angle + 7.0, scale, 40, 48)
    got = twarp.affine_warp_shift2pass(torch.from_numpy(img), torch.from_numpy(mats)).numpy()
    for i in range(2):
        ref = np.asarray(jwarp.affine_warp_shift2pass(jnp.asarray(img[i]), jnp.asarray(mats[i])))
        np.testing.assert_array_equal(got[i], ref)


def test_integer_input_keeps_dtype():
    rng = np.random.default_rng(4)
    lbl = rng.integers(0, 4, (1, 32, 32, 2)).astype(np.int32)
    mats = _jax_matrices(np.float32([12.0]), np.float32([0.9]), 32, 32)
    got = twarp.affine_warp_shift2pass(torch.from_numpy(lbl), torch.from_numpy(mats)).numpy()
    want = np.asarray(jwarp.affine_warp_shift2pass(jnp.asarray(lbl[0]), jnp.asarray(mats[0])))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got[0], want)


def test_k1_launch_counter_stays_zero_on_cpu():
    before = twarp.affine_warp_shift2pass_fused.launches
    img = torch.rand(2, 16, 16, 4)
    mats = torch.eye(2, 3).expand(2, 2, 3).contiguous()
    twarp.affine_warp_shift2pass_fused(img, mats)
    assert twarp.affine_warp_shift2pass_fused.launches == before == 0


def test_k1_launch_refuses_cpu_tensors_and_bad_shapes():
    img = torch.rand(2, 16, 16, 4)
    idx = twarp._warp_shift2pass_indices(torch.eye(2, 3).expand(2, 2, 3), 16, 16)
    with pytest.raises(ValueError, match="CUDA"):
        twarp._launch_k1(img, *idx)
    with pytest.raises(ValueError, match="matrices"):
        twarp.affine_warp_shift2pass_fused(img, torch.eye(2, 3))
