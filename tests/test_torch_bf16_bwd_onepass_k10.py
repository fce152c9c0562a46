"""A CPU model of the order of the bfloat16 K10b one pass
(``conv_transpose2x_bwd_onepass_kernel`` of ``csrc/upsample2x.cu``), held
against the port's plain bfloat16 VJP (``conv_transpose2x_bwd_plain_bf16``)
and against ``jax.vjp`` of ``mia_tpu``'s ``conv_transpose2x_p(...,
interpret=True)`` on bfloat16 operands.

The kernel reads every pixel's x row and dy taps once. A persistent grid of
``min(stages, 2 * 132)`` blocks walks the pixels in stages of ``kP`` (128, or
64 where Cin + 4 Cout (padded) > 128), block ``z`` taking stages ``z, z +
grid, ...``. Per stage: dx of each pixel is its 4*Cout-deep float32 sum of
dy . wT, in 32-deep chains added in float32, rounded once to bfloat16; dwT
(4*Cout, Cin) gets each 32-pixel chain's dy^T . x (from zero) added to the
block's float32 partial, db the chain's float32 column sums of dy. The reduce
adds the blocks' partials as ``conv_transpose2x_reduce_kernel`` does (lane
``c`` of 32, or of 8 under 64 blocks, adds blocks ``c, c + lanes, ...`` in
order, then lane 0 the lanes' sums in order; db adds a block's four taps in
turn) and rounds dw once. The model takes the same steps in float32
(torch's sums where the tensor cores sum a chain).

The measure is ``test_torch_bf16_upsample2x.py``'s: one ulp (the ulp taken
at no less than 2^-6 of max |reference|) with at least 99.9% bit-equal for
dx and dw, db within 1e-6 relative of max |db|. Measured: bit for bit
against the plain VJP and against the Pallas kernel at every shape here,
also with a walk of small stages over three blocks (stage 32: the block
order and the reduce's lanes then carry more partials than pixels do).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from mia_tpu.ops.upsample2x import conv_transpose2x_p

import torch
from test_torch_bf16_upsample2x import MAX_ULPS, MIN_EQUAL, _agreement, _operands

from mia_tpu_torch.ops import upsample2x as up

BF = torch.bfloat16
SMS, BLOCKS_PER_SM = 132, 2
CHAIN = 32  # depth of an MMA chain before its float32 add
# (B, H, W, Cin, Cout): Cin = Cout = 16 (prompt-large 4's channels), 32 -> 16 (prompt-large 3's),
# ragged widths (12, 13: pixel stages that end mid-row) and Cout 8 (4 Cout padded to 64)
SHAPES = [(2, 8, 8, 16, 16), (2, 8, 8, 32, 16), (2, 5, 12, 16, 16), (3, 7, 13, 16, 8)]


def stage_pixels(cin: int, cout: int) -> int:
    """The kernel's kP for (Cin, Cout): the padded channel counts decide."""
    k_cin = 16 if cin <= 16 else 32 if cin <= 32 else 64
    k_n4 = 64 if 4 * cout <= 64 else 128
    return 64 if k_cin + k_n4 > 128 else 128


def reduce_blocks(part: torch.Tensor, taps: int = 1) -> torch.Tensor:
    """The reduce's order over ``part (blocks, ..., taps * m)``: lanes of
    blocks c, c + lanes, ... (each block's taps in turn), then the lanes."""
    blocks = part.shape[0]
    lanes = 32 if blocks >= 64 else 8
    per_tap = part.shape[-1] // taps
    sums = []
    for c in range(lanes):
        s = torch.zeros(part.shape[1:-1] + (per_tap,))
        for z in range(c, blocks, lanes):
            for tap in range(taps):
                s = s + part[z, ..., tap * per_tap:(tap + 1) * per_tap]
        sums.append(s)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def onepass_bwd(x, w, dy, stage=None, most_blocks=SMS * BLOCKS_PER_SM):
    """The one pass's order → (dx bfloat16, dw bfloat16, db float32)."""
    b, h, wd, cin = x.shape
    cout = w.shape[-1]
    pixels = b * h * wd
    xf = x.float().reshape(pixels, cin)
    # dy's taps by pixel, k = tap * Cout + co (the (B, H, 2, W, 2 Cout) view)
    taps = dy.float().reshape(b, h, 2, wd, 2, cout).permute(0, 1, 3, 2, 4, 5).reshape(pixels, -1)
    w_t = w.float().permute(2, 0, 1, 3).reshape(cin, 4 * cout)  # wT(k, ci) at w_t[ci, k]
    dx = torch.zeros(pixels, cin)
    for k0 in range(0, 4 * cout, CHAIN):
        dx = dx + taps[:, k0:k0 + CHAIN] @ w_t[:, k0:k0 + CHAIN].T
    stage = stage or stage_pixels(cin, cout)
    stages = -(-pixels // stage)
    grid = min(stages, most_blocks)
    part = torch.zeros(grid, 4 * cout, cin)
    sums = torch.zeros(grid, 4 * cout)
    for z in range(grid):
        for st in range(z, stages, grid):
            for c0 in range(st * stage, min((st + 1) * stage, pixels), CHAIN):
                seg = slice(c0, min(c0 + CHAIN, pixels))
                part[z] = part[z] + taps[seg].T @ xf[seg]
                sums[z] = sums[z] + taps[seg].sum(0)
    dw_t = reduce_blocks(part.transpose(1, 2))  # (Cin, 4 Cout): the reduce's layout
    dw = dw_t.reshape(cin, 2, 2, cout).permute(1, 2, 0, 3)
    db = reduce_blocks(sums, taps=4)
    return dx.reshape(b, h, wd, cin).to(BF), dw.contiguous().to(BF), db


def _torch(*arrays):
    return [torch.from_numpy(a).to(BF) for a in arrays]


def _holds(got, want):
    """dx and dw at the measure, db within 1e-6 relative of max |db|."""
    for name, g, wnt in zip(("dx", "dw"), got[:2], want[:2]):
        assert g.dtype == BF and tuple(g.shape) == tuple(np.shape(wnt)), name
        ulps, equal = _agreement(g, wnt)
        assert ulps <= MAX_ULPS and equal >= MIN_EQUAL, (name, ulps, equal)
    db, want_db = got[2].numpy(), np.asarray(want[2], np.float32)
    assert got[2].dtype == torch.float32
    np.testing.assert_allclose(db, want_db, rtol=0, atol=1e-6 * float(np.abs(want_db).max()))


@pytest.mark.parametrize("shape", SHAPES)
def test_onepass_model_matches_the_plain_bf16_vjp(shape):
    x, w, _, dy = _operands(shape, seed=3)
    x, w, dy = _torch(x, w, dy)
    want = up.conv_transpose2x_bwd_plain_bf16(x, w, dy)
    _holds(onepass_bwd(x, w, dy), want)
    # a walk of small stages over three blocks: each block adds several stages' chains
    _holds(onepass_bwd(x, w, dy, stage=32, most_blocks=3), want)


@pytest.mark.parametrize("shape", SHAPES)
def test_onepass_model_matches_jax_pallas_in_bfloat16(shape):
    x, w, b, dy = _operands(shape, seed=5)
    xj, wj, dyj = (jnp.asarray(a, jnp.bfloat16) for a in (x, w, dy))
    _, vjp = jax.vjp(lambda *a: conv_transpose2x_p(*a, True), xj, wj, jnp.asarray(b))
    want = vjp(dyj)
    xt, wt, dyt = _torch(x, w, dy)
    _holds(onepass_bwd(xt, wt, dyt), [np.asarray(a.astype(jnp.float32)) for a in want])


def test_onepass_stages_and_blocks_follow_the_instances():
    """kP by the padded channel counts; the grid at most two blocks an SM, so
    prompt-large 4 walks 6144 stages over 264 blocks, 23 or 24 each."""
    assert [stage_pixels(*c) for c in ((16, 16), (32, 16), (8, 8), (64, 16), (64, 32), (16, 32),
                                       (24, 24))] == [128, 128, 128, 128, 64, 64, 64]
    pixels = 12 * 256 * 256
    stages = pixels // stage_pixels(16, 16)
    grid = min(stages, SMS * BLOCKS_PER_SM)
    assert (stages, grid) == (6144, 264)
    assert {len(range(z, stages, grid)) for z in range(grid)} == {23, 24}


def test_onepass_model_without_dw_gives_the_same_dx():
    x, w, _, dy = _operands((2, 5, 12, 16, 16), seed=7)
    x, w, dy = _torch(x, w, dy)
    full = onepass_bwd(x, w, dy)
    plain_dx = up.conv_transpose2x_bwd_plain_bf16(x, w, dy, need_dw=False)[0]
    assert torch.equal(full[0], onepass_bwd(x, w, dy, stage=32, most_blocks=3)[0])
    ulps, equal = _agreement(full[0], plain_dx.float().numpy())
    assert ulps <= MAX_ULPS and equal >= MIN_EQUAL
