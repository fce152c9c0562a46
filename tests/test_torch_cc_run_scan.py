"""K5's warp-parallel formulation on the CPU: the run-minimum sweeps of
``mia_tpu_torch/csrc/connected_components.cu`` emulated in plain torch and
held bit for bit against the port's plain version and the JAX package.

The kernel gives each line (a row, then a column) to kL lanes of a warp
(32 / kL lines a warp at a time): a lane holds kC adjacent pixels (kC x kL
covers the longer side: 4 x 8 up to 32 pixels, 8 x 8 up to 64, 8 x 16, 8 x
32, then 16 x 32), and two log-step segmented scans over the line's lanes,
up and down (shuffles by 1, 2, 4, ... of a run's minimum and its stop),
bring each lane the minimum of the runs that reach it from either side; one
pass over its pixels then gives each foreground pixel the minimum of its
run. A line longer than 512 is scanned forward, then reverse, by a whole
warp in chunks of 512 with the running minimum carried between them. A
mask's
sweeps end at the first sweep that changes no label, after ``max_iters`` at
most. The emulation below follows the kernel step by step, lanes as a tensor
axis, and its labels must equal ``morphology.connected_components`` (the
TPU kernel's Hillis-Steele schedule with exactly ``max_iters`` sweeps) and
``connected_components_pallas`` in interpret mode, converged or not, with
4- and 8-connectivity and widths 27, 64 and 65.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from mia_tpu.ops import morphology as jax_morph

from mia_tpu_torch.ops import morphology

BG = 2 ** 31 - 1  # the kernel's background label, above every pixel index
LANES = 32


def lane_layout(length):
    """(kC, kL): pixels a lane and lanes a line for lines of ``length`` (the
    C entry's dispatch by the longer side)."""
    for n, kc, kl in ((32, 4, 8), (64, 8, 8), (128, 8, 16), (256, 8, 32)):
        if length <= n:
            return kc, kl
    return 16, LANES


def lane_scan(value, stop, down):
    """The kernel's lane_scan on (L, kL) lanes: the inclusive segmented min
    over lanes 0 .. l (``down``: l .. kL-1), stopped by a lane that holds a
    background pixel."""
    lanes = value.shape[1]
    lane = torch.arange(lanes)
    d = 1
    while d < lanes:  # a shuffle by d; lanes it does not reach keep their own
        if down:
            value_o = torch.cat([value[:, d:], value[:, -d:]], 1)
            stop_o = torch.cat([stop[:, d:], stop[:, -d:]], 1)
            take = lane + d < lanes
        else:
            value_o = torch.cat([value[:, :d], value[:, :-d]], 1)
            stop_o = torch.cat([stop[:, :d], stop[:, :-d]], 1)
            take = lane >= d
        take = take & ~stop
        value = torch.where(take, torch.minimum(value, value_o), value)
        stop = torch.where(take, stop_o, stop)
        d *= 2
    return value, stop


def run_min_line(lines, kc, kl):
    """The kernel's run_min_line on lines (L, n) of at most kL kC pixels, kL
    lanes a line: the lane's first and last runs' minima, one scan each way
    over the line's lanes, then one pass over the lane's pixels from the
    left and from the right."""
    count, n = lines.shape
    x = torch.cat([lines, torch.full((count, kl * kc - n), BG, dtype=lines.dtype)], 1)
    x = x.view(count, kl, kc)
    stop = (x == BG).any(-1)
    left = torch.full((count, kl), BG, dtype=lines.dtype)
    right = left.clone()
    for c in range(kc):
        right = torch.where(x[..., c] == BG, BG, torch.minimum(right, x[..., c]))
        left = torch.where(x[..., kc - 1 - c] == BG, BG, torch.minimum(left, x[..., kc - 1 - c]))
    up, _ = lane_scan(right, stop, down=False)
    down, _ = lane_scan(left, stop, down=True)
    bg = torch.full((count, 1), BG, dtype=lines.dtype)
    from_left = torch.cat([bg, up[:, :-1]], 1)
    from_right = torch.cat([down[:, 1:], bg], 1)
    y = []
    for c in range(kc):
        from_left = torch.where(x[..., c] == BG, BG, torch.minimum(from_left, x[..., c]))
        y.append(from_left)
    out = [None] * kc
    for c in range(kc - 1, -1, -1):
        from_right = torch.where(y[c] == BG, BG, torch.minimum(from_right, y[c]))
        out[c] = from_right
    return torch.stack(out, -1).reshape(count, kl * kc)[:, :n]


def warp_seg_scan(lines, kc, reverse):
    """The kernel's seg_scan_chunks on every line of ``lines`` (L, n) at once:
    chunks of 32 kC, kC pixels a lane scanned in registers, the lanes joined
    by ``lane_scan``, the chunk's carry passed on."""
    x_all = lines.flip(-1) if reverse else lines
    count, n = x_all.shape
    chunk = LANES * kc
    carry = torch.full((count,), BG, dtype=lines.dtype)
    pieces = []
    for c0 in range(0, n, chunk):
        seg = x_all[:, c0:c0 + chunk]
        x = torch.cat([seg, torch.full((count, chunk - seg.shape[1]), BG, dtype=lines.dtype)], 1)
        x = x.view(count, LANES, kc)
        run = torch.full((count, LANES), BG, dtype=lines.dtype)
        for c in range(kc):
            run = torch.where(x[..., c] == BG, BG, torch.minimum(run, x[..., c]))
        run, closed = lane_scan(run, (x == BG).any(-1), down=False)
        enter = torch.cat([torch.full((count, 1), BG, dtype=lines.dtype), run[:, :-1]], 1)
        enter_closed = torch.cat([torch.zeros((count, 1), dtype=torch.bool), closed[:, :-1]], 1)
        enter = torch.where(enter_closed, enter, torch.minimum(carry[:, None], enter))
        carry = torch.where(closed[:, -1], run[:, -1], torch.minimum(carry, run[:, -1]))
        out = []
        for c in range(kc):
            enter = torch.where(x[..., c] == BG, BG, torch.minimum(enter, x[..., c]))
            out.append(enter)
        pieces.append(torch.stack(out, -1).reshape(count, chunk)[:, :seg.shape[1]])
    scanned = torch.cat(pieces, 1)
    return scanned.flip(-1) if reverse else scanned


def run_min(lines, kc, kl):
    """Each run of a line takes its minimum: in one pass, or for a line
    longer than 32 kC forward, then reverse, in chunks by a whole warp."""
    if lines.shape[1] <= kl * kc:
        return run_min_line(lines, kc, kl)
    assert kl == LANES
    return warp_seg_scan(warp_seg_scan(lines, kc, False), kc, True)


def cc_warp_scan(mask, connectivity=2, max_iters=16):
    """The kernel on a stack ``(N, H, W)``: labels (-1 on background) and the
    sweeps each mask ran before its early stop."""
    count, h, w = mask.shape
    kc, kl = lane_layout(max(h, w))
    idx = torch.arange(h * w, dtype=torch.int64).view(1, h, w)
    lab = torch.where(mask > 0, idx, BG)
    sweeps = torch.zeros(count, dtype=torch.int64)
    live = torch.ones(count, dtype=torch.bool)
    for _ in range(max_iters):
        new = run_min(lab.reshape(count * h, w), kc, kl).view(count, h, w)
        new = run_min(new.transpose(1, 2).reshape(count * w, h), kc, kl)
        new = new.view(count, w, h).transpose(1, 2)
        if connectivity == 2:  # one snapshot; outside the mask is min's identity
            pad = torch.nn.functional.pad(new, (1, 1, 1, 1), value=BG)
            best = new
            for dy, dx in ((-1, -1), (-1, 1), (1, -1), (1, 1)):
                best = torch.minimum(best, pad[:, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
            new = torch.where(new == BG, BG, best)
        changed = (new != lab).flatten(1).any(1)
        sweeps += live
        lab = torch.where(live[:, None, None], new, lab)
        live &= changed
        if not live.any():
            break
    return torch.where(lab == BG, -1, lab).to(torch.int32), sweeps


def masks(rng, h, w):
    """Blobs and a full mask (they converge), speckles, a spiral, an empty
    mask, and two lines that advance one row a sweep, so that 16 sweeps do
    not reach the bottom of 20 rows or more: a unit staircase (4-connected)
    and a diagonal (8-connected only)."""
    yy, xx = np.mgrid[0:h, 0:w]
    blob = np.zeros((h, w), np.int32)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(2, h / 3)
        blob |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.int32)
    rows = np.arange(min(h, w - 1))
    stair = np.zeros((h, w), np.int32)
    stair[rows, w - 1 - rows] = stair[rows, w - 2 - rows] = 1
    diagonal = np.zeros((h, w), np.int32)
    diagonal[rows, w - 1 - rows] = 1
    spiral = np.zeros((h, w), np.int32)
    for k in range(0, min(h, w) // 2, 2):
        spiral[k, k:w - k] = spiral[h - 1 - k, k:w - k] = 1
        spiral[k:h - k, w - 1 - k] = 1
        spiral[k + 2:h - k, k] = 1
    return np.stack([blob, (rng.random((h, w)) < 0.55).astype(np.int32),
                     (rng.random((h, w)) < 0.62).astype(np.int32), stair, diagonal, spiral,
                     np.zeros((h, w), np.int32), np.ones((h, w), np.int32)])


SHAPES = [(20, 27), (64, 64), (33, 65)]


@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_warp_run_scans_are_bit_exact_against_plain_and_jax(rng, shape, connectivity):
    stack = masks(rng, *shape)
    got, sweeps = cc_warp_scan(torch.from_numpy(stack), connectivity)
    want = morphology.connected_components(torch.from_numpy(stack), connectivity, 16)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    pallas = np.asarray(jax.vmap(lambda m: jax_morph.connected_components_pallas(
        m, connectivity, 16, interpret=True))(jnp.asarray(stack)))
    np.testing.assert_array_equal(got.numpy(), pallas)
    # the stack holds masks that stop early and masks that run all 16 sweeps
    assert sweeps.min() < 16 and sweeps.max() == 16
    converged = morphology.connected_components(torch.from_numpy(stack), connectivity, None)
    assert not torch.equal(want, converged)


@pytest.mark.parametrize("connectivity", [1, 2])
def test_early_stop_is_the_first_sweep_that_changes_nothing(rng, connectivity):
    """Each mask's loop ends after sweep s, the first whose labels equal those
    of sweep s - 1, as the plain version's sweeps show."""
    stack = torch.from_numpy(masks(rng, 20, 27))
    _, sweeps = cc_warp_scan(stack, connectivity)
    plain = [morphology.connected_components(stack, connectivity, k) for k in range(17)]
    for i, s in enumerate(sweeps.tolist()):
        same = [k for k in range(1, 17) if torch.equal(plain[k][i], plain[k - 1][i])]
        assert s == (same[0] if same else 16)


@pytest.mark.parametrize("length", [5, 31, 32, 33, 64, 65, 600])
def test_warp_scan_carries_runs_across_lanes_and_chunks(rng, length):
    """Lines whose runs cross lane boundaries (and, at 600 pixels, the chunk
    boundary of 16 pixels a lane): the warp scans equal the serial walk."""
    lines = torch.from_numpy(rng.integers(0, 1000, (64, length)))
    lines[torch.from_numpy(rng.random((64, length)) < np.linspace(0.02, 0.5, 64)[:, None])] = BG
    want = lines.clone()
    for reverse in (False, True):
        order = range(length - 1, -1, -1) if reverse else range(length)
        run = torch.full((64,), BG, dtype=lines.dtype)
        for i in order:
            run = torch.where(want[:, i] == BG, BG, torch.minimum(run, want[:, i]))
            want[:, i] = run
    assert torch.equal(run_min(lines, *lane_layout(length)), want)


def test_multi_chunk_masks_match_plain(rng):
    """Rows of 600 pixels: two chunks of 512 a line."""
    stack = (rng.random((2, 6, 600)) < 0.7).astype(np.int32)
    for connectivity in (1, 2):
        got, _ = cc_warp_scan(torch.from_numpy(stack), connectivity)
        assert torch.equal(got, morphology.connected_components(torch.from_numpy(stack),
                                                                connectivity, 16))
