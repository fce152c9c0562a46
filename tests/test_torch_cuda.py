"""K1-K10 and the backward kernels on the card: the CUDA kernels against their
plain PyTorch versions.

Needs an NVIDIA GPU with nvcc; skipped without one. On the GPU machine,
which has no JAX, run it with the repository's conftest switched off:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from mia_tpu_torch.ops import warp

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel is built with nvcc on first use)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(12, 256, 256, 4), (3, 37, 45, 4), (2, 40, 48, 3), (1, 33, 17, 5)])
def test_k1_bit_exact_against_plain(cuda, shape):
    gen = torch.Generator(device=cuda).manual_seed(0)
    b, h, w, c = shape
    img = torch.rand(shape, generator=gen, device=cuda)
    angle = (torch.rand(b, generator=gen, device=cuda) - 0.5) * 30.0
    scale = 0.7 + 0.7 * torch.rand(b, generator=gen, device=cuda)
    zeros2 = torch.zeros(b, 2, device=cuda)
    mats = warp.affine_inverse_matrix(angle, zeros2, scale, zeros2, ((w - 1) / 2, (h - 1) / 2))
    before = warp.affine_warp_shift2pass_fused.launches
    got = warp.affine_warp_shift2pass_fused(img, mats)
    want = warp.affine_warp_shift2pass(img, mats)
    torch.cuda.synchronize()
    assert warp.affine_warp_shift2pass_fused.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_k1_rejects_non_float32(cuda):
    img = torch.rand(1, 8, 8, 4, device=cuda, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32"):
        warp.affine_warp_shift2pass_fused(img, torch.eye(2, 3, device=cuda)[None])


# K2, K3, K4 against their plain versions: max |kernel - plain| <= 1e-5 of
# max |plain| (float32, different summation order).
def _rel_err(got, want):
    return ((got - want).abs().max() / want.abs().max()).item()


@pytest.mark.parametrize("b,heads,d,ws", [(9, 12, 64, 14), (72, 12, 64, 14), (6, 3, 64, 7),
                                          (4, 16, 80, 14), (3, 2, 64, 1)])
def test_k2_matches_plain(cuda, b, heads, d, ws):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(1)
    n = ws * ws
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=cuda)
    rh = 0.2 * torch.randn(n, d, generator=gen, device=cuda)
    rw = 0.2 * torch.randn(n, d, generator=gen, device=cuda)
    before = attention.fused_attention_rel_packed_ik.launches
    got = attention.fused_attention_rel_packed_ik(qkv, rh, rw, d ** -0.5, (ws, ws), heads)
    want = attention.attention_rel_packed_ik(qkv, rh, rw, d ** -0.5, (ws, ws), heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_packed_ik.launches == before + 1
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("b,heads,d,k_hw", [(1, 12, 64, (32, 32)), (8, 12, 64, (32, 32)),
                                            (1, 12, 64, (64, 64)), (2, 4, 64, (20, 27)),
                                            (2, 2, 64, (1, 3))])
def test_k3_matches_plain(cuda, b, heads, d, k_hw):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(2)
    n = k_hw[0] * k_hw[1]
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=cuda)
    rel_h = torch.randn(b * heads, n, k_hw[0], generator=gen, device=cuda)
    rel_w = torch.randn(b * heads, n, k_hw[1], generator=gen, device=cuda)
    before = attention.fused_attention_rel_packed.launches
    got = attention.fused_attention_rel_packed(qkv, rel_h, rel_w, d ** -0.5, k_hw, heads)
    want = attention.attention_rel_packed(qkv, rel_h, rel_w, d ** -0.5, k_hw, heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_packed.launches == before + 1
    assert _rel_err(got, want) <= 1e-5


# K2 and K3 run the 3xTF32 tensor-core template of csrc/attention_fwd_tc.cuh:
# the per-row log-sum-exp the backward reads is within 1e-5 of the plain
# one, absolutely (its values are O(10) at these inputs, so that is ~1e-6 of
# them), and two launches are bit-identical. K3 at B=1 (192 blocks, under
# three a multiprocessor) streams 64-key tiles, at B=12 32-key ones; K2 at 9
# and 108 windows, a ragged 9x9 window and head dim 80 (16 heads).
def _plain_lse(qkv, rel_h, rel_w, scale, k_hw, heads):
    b, n, _ = qkv.shape
    q, k, _ = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    bias = rel_h.reshape(b, heads, n, k_hw[0], 1) + rel_w.reshape(b, heads, n, 1, k_hw[1])
    return torch.logsumexp((q * scale) @ k.transpose(-2, -1) + bias.reshape(b, heads, n, n),
                           -1).reshape(b * heads, n)


@pytest.mark.parametrize("kernel,b,heads,d,side", [("K3", 1, 12, 64, 32), ("K3", 12, 12, 64, 32),
                                                   ("K3", 2, 4, 64, 27), ("K3", 1, 16, 80, 32),
                                                   ("K2", 9, 12, 64, 14), ("K2", 108, 12, 64, 14),
                                                   ("K2", 5, 4, 64, 9), ("K2", 9, 16, 80, 14)])
def test_k2_k3_lse_and_bit_identity(cuda, kernel, b, heads, d, side):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(6)
    k_hw = (side, side) if kernel == "K2" else (20 if side == 27 else side, side)
    n = k_hw[0] * k_hw[1]
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=cuda)
    if kernel == "K2":
        rh = 0.2 * torch.randn(n, d, generator=gen, device=cuda)
        rw = 0.2 * torch.randn(n, d, generator=gen, device=cuda)
        args = (qkv, rh, rw, d ** -0.5, k_hw, heads)
        launch, plain = attention._launch_k2, attention.attention_rel_packed_ik
        rel_h, rel_w = attention.window_rel_terms(qkv, rh, rw, k_hw, heads)
    else:
        rel_h = torch.randn(b * heads, n, k_hw[0], generator=gen, device=cuda)
        rel_w = torch.randn(b * heads, n, k_hw[1], generator=gen, device=cuda)
        args = (qkv, rel_h, rel_w, d ** -0.5, k_hw, heads)
        launch, plain = attention._launch_k3, attention.attention_rel_packed
    out, lse = launch(*args, with_lse=True)
    out2, lse2 = launch(*args, with_lse=True)
    want = _plain_lse(qkv, rel_h, rel_w, d ** -0.5, k_hw, heads)
    torch.cuda.synchronize()
    assert _rel_err(out, plain(*args)) <= 1e-5
    assert (lse - want).abs().max().item() <= 1e-5
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert torch.equal(launch(*args), out)  # without the lse: the same kernel


@pytest.mark.parametrize("shape,ws", [((1, 32, 32, 768), 14), ((8, 32, 32, 768), 14),
                                      ((2, 20, 27, 768), 14), ((1, 9, 11, 30), 4)])
def test_k4_matches_plain(cuda, shape, ws):
    from mia_tpu_torch.ops import ln_window

    gen = torch.Generator(device=cuda).manual_seed(3)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.5 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    before = ln_window.ln_window_partition_fused.launches
    got = ln_window.ln_window_partition_fused(x, scale, bias, ws)
    want = ln_window.ln_window_partition(x, scale, bias, ws)
    torch.cuda.synchronize()
    assert ln_window.ln_window_partition_fused.launches == before + 1
    assert got.shape == want.shape
    assert _rel_err(got, want) <= 1e-5
    assert not got[want == 0].any()  # pad slots are exact zeros


def test_attention_kernels_reject_unsupported_head_dim(cuda):
    from mia_tpu_torch.ops import attention

    qkv = torch.zeros(1, 16, 3 * 2 * 24, device=cuda)
    rel = torch.zeros(2, 16, 4, device=cuda)
    with pytest.raises(ValueError, match="head dims"):
        attention.fused_attention_rel_packed(qkv, rel, rel, 0.2, (4, 4), 2)


# Backward kernels of K2, K3, K4 against the plain VJPs: max |kernel - plain|
# <= 1e-4 of max |plain| for each output (float32; the kernels sum in
# another order and take p from the forward's log-sum-exp).
BWD_TOL = 1e-4


def _bit_identical(first, second):
    return all((x is None and y is None) or torch.equal(x, y) for x, y in zip(first, second))


# K2b and K3b run the 3xTF32 tensor-core template in 64-row tiles: the
# shapes cover ViT-B/512 training (B=12 and 6), ragged tiles (a 196-token
# window is three 64-key tiles and 4 keys; 81 and 4 tokens), a ragged grid,
# 4096 global tokens and the ViT-H head dim 80; two launches are bit-identical.
# Their p comes from the log-sum-exp of the forward kernel (K2, K3) on the
# same inputs.
@pytest.mark.parametrize("tables", [False, True])
@pytest.mark.parametrize("b,heads,d,ws", [(108, 12, 64, 14), (54, 12, 64, 14), (6, 3, 64, 7),
                                          (5, 4, 64, 9), (4, 16, 80, 14), (3, 2, 64, 2)])
def test_k2_backward_matches_plain_vjp(cuda, b, heads, d, ws, tables):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(4)
    n = ws * ws
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=cuda)
    rh = 0.2 * torch.randn(n, d, generator=gen, device=cuda)
    rw = 0.2 * torch.randn(n, d, generator=gen, device=cuda)
    g = torch.randn(b, n, heads * d, generator=gen, device=cuda)
    args = (d ** -0.5, (ws, ws), heads)
    out, lse = attention._launch_k2(qkv, rh, rw, *args, with_lse=True)
    before = attention.fused_attention_rel_packed_ik_bwd.launches
    got = attention.fused_attention_rel_packed_ik_bwd(qkv, rh, rw, out, g, lse, *args, tables=tables)
    want = attention.attention_rel_packed_ik_bwd(qkv, rh, rw, out, g, *args, tables=tables)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_packed_ik_bwd.launches == before + 1
    for x, y in zip(got, want):
        if y is None:
            assert x is None
        else:
            assert _rel_err(x, y) <= BWD_TOL
    again = attention._launch_k2_bwd(qkv, rh, rw, out, g, lse, *args, tables)
    assert _bit_identical(got, again)


@pytest.mark.parametrize("b,heads,d,k_hw", [(12, 12, 64, (32, 32)), (6, 12, 64, (32, 32)),
                                            (2, 4, 64, (20, 27)), (1, 12, 64, (64, 64)),
                                            (2, 16, 80, (32, 32)), (2, 2, 80, (5, 9))])
def test_k3_backward_matches_plain_vjp(cuda, b, heads, d, k_hw):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(5)
    n = k_hw[0] * k_hw[1]
    qkv = torch.randn(b, n, 3 * heads * d, generator=gen, device=cuda)
    rel_h = torch.randn(b * heads, n, k_hw[0], generator=gen, device=cuda)
    rel_w = torch.randn(b * heads, n, k_hw[1], generator=gen, device=cuda)
    g = torch.randn(b, n, heads * d, generator=gen, device=cuda)
    args = (d ** -0.5, k_hw, heads)
    out, lse = attention._launch_k3(qkv, rel_h, rel_w, *args, with_lse=True)
    before = attention.fused_attention_rel_packed_bwd.launches
    got = attention.fused_attention_rel_packed_bwd(qkv, rel_h, rel_w, out, g, lse, *args)
    want = attention.attention_rel_packed_bwd(qkv, rel_h, rel_w, out, g, *args)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_packed_bwd.launches == before + 1
    for x, y in zip(got, want):
        assert _rel_err(x, y) <= BWD_TOL
    assert _bit_identical(got, attention._launch_k3_bwd(qkv, rel_h, rel_w, out, g, lse, *args))


@pytest.mark.parametrize("shape,ws,params", [((12, 32, 32, 768), 14, False),
                                             ((2, 20, 27, 768), 14, True), ((1, 9, 11, 30), 4, True)])
def test_k4_backward_matches_plain_vjp(cuda, shape, ws, params):
    from mia_tpu_torch.ops import ln_window

    gen = torch.Generator(device=cuda).manual_seed(6)
    c = shape[-1]
    x = torch.randn(shape, generator=gen, device=cuda)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.5 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    y, mu, rstd = ln_window._launch_k4(x, scale, bias, ws, 1e-6, with_stats=True)
    dy = torch.randn(y.shape, generator=gen, device=cuda)
    before = ln_window.ln_window_partition_fused_bwd.launches
    got = ln_window.ln_window_partition_fused_bwd(x, dy, mu, rstd, scale, ws, params)
    want = ln_window.ln_window_partition_bwd(x, dy, mu, rstd, scale, ws, params)
    torch.cuda.synchronize()
    assert ln_window.ln_window_partition_fused_bwd.launches == before + 1
    want_mu, want_rstd = ln_window.layer_norm_stats(x, 1e-6)
    assert _rel_err(mu, want_mu[..., 0]) <= 1e-5 and _rel_err(rstd, want_rstd[..., 0]) <= 1e-5
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert _rel_err(a, b) <= BWD_TOL


def test_encoder_block_gradients_go_through_the_backward_kernels(cuda):
    from mia_tpu_torch.models.sam.image_encoder import Block
    from mia_tpu_torch.ops import attention, ln_window

    torch.manual_seed(0)
    for window in (14, 0):
        blk = Block(768, 12, window, (32, 32), lora_rank=4).to(cuda)
        x = torch.randn(2, 32, 32, 768, device=cuda, requires_grad=True)
        counters = (attention.fused_attention_rel_packed_ik_bwd, attention.fused_attention_rel_packed_bwd,
                    ln_window.ln_window_partition_fused_bwd)
        before = [c.launches for c in counters]
        blk(x).square().mean().backward()
        torch.cuda.synchronize()
        after = [c.launches - b for c, b in zip(counters, before)]
        assert after == ([1, 0, 1] if window else [0, 1, 0])
        assert torch.isfinite(x.grad).all()


def _cc_masks(gen, device, n=144, size=64):
    yy, xx = torch.meshgrid(torch.arange(size, device=device), torch.arange(size, device=device),
                            indexing="ij")
    masks = []
    for i in range(n):
        kind = i % 4
        if kind == 0:  # blobs
            c = torch.rand(3, 2, generator=gen, device=device) * size
            r = 4 + torch.rand(3, generator=gen, device=device) * size / 5
            m = ((yy[None] - c[:, :1, None]) ** 2 + (xx[None] - c[:, 1:, None]) ** 2 < r[:, None, None] ** 2).any(0)
        elif kind == 1:  # speckle, not converged in 16 sweeps
            m = torch.rand(size, size, generator=gen, device=device) < 0.55
        elif kind == 2:
            m = torch.zeros(size, size, dtype=torch.bool, device=device)
        else:
            m = torch.ones(size, size, dtype=torch.bool, device=device)
        masks.append(m)
    return torch.stack(masks).to(torch.int32)


def _diagonal_masks(device, size, lengths):
    """Anti-diagonal lines of ``lengths`` pixels: 8-connected, they converge
    after about as many sweeps as pixels (4-connected, after one)."""
    masks = torch.zeros(len(lengths), size, size, dtype=torch.int32, device=device)
    for i, length in enumerate(lengths):
        r = torch.arange(min(length, size), device=device)
        masks[i, r, size - 1 - r] = 1
    return masks


# the K5 kernel ends each mask's loop at its first sweep that changes nothing:
# masks that stop at different sweeps, and unconverged ones, in one launch
@pytest.mark.parametrize("connectivity", [1, 2])
@pytest.mark.parametrize("size", [64, 512])
def test_k5_bit_exact_against_plain(cuda, size, connectivity):
    from mia_tpu_torch.ops import morphology

    gen = torch.Generator(device=cuda).manual_seed(7)
    masks = torch.cat([_cc_masks(gen, cuda, n=144 if size == 64 else 4, size=size),
                       _diagonal_masks(cuda, size, (2, 5, 9, 14, 30))])
    before = morphology.connected_components_fused.launches
    got = morphology.connected_components_fused(masks, connectivity)
    want = morphology.connected_components(masks, connectivity)
    again = morphology.connected_components_fused(masks, connectivity)
    torch.cuda.synchronize()
    assert morphology.connected_components_fused.launches == before + 2
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(got, again)


@pytest.mark.parametrize("shape", [(20, 27), (33, 65), (6, 600), (1, 1)])
def test_k5_odd_shapes(cuda, shape):
    """Lines that no lane count divides, a line of two chunks, one pixel."""
    from mia_tpu_torch.ops import morphology

    gen = torch.Generator(device=cuda).manual_seed(8)
    masks = (torch.rand(12, *shape, generator=gen, device=cuda) < 0.6).to(torch.int32)
    for connectivity in (1, 2):
        got = morphology.connected_components_fused(masks, connectivity)
        torch.cuda.synchronize()
        assert torch.equal(got, morphology.connected_components(masks, connectivity))


# K6-K9 (forward kernels) against their plain versions, same tolerance as
# K2-K4; K9's x_new bit for bit (one float32 add). K6 runs K3's 3xTF32
# instance: also two launches bit-identical.
@pytest.mark.parametrize("bh,d,k_hw", [(108, 64, (14, 14)), (12, 64, (32, 32)), (16, 80, (14, 14)),
                                       (6, 64, (10, 12)), (4, 64, (5, 7)), (3, 64, (1, 3))])
def test_k6_matches_plain(cuda, bh, d, k_hw):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(8)
    n = k_hw[0] * k_hw[1]
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=cuda) for _ in range(3))
    rel_h = torch.randn(bh, n, k_hw[0], generator=gen, device=cuda)
    rel_w = torch.randn(bh, n, k_hw[1], generator=gen, device=cuda)
    before = attention.fused_attention_rel.launches
    got = attention.attention_rel_with_padding(q, k, v, rel_h, rel_w, d ** -0.5, k_hw)
    want = attention.attention_rel(q, k, v, rel_h, rel_w, d ** -0.5, k_hw)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel.launches == before + 1
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(attention.fused_attention_rel(q, k, v, rel_h, rel_w, d ** -0.5, k_hw), got)


# K7 runs 3xTF32 on the tensor cores: also two launches bit-identical
@pytest.mark.parametrize("bh,d,n", [(108, 64, 196), (12, 64, 1024), (16, 80, 196), (5, 64, 120),
                                    (3, 64, 1), (4, 64, 35), (864, 64, 196)])
def test_k7_matches_plain(cuda, bh, d, n):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=cuda) for _ in range(3))
    bias = torch.randn(bh, n, n, generator=gen, device=cuda)
    before = attention.fused_attention.launches
    got = attention.attention_with_padding(q, k, v, bias, d ** -0.5)
    want = attention.attention_dense(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert attention.fused_attention.launches == before + 1
    assert _rel_err(got, want) <= 1e-5
    assert torch.equal(attention.fused_attention(q, k, v, bias, d ** -0.5), got)


# -inf over the first key tile (64 keys, whichever tile width the launch
# takes) of every other row, and over scattered keys: finite, and within
# 1e-5 of the plain softmax, wherever a row keeps a finite key
@pytest.mark.parametrize("bh,d,n", [(12, 64, 1024), (108, 64, 196), (16, 80, 196), (4, 64, 99)])
def test_k7_masked_leading_key_tile(cuda, bh, d, n):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(10)
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=cuda) for _ in range(3))
    bias = torch.randn(bh, n, n, generator=gen, device=cuda)
    bias[:, ::2, :64] = -torch.inf
    bias[:, 1::4, torch.rand(n, generator=gen, device=cuda) < 0.3] = -torch.inf
    bias[:, :, n - 1] = 0.0
    got = attention.fused_attention(q, k, v, bias, d ** -0.5)
    want = attention.attention_dense(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, want) <= 1e-5


@pytest.mark.parametrize("b,hw,heads,d,ws", [(1, (32, 32), 12, 64, 14), (8, (32, 32), 12, 64, 14),
                                             (2, (20, 27), 12, 64, 14), (1, (32, 32), 16, 80, 14),
                                             (2, (8, 8), 2, 64, 4), (1, (5, 9), 3, 64, 4)])
def test_k8_matches_plain(cuda, b, hw, heads, d, ws):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(10)
    h, w = hw
    qkv = torch.randn(b, h, w, 3 * heads * d, generator=gen, device=cuda)
    rel_h = torch.randn(b * heads, h, w, ws, generator=gen, device=cuda)
    rel_w = torch.randn(b * heads, h, w, ws, generator=gen, device=cuda)
    bias_kv = torch.randn(3, heads * d, generator=gen, device=cuda)
    args = (qkv, rel_h, rel_w, bias_kv, d ** -0.5, ws, heads)
    before = attention.fused_attention_rel_win.launches
    got = attention.fused_attention_rel_win(*args)
    want = attention.attention_rel_win(*args)
    again, lse = attention._launch_k8(*args, with_lse=True)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_win.launches == before + 2
    assert got.shape == want.shape == (b, h, w, heads * d)
    assert _rel_err(got, want) <= 1e-5
    # K8 runs 3xTF32 on the tensor cores: two launches bit-identical, and the
    # log-sum-exp of every real query by token
    assert torch.equal(got, again)
    windows, r_h, r_w = attention.partition_rel_win(qkv, rel_h, rel_w, bias_kv, ws, heads)
    lse_w = _plain_lse(windows, r_h, r_w, d ** -0.5, (ws, ws), heads)
    hp, wp = -(-h // ws) * ws, -(-w // ws) * ws
    want_lse = (lse_w.reshape(b, hp // ws, wp // ws, heads, ws, ws).permute(0, 3, 1, 4, 2, 5)
                .reshape(b, heads, hp, wp)[:, :, :h, :w].reshape(b * heads, h * w))
    assert lse.shape == want_lse.shape
    assert (lse - want_lse).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape,ws", [((1, 32, 32, 768), 14), ((8, 32, 32, 768), 14),
                                      ((2, 20, 27, 768), 14), ((1, 9, 11, 30), 4)])
def test_k9_matches_plain(cuda, shape, ws):
    from mia_tpu_torch.ops import unpartition_residual as upr

    gen = torch.Generator(device=cuda).manual_seed(11)
    b, h, w, c = shape
    n_win = b * -(-h // ws) * -(-w // ws)
    windows = torch.randn(n_win, ws, ws, c, generator=gen, device=cuda)
    shortcut = torch.randn(shape, generator=gen, device=cuda)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.5 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    before = upr.unpartition_add_ln.launches
    got_x, got_y = upr.unpartition_add_ln(windows, shortcut, scale, bias, ws)
    want_x, want_y = upr.unpartition_add_ln_plain(windows, shortcut, scale, bias, ws)
    torch.cuda.synchronize()
    assert upr.unpartition_add_ln.launches == before + 1
    assert torch.equal(got_x, want_x)
    assert _rel_err(got_y, want_y) <= 1e-5


def test_forward_only_kernels_raise_where_a_gradient_is_needed(cuda):
    """No route kernel is forward only any more: the gradient of each wrapper
    on CUDA tensors comes from its backward kernel (K7's from the plain VJP)
    and agrees with autograd through the plain version; under ``no_grad`` the
    same call serves without saving anything."""
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops import unpartition_residual as upr

    gen = torch.Generator(device=cuda).manual_seed(12)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda)

    q, k, v = randn(2, 16, 64), randn(2, 16, 64), randn(2, 16, 64)
    rel, grid = randn(2, 16, 4), randn(2, 5, 6, 4)
    cases = (
        (attention.fused_attention_rel, attention.attention_rel, (q, k, v, rel, rel), (0.1, (4, 4)),
         {attention.fused_attention_rel: 1, attention.fused_attention_rel_bwd: 1}),
        (attention.fused_attention, attention.attention_dense, (q, k, v, randn(2, 16, 16)), (0.1,),
         {attention.fused_attention: 1}),
        (attention.fused_attention_rel_win, attention.attention_rel_win,
         (randn(1, 5, 6, 384), grid, grid, randn(3, 128)), (0.1, 4, 2),
         {attention.fused_attention_rel_win: 1, attention.fused_attention_rel_win_bwd: 1}),
        (upr.unpartition_add_ln, upr.unpartition_add_ln_plain,
         (randn(4, 4, 4, 64), randn(1, 5, 6, 64), 1.0 + 0.1 * randn(64), randn(64)), (4,),
         {upr.unpartition_add_ln: 1, upr.unpartition_add_ln_fused_bwd: 1}),
    )
    for fused, plain, tensors, config, expect in cases:
        leaves = [t.clone().requires_grad_() for t in tensors]
        before = {fn: fn.launches for fn in expect}
        outs = fused(*leaves, *config)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [randn(*o.shape) for o in outs]
        got = torch.autograd.grad(outs, leaves, cots)
        torch.cuda.synchronize()
        assert {fn: fn.launches - before[fn] for fn in expect} == expect
        ref_leaves = [t.clone().requires_grad_() for t in tensors]
        ref_outs = plain(*ref_leaves, *config)
        ref_outs = ref_outs if isinstance(ref_outs, tuple) else (ref_outs,)
        want = torch.autograd.grad(ref_outs, ref_leaves, cots)
        for a, b in zip(got, want):
            assert _rel_err(a, b) <= 1e-4
        with torch.no_grad():
            fused(*tensors, *config)  # the same call serves


# K6b, K8b, K9b against their plain VJPs: each output within 1e-4 of max |plain|
# (float32; another summation order, the probabilities from the forward's lse).
@pytest.mark.parametrize("bh,d,k_hw", [(1296, 64, (14, 14)), (72, 64, (32, 32)), (6, 64, (10, 12)),
                                       (32, 80, (14, 14)), (3, 64, (2, 3))])
def test_k6_backward_matches_plain(cuda, bh, d, k_hw):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(13)
    n = k_hw[0] * k_hw[1]
    q, k, v, g = (torch.randn(bh, n, d, generator=gen, device=cuda) for _ in range(4))
    rel_h = torch.randn(bh, n, k_hw[0], generator=gen, device=cuda)
    rel_w = torch.randn(bh, n, k_hw[1], generator=gen, device=cuda)
    out, lse = attention._launch_k6(q, k, v, rel_h, rel_w, d ** -0.5, k_hw, with_lse=True)
    before = attention.fused_attention_rel_bwd.launches
    got = attention.fused_attention_rel_bwd(q, k, v, rel_h, rel_w, out, g, lse, d ** -0.5, k_hw)
    want = attention.attention_rel_bwd(q, k, v, rel_h, rel_w, out, g, d ** -0.5, k_hw)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_bwd.launches == before + 1
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.shape == b.shape and _rel_err(a, b) <= 1e-4
    again = attention.fused_attention_rel_bwd(q, k, v, rel_h, rel_w, out, g, lse, d ** -0.5, k_hw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# K8b (3xTF32, windowed instance): pad windows at the bottom and the right
# (32x32), only at the bottom (32x28), only at the right (28x32), ragged
# both ways (20x27), none (28x28)
@pytest.mark.parametrize("b,hw,heads,d,ws", [(12, (32, 32), 12, 64, 14), (2, (32, 28), 12, 64, 14),
                                             (2, (28, 32), 12, 64, 14), (2, (20, 27), 12, 64, 14),
                                             (2, (28, 28), 12, 64, 14), (1, (32, 32), 16, 80, 14),
                                             (1, (20, 27), 16, 80, 14), (3, (9, 11), 2, 64, 4),
                                             (1, (5, 3), 2, 64, 7)])
def test_k8_backward_matches_plain(cuda, b, hw, heads, d, ws):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(14)
    h, w = hw
    qkv = torch.randn(b, h, w, 3 * heads * d, generator=gen, device=cuda)
    rel_h = torch.randn(b * heads, h, w, ws, generator=gen, device=cuda)
    rel_w = torch.randn(b * heads, h, w, ws, generator=gen, device=cuda)
    bias_kv = 0.5 * torch.randn(3, heads * d, generator=gen, device=cuda)
    g = torch.randn(b, h, w, heads * d, generator=gen, device=cuda)
    out, lse = attention._launch_k8(qkv, rel_h, rel_w, bias_kv, d ** -0.5, ws, heads, with_lse=True)
    before = attention.fused_attention_rel_win_bwd.launches
    got = attention.fused_attention_rel_win_bwd(qkv, rel_h, rel_w, bias_kv, out, g, lse, d ** -0.5,
                                                ws, heads)
    want = attention.attention_rel_win_bwd(qkv, rel_h, rel_w, bias_kv, out, g, d ** -0.5, ws, heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_win_bwd.launches == before + 1
    assert len(got) == len(want) == 4
    for a, b_ in zip(got[:3], want[:3]):
        assert a.shape == b_.shape and _rel_err(a, b_) <= 1e-4
    assert not got[3][0].any()
    if h % ws or w % ws:
        assert _rel_err(got[3], want[3]) <= 1e-4
    else:  # whole windows: no pad slot, dbias_kv exactly zero
        assert not got[3].any() and not want[3].any()
    again = attention._launch_k8_bwd(qkv, rel_h, rel_w, bias_kv, out, g, lse, d ** -0.5, ws, heads)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # no atomics: deterministic


@pytest.mark.parametrize("shape,ws", [((12, 32, 32, 768), 14), ((2, 20, 27, 768), 14),
                                      ((1, 9, 11, 30), 4), ((2, 8, 8, 64), 4)])
@pytest.mark.parametrize("params", [False, True])
def test_k9_backward_matches_plain(cuda, shape, ws, params):
    from mia_tpu_torch.ops import unpartition_residual as upr
    from mia_tpu_torch.ops.ln_window import window_partition

    gen = torch.Generator(device=cuda).manual_seed(15)
    b, h, w, c = shape
    n_win = b * -(-h // ws) * -(-w // ws)
    windows = torch.randn(n_win, ws, ws, c, generator=gen, device=cuda)
    shortcut = torch.randn(shape, generator=gen, device=cuda)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.5 + 0.1 * torch.randn(c, generator=gen, device=cuda)
    x_new, _, mu, rstd = upr._launch_k9(windows, shortcut, scale, bias, ws, 1e-6, with_stats=True)
    dx_new = torch.randn(shape, generator=gen, device=cuda)
    dy = torch.randn(shape, generator=gen, device=cuda)
    before = upr.unpartition_add_ln_fused_bwd.launches
    got = upr.unpartition_add_ln_fused_bwd(x_new, dx_new, dy, mu, rstd, scale, ws, params)
    want = upr.unpartition_add_ln_bwd(x_new, dx_new, dy, mu, rstd, scale, ws, params)
    torch.cuda.synchronize()
    assert upr.unpartition_add_ln_fused_bwd.launches == before + 1
    assert len(got) == len(want) == 4
    for i, (a, b_) in enumerate(zip(got, want)):
        assert (a is None) == (b_ is None) == (i >= 2 and not params)
        if a is not None:
            assert a.shape == b_.shape and _rel_err(a, b_) <= 1e-4
    pad = window_partition(torch.ones(b, h, w, 1, device=cuda), ws)[0] == 0
    assert not got[0][pad.expand_as(got[0])].any()  # zeros at the pad slots


def test_encoder_routes_train_through_their_backward_kernels(cuda):
    """A LoRA-2 encoder of each route on the card: exact forward and backward
    launch counts, the loss and the adapters' gradients within 1e-4 / 1e-3 of
    the default route's."""
    from mia_tpu_torch.models.sam.image_encoder import ImageEncoderViT
    from mia_tpu_torch.ops import attention, ln_window
    from mia_tpu_torch.ops import unpartition_residual as upr

    kw = dict(img_size=320, patch_size=16, embed_dim=128, depth=3, num_heads=2, window_size=7,
              global_attn_indexes=(2,), lora_rank=2)
    torch.manual_seed(0)
    base = ImageEncoderViT(**kw).to(cuda)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if "rel_pos" in name or name == "pos_embed" or "lora_b" in name:
                p.normal_(std=0.1)
    x = torch.randn(2, 320, 320, 3, device=cuda)
    weight = torch.randn(2, 20, 20, 256, device=cuda)
    counters = {"K2b": attention.fused_attention_rel_packed_ik_bwd,
                "K3b": attention.fused_attention_rel_packed_bwd,
                "K4b": ln_window.ln_window_partition_fused_bwd,
                "K6": attention.fused_attention_rel, "K6b": attention.fused_attention_rel_bwd,
                "K7": attention.fused_attention, "K8": attention.fused_attention_rel_win,
                "K8b": attention.fused_attention_rel_win_bwd, "K9": upr.unpartition_add_ln,
                "K9b": upr.unpartition_add_ln_fused_bwd}

    def run(state, **options):
        enc = ImageEncoderViT(**kw, **options).to(cuda)
        enc.load_state_dict({k: v for k, v in state.items()
                             if options.get("use_rel_pos", True) or "rel_pos" not in k})
        lora = {n: p for n, p in enc.named_parameters() if "lora_" in n}
        for n, p in enc.named_parameters():
            p.requires_grad_(n in lora)
        before = {k: c.launches for k, c in counters.items()}
        loss = (enc(x) * weight).mean()
        grads = torch.autograd.grad(loss, list(lora.values()))
        torch.cuda.synchronize()
        seen = {k: c.launches - before[k] for k, c in counters.items() if c.launches != before[k]}
        return loss.item(), dict(zip(lora, grads)), seen

    state = base.state_dict()
    zeroed = {k: torch.zeros_like(v) if "rel_pos" in k else v for k, v in state.items()}
    # block 0's K4 backward is not needed (frozen input and norm), the others' is
    for options, expect in (
            (dict(), dict(K2b=2, K3b=1, K4b=1)),
            (dict(fuse_unpart_residual="always"), dict(K2b=2, K3b=1, K4b=1, K9=2, K9b=2)),
            (dict(fuse_ln_window="never", attn_route="grid_native"), dict(K8=2, K8b=2, K3b=1)),
            (dict(attn_route="head_major"), dict(K6=3, K6b=3, K4b=1)),
            (dict(use_rel_pos=False), dict(K7=3, K4b=1))):
        want_loss, want, _ = run(state if options.get("use_rel_pos", True) else zeroed)
        loss, got, seen = run(state, **options)
        assert seen == expect, options
        assert abs(loss - want_loss) <= 1e-4 * abs(want_loss)
        scale = max(g.abs().max().item() for g in want.values())
        for n, g in got.items():
            assert (g - want[n]).abs().max().item() <= 1e-3 * scale, (options, n)


def test_encoder_routes_launch_their_kernels_and_agree(cuda):
    from mia_tpu_torch.models.sam.image_encoder import ImageEncoderViT
    from mia_tpu_torch.ops import attention, ln_window
    from mia_tpu_torch.ops import unpartition_residual as upr

    kw = dict(img_size=320, patch_size=16, embed_dim=128, depth=3, num_heads=2, window_size=7,
              global_attn_indexes=(2,))  # 20x20 tokens, window 7: pad rows and columns
    torch.manual_seed(0)
    base = ImageEncoderViT(**kw).to(cuda)
    with torch.no_grad():
        for name, p in base.named_parameters():
            if "rel_pos" in name or name == "pos_embed":
                p.normal_(std=0.1)
    x = torch.randn(2, 320, 320, 3, device=cuda)
    counters = {"K2": attention.fused_attention_rel_packed_ik,
                "K3": attention.fused_attention_rel_packed, "K4": ln_window.ln_window_partition_fused,
                "K6": attention.fused_attention_rel, "K8": attention.fused_attention_rel_win,
                "K9": upr.unpartition_add_ln}
    # float32 convolutions, as chip_smoke.py compares the routes: the routes
    # differ in their last bits (their attention kernels and LayerNorms sum in
    # other orders), and the neck's TF32 convolutions round that up to ~1e-4
    # of the embedding (1.03e-4 for grid-native on an H100)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = base(x)
        for options, expect in (
                (dict(fuse_unpart_residual="always"), dict(K2=2, K3=1, K4=2, K9=2)),
                (dict(fuse_ln_window="never", attn_route="grid_native"), dict(K8=2, K3=1)),
                (dict(attn_route="head_major"), dict(K6=3, K4=2))):
            enc = ImageEncoderViT(**kw, **options).to(cuda)
            enc.load_state_dict(base.state_dict())
            before = {k: c.launches for k, c in counters.items()}
            with torch.no_grad():
                got = enc(x)
            torch.cuda.synchronize()
            assert {k: c.launches - before[k] for k, c in counters.items()} == {
                k: expect.get(k, 0) for k in counters}
            assert _rel_err(got, want) <= 1e-4
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


# K10 / K10b: the k2/s2 transposed convolution and its backward against their
# plain versions (forward 1e-5, dx/dw/db 1e-4 of max |plain|; float32, another
# summation order), two backward launches bit-identical.
@pytest.mark.parametrize("shape", [(12, 32, 32, 256, 64), (12, 128, 128, 32, 16),
                                   (1, 64, 64, 64, 32), (4, 16, 16, 512, 256),
                                   (2, 5, 12, 16, 16), (3, 7, 3, 48, 20), (2, 4, 12, 16, 16)])
def test_k10_and_k10b_match_plain(cuda, shape):
    from mia_tpu_torch.ops import upsample2x as up

    b, h, w, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(b, h, w, cin, generator=gen, device=cuda)
    wt = torch.randn(2, 2, cin, cout, generator=gen, device=cuda) * cin ** -0.5
    bias = torch.randn(cout, generator=gen, device=cuda)
    dy = torch.randn(b, 2 * h, 2 * w, cout, generator=gen, device=cuda)
    before = (up.conv_transpose2x.launches, up.conv_transpose2x_fused_bwd.launches)
    got = up.conv_transpose2x(x, wt, bias)
    first = up.conv_transpose2x_fused_bwd(x, wt, dy)
    again = up.conv_transpose2x_fused_bwd(x, wt, dy)
    torch.cuda.synchronize()
    assert (up.conv_transpose2x.launches, up.conv_transpose2x_fused_bwd.launches) == (
        before[0] + 1, before[1] + 2)
    assert _rel_err(got, up.conv_transpose2x_plain(x, wt, bias)) <= 1e-5
    for g, want in zip(first, up.conv_transpose2x_bwd_plain(x, wt, dy)):
        assert g.shape == want.shape and _rel_err(g, want) <= 1e-4
    assert all(torch.equal(a, c) for a, c in zip(first, again))


def test_k10_gradients_run_through_k10b_and_the_module_option(cuda):
    from mia_tpu_torch.models import EinsumConvTranspose2x
    from mia_tpu_torch.ops import upsample2x as up

    torch.manual_seed(11)
    plain = EinsumConvTranspose2x(64, 32).to(cuda)
    fused = EinsumConvTranspose2x(64, 32, use_kernel="always").to(cuda)
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(3, 20, 27, 64, device=cuda)
    g = torch.randn(3, 40, 54, 32, device=cuda)
    before = (up.conv_transpose2x.launches, up.conv_transpose2x_fused_bwd.launches)
    outs = {}
    for name, mod in (("plain", plain), ("fused", fused)):
        xi = x.clone().requires_grad_()
        y = mod(xi)
        outs[name] = (y, *torch.autograd.grad(y, [xi, mod.weight, mod.bias], g))
    torch.cuda.synchronize()
    assert (up.conv_transpose2x.launches, up.conv_transpose2x_fused_bwd.launches) == (
        before[0] + 1, before[1] + 1)  # the default option launches nothing
    assert _rel_err(outs["fused"][0], outs["plain"][0]) <= 1e-5
    for a, c in zip(outs["fused"][1:], outs["plain"][1:]):
        assert a.shape == c.shape and _rel_err(a, c) <= 1e-4
    # frozen weights: dx only, still one backward launch
    xi = x.clone().requires_grad_()
    for p in fused.parameters():
        p.requires_grad_(False)
    torch.autograd.grad(fused(xi), xi, g)
    assert up.conv_transpose2x_fused_bwd.launches == before[1] + 2


def test_k10_rejects_what_it_does_not_take(cuda):
    from mia_tpu_torch.ops import upsample2x as up

    x = torch.rand(1, 4, 4, 8, device=cuda)
    w, b = torch.rand(2, 2, 8, 4, device=cuda), torch.rand(4, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        up.conv_transpose2x(x.double(), w.double(), b.double())
    with pytest.raises(ValueError, match="multiples of 4"):
        up.conv_transpose2x(torch.rand(1, 4, 4, 6, device=cuda), torch.rand(2, 2, 6, 4, device=cuda), b)
    with pytest.raises(ValueError, match="w \\(2, 2, Cin, Cout\\)"):
        up.conv_transpose2x(x, torch.rand(2, 2, 4, 4, device=cuda), b)
    with pytest.raises(ValueError, match="b must be"):
        up.conv_transpose2x(x, w, torch.rand(8, device=cuda))


def _tc_route(product, pixels, cin, cout):
    """The dispatch rule of csrc/upsample2x.cu: a product (M x N over K)
    takes the tensor cores when its float32 time is set by operations, 2MNK
    at 67 TFLOP/s against its operands and result once at 3.35 TB/s."""
    m, n, k = {"forward": (pixels, 4 * cout, cin), "dx": (pixels, cin, 4 * cout),
               "dw": (cin, 4 * cout, pixels)}[product]
    return 2 * m * n * k >= 20 * 4 * (m * k + k * n + m * n)


def _expected_routes(shape):
    b, h, w, cin, cout = shape
    return {p: "tensor cores" if _tc_route(p, b * h * w, cin, cout) else "cuda cores"
            for p in ("forward", "dx", "dw")}


# Shapes at the edges of the tiles, on both routes: pixels not a multiple of
# 128, Cin 20, 48 and 520, Cout 20 (4·Cout = 80), one dw chunk and many.
@pytest.mark.parametrize("shape,route", [((1, 12, 13, 520, 20), "tensor cores"),
                                         ((6, 21, 22, 256, 64), "tensor cores"),
                                         ((2, 16, 16, 256, 20), "tensor cores"),
                                         ((4, 16, 16, 48, 512), "tensor cores"),
                                         ((4, 20, 27, 48, 64), "cuda cores"),
                                         ((3, 5, 7, 20, 20), "cuda cores")])
def test_k10_and_k10b_at_tile_edges(cuda, shape, route):
    from mia_tpu_torch.ops import upsample2x as up

    b, h, w, cin, cout = shape
    assert up.k10_routes((b, h, w, cin), cout) == {p: route for p in up.PRODUCTS}
    gen = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn(b, h, w, cin, generator=gen, device=cuda).clamp_min(0.0)
    wt = torch.randn(2, 2, cin, cout, generator=gen, device=cuda) * cin ** -0.5
    bias = torch.randn(cout, generator=gen, device=cuda)
    dy = torch.randn(b, 2 * h, 2 * w, cout, generator=gen, device=cuda)
    got = up.conv_transpose2x(x, wt, bias)
    first = up.conv_transpose2x_fused_bwd(x, wt, dy)
    torch.cuda.synchronize()
    assert _rel_err(got, up.conv_transpose2x_plain(x, wt, bias)) <= 1e-5
    for g, want in zip(first, up.conv_transpose2x_bwd_plain(x, wt, dy)):
        assert g.shape == want.shape and _rel_err(g, want) <= 1e-4


@pytest.mark.parametrize("shape", [(1, 12, 13, 520, 20), (6, 21, 22, 256, 64),
                                   (12, 16, 16, 512, 256), (4, 20, 27, 48, 64)])
def test_k10b_is_bit_identical_and_dx_alone_equals_the_full_backward(cuda, shape):
    from mia_tpu_torch.ops import upsample2x as up

    b, h, w, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(b, h, w, cin, generator=gen, device=cuda)
    wt = torch.randn(2, 2, cin, cout, generator=gen, device=cuda) * cin ** -0.5
    dy = torch.randn(b, 2 * h, 2 * w, cout, generator=gen, device=cuda)
    first = up.conv_transpose2x_fused_bwd(x, wt, dy)
    again = up.conv_transpose2x_fused_bwd(x, wt, dy)
    only_dx = up.conv_transpose2x_fused_bwd(x, wt, dy, need_dw=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, again))
    assert only_dx[1] is None and only_dx[2] is None and torch.equal(only_dx[0], first[0])


def test_k10_stages_take_the_route_the_dispatch_rule_names(cuda):
    import chip_smoke
    from mia_tpu_torch.ops import upsample2x as up

    taken = {label: up.k10_routes((b, h, w, cin), cout)
             for label, (b, h, w, cin, cout), _ in chip_smoke.UPSAMPLE_STAGES}
    want = {label: _expected_routes(shape) for label, shape, _ in chip_smoke.UPSAMPLE_STAGES}
    assert taken == want
    # the wide stages are bound by operations and take the tensor cores
    for label in ("UNet 1", "UNet 2", "UNet 3", "UNet 4", "prompt-large 1", "SAM 1"):
        assert set(taken[label].values()) == {"tensor cores"}, label


def test_hd_evaluates_on_the_card(cuda, monkeypatch):
    from mia_tpu_torch.metrics import HD, hd_module

    devices = []

    def recording(a, b, spacing=None):
        devices.append((a.device.type, b.device.type))
        return surface_distance_stats(a, b, spacing)

    surface_distance_stats = hd_module.surface_distance_stats
    monkeypatch.setattr(hd_module, "surface_distance_stats", recording)
    yy, xx = torch.meshgrid(torch.arange(40), torch.arange(48), indexing="ij")
    pred = torch.zeros(40, 48, dtype=torch.int64)
    label = torch.zeros(40, 48, dtype=torch.int64)
    pred[((yy - 15) / 6) ** 2 + ((xx - 20) / 8) ** 2 <= 1] = 1
    pred[((yy - 26) / 6) ** 2 + ((xx - 28) / 8) ** 2 <= 1] = 2
    label[((yy - 17) / 6) ** 2 + ((xx - 19) / 8) ** 2 <= 1] = 1
    label[((yy - 25) / 6) ** 2 + ((xx - 30) / 8) ** 2 <= 1] = 2
    logits = torch.eye(3)[pred][None]
    want = HD()(logits, label[None])
    devices.clear()
    got = HD()(logits.to(cuda), label[None].to(cuda))
    assert devices == [("cuda", "cuda")] * 3
    assert got == pytest.approx(want, rel=1e-6)


def test_residual_unet_strided_skip_on_the_card_matches_the_cpu(cuda):
    from mia_tpu_torch.models import UNet, UNetConfig

    torch.manual_seed(0)
    cfg = UNetConfig(in_channels=1, out_classes=3, channels_list=(8, 16, 32), block_type="res",
                     normalization="instance", dropout_prob=0.0)
    cpu_model = UNet(cfg)
    card_model = UNet(cfg).to(cuda)
    card_model.load_state_dict(cpu_model.state_dict())
    x = torch.rand(2, 32, 32, 1, generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = False
        got = card_model(x.to(cuda))
        got.square().mean().backward()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    want = cpu_model(x)
    want.square().mean().backward()
    assert (got.detach().cpu() - want.detach()).abs().max() <= 1e-5 * want.abs().max()
    # A conv bias that feeds a norm has a true gradient of zero: both sides are
    # float noise, held against the model's largest gradient, not their own.
    norm_fed = _norm_fed_biases(cpu_model)
    assert "encoder.levels.0.0.all.0.bias" in norm_fed
    largest = max(p.grad.abs().max().item() for p in cpu_model.parameters())
    for (name, p), q in zip(cpu_model.named_parameters(), card_model.parameters()):
        if name in norm_fed:
            assert q.grad.abs().max() <= 1e-4 * largest, name
            assert p.grad.abs().max() <= 1e-4 * largest, name
            continue
        scale = max(p.grad.abs().max().item(), 1e-12)
        assert (q.grad.cpu() - p.grad).abs().max() <= 1e-4 * scale, name


def _norm_fed_biases(model):
    """Names of the conv biases whose output goes (through dropout only) into a norm."""
    from torch import nn

    from mia_tpu_torch.models.unet import ChannelDropout

    norms = (nn.modules.batchnorm._BatchNorm, nn.modules.instancenorm._InstanceNorm)
    found = set()
    for prefix, module in model.named_modules():
        if not isinstance(module, (nn.ModuleList, nn.Sequential)):
            continue
        children = list(module)
        for i, child in enumerate(children):
            if not isinstance(child, nn.modules.conv._ConvNd) or child.bias is None:
                continue
            rest = [c for c in children[i + 1:] if not isinstance(c, (ChannelDropout, nn.Dropout))]
            if rest and isinstance(rest[0], norms):
                found.add(f"{prefix}.{i}.bias")
    return found


# --- the bfloat16 instances of the encoder's other routes: K6/K6b, K7, K8/K8b, K9/K9b ---

BF16_TOL = 2.0 ** -7  # max |kernel - plain| over max |plain| (the forwards: beside the ulp measure)


def _fwd_ulps():
    """The bfloat16 forwards' limit (``chip_smoke.BF16_FWD_ULPS``): they round
    the normalised p where the Pallas kernels and the plain versions round
    it, each element within the CPU tile model's own distance to the plain
    version plus one ulp (the ulp taken at no less than 2^-6 of max |plain|),
    with at least 99% of the elements bit-equal."""
    import chip_smoke

    return chip_smoke.BF16_FWD_ULPS


def _bf16_close(label, got, want):
    torch.cuda.synchronize()
    assert got.dtype == want.dtype and got.shape == want.shape, label
    assert bool(torch.isfinite(got.float()).all()), label
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    assert err <= BF16_TOL * ref, (label, err, ref)


def _bf16_ulps(label, got, want, max_ulps=None, min_equal=0.99):
    """Every element within ``max_ulps`` bfloat16 ulps of the plain version's
    (the ulp taken at no less than 2^-6 of max |plain|) and ``min_equal`` of
    them bit-equal; returns (ulps, share bit-equal). None: the forwards'
    limit, and the forwards' output within ``BF16_TOL`` of max |plain| too."""
    import chip_smoke

    if max_ulps is None:
        _bf16_close(label, got, want)
        max_ulps = _fwd_ulps()
    torch.cuda.synchronize()
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, label
    assert bool(torch.isfinite(got.float()).all()), label
    ulps, equal = chip_smoke.bf16_ulps(torch, got, want)
    assert ulps <= max_ulps and equal >= min_equal, (label, ulps, equal)
    return ulps, equal


@pytest.mark.parametrize("bh,d,k_hw", [(108, 64, (14, 14)), (12, 64, (32, 32)), (6, 64, (10, 12)),
                                       (4, 80, (5, 7))])
def test_bf16_k6_and_k6b_match_plain(cuda, bh, d, k_hw):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(11)
    n = k_hw[0] * k_hw[1]

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    fwd = (randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, k_hw[0]),
           randn(bh, n, k_hw[1]))
    scale = d ** -0.5
    out, lse = attention._launch_k6(*fwd, scale, k_hw, with_lse=True)
    want, want_lse = attention.attention_rel_bf16(*fwd, scale, k_hw)
    _bf16_ulps("K6", out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    assert torch.equal(out, attention._launch_k6(*fwd, scale, k_hw))
    g = randn(bh, n, d)
    got = attention._launch_k6_bwd(*fwd, out, g, lse, scale, k_hw)
    plain = attention.attention_rel_bwd_bf16(*fwd, out, g, lse, scale, k_hw)
    for name, a, b in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, plain):
        _bf16_close(f"K6b {name}", a, b)
    again = attention._launch_k6_bwd(*fwd, out, g, lse, scale, k_hw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert attention.fused_attention_rel.bf16_launches > 0


# --- K3b and K6b in bfloat16: the warpgroup instance (csrc/attention_bwd_wgmma.cuh) at head
# dim 64, today's mma.sync instance at head dim 80 ---

BWD_SHAPES = {"global": (12, 12, 64, (32, 32)), "windows": (108, 12, 64, (14, 14)),
              "ragged": (2, 12, 64, (20, 27)), "head dim 80": (1, 16, 80, (32, 32))}


def _bf16_randn(gen, cuda):
    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)

    return randn


@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_bf16_k3b_matches_plain_and_repeats_bit_for_bit(cuda, shape):
    from mia_tpu_torch.ops import attention

    b, heads, d, k_hw = BWD_SHAPES[shape]
    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(21), cuda)
    n = k_hw[0] * k_hw[1]
    qkv = randn(b, n, 3 * heads * d)
    rel_h, rel_w = randn(b * heads, n, k_hw[0]), randn(b * heads, n, k_hw[1])
    scale = d ** -0.5
    out, lse = attention._launch_k3(qkv, rel_h, rel_w, scale, k_hw, heads, with_lse=True)
    args = (qkv, rel_h, rel_w, out, randn(b, n, heads * d), lse, scale, k_hw, heads)
    counts = (attention.fused_attention_rel_packed_bwd.launches,
              attention.fused_attention_rel_packed_bwd.bf16_launches)
    got = attention.fused_attention_rel_packed_bwd(*args)
    plain = attention.attention_rel_packed_bwd_bf16(*args)
    for name, a, w in zip(("dqkv", "drel_h", "drel_w"), got, plain):
        _bf16_close(f"K3b {shape} {name}", a, w)
    again = attention.fused_attention_rel_packed_bwd(*args)
    assert all(torch.equal(a, w) for a, w in zip(got, again))
    assert (attention.fused_attention_rel_packed_bwd.launches,
            attention.fused_attention_rel_packed_bwd.bf16_launches) == (counts[0], counts[1] + 2)


@pytest.mark.parametrize("shape", list(BWD_SHAPES))
def test_bf16_k6b_matches_plain_and_repeats_bit_for_bit(cuda, shape):
    from mia_tpu_torch.ops import attention

    b, heads, d, k_hw = BWD_SHAPES[shape]
    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(22), cuda)
    bh, n = b * heads, k_hw[0] * k_hw[1]
    fwd = (randn(bh, n, d), randn(bh, n, d), randn(bh, n, d), randn(bh, n, k_hw[0]),
           randn(bh, n, k_hw[1]))
    scale = d ** -0.5
    out, lse = attention._launch_k6(*fwd, scale, k_hw, with_lse=True)
    args = (*fwd, out, randn(bh, n, d), lse, scale, k_hw)
    counts = (attention.fused_attention_rel_bwd.launches,
              attention.fused_attention_rel_bwd.bf16_launches)
    got = attention.fused_attention_rel_bwd(*args)
    plain = attention.attention_rel_bwd_bf16(*args)
    for name, a, w in zip(("dq", "dk", "dv", "drel_h", "drel_w"), got, plain):
        _bf16_close(f"K6b {shape} {name}", a, w)
    again = attention.fused_attention_rel_bwd(*args)
    assert all(torch.equal(a, w) for a, w in zip(got, again))
    assert (attention.fused_attention_rel_bwd.launches,
            attention.fused_attention_rel_bwd.bf16_launches) == (counts[0], counts[1] + 2)


def _device_kernels(fn):
    """Names of the device kernels one call of ``fn`` runs, under the profiler
    (a capture that records none is taken again, at most twice)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            return names
    return names


def test_bf16_backward_instances_by_kernel_and_head_dim(cuda):
    """K3b, K6b and K8b at head dim 64 run the warpgroup kernels (K8b their
    window instance, then the pad reduce); K3b and K8b at head dim 80 and K2b
    keep the mma.sync instance of attention_bwd_tc.cuh."""
    from mia_tpu_torch.ops import attention

    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(23), cuda)

    def k3b(d, heads, k_hw):
        n = k_hw[0] * k_hw[1]
        qkv = randn(2, n, 3 * heads * d)
        rel_h, rel_w = randn(2 * heads, n, k_hw[0]), randn(2 * heads, n, k_hw[1])
        out, lse = attention._launch_k3(qkv, rel_h, rel_w, d ** -0.5, k_hw, heads, with_lse=True)
        g = randn(2, n, heads * d)
        return lambda: attention._launch_k3_bwd(qkv, rel_h, rel_w, out, g, lse, d ** -0.5, k_hw,
                                                heads)

    n, d = 196, 64
    fwd = (randn(24, n, d), randn(24, n, d), randn(24, n, d), randn(24, n, 14), randn(24, n, 14))
    out, lse = attention._launch_k6(*fwd, d ** -0.5, (14, 14), with_lse=True)
    g6 = randn(24, n, d)
    ws = 14
    tables = (randn(ws * ws, d), randn(ws * ws, d))
    qkv2 = randn(4, ws * ws, 3 * 2 * d)
    out2, lse2 = attention._launch_k2(qkv2, *tables, d ** -0.5, (ws, ws), 2, with_lse=True)
    g2 = randn(4, ws * ws, 2 * d)
    grid = (randn(1, 20, 27, 3 * 2 * d), randn(2, 20, 27, ws), randn(2, 20, 27, ws),
            randn(3, 2 * d))
    out8, lse8 = attention._launch_k8(*grid, d ** -0.5, ws, 2, with_lse=True)
    g8 = randn(1, 20, 27, 2 * d)
    grid80 = (randn(1, 20, 27, 3 * 2 * 80), randn(2, 20, 27, ws), randn(2, 20, 27, ws),
              randn(3, 2 * 80))
    out80, lse80 = attention._launch_k8(*grid80, 80 ** -0.5, ws, 2, with_lse=True)
    g80 = randn(1, 20, 27, 2 * 80)
    cases = {
        "K3b 64": (k3b(64, 2, (32, 32)), "attention_bwd_wgmma_"),
        "K6b 64": (lambda: attention._launch_k6_bwd(*fwd, out, g6, lse, d ** -0.5, (14, 14)),
                   "attention_bwd_wgmma_"),
        "K3b 80": (k3b(80, 2, (14, 14)), "attention_bwd_bf16_dq_kernel<80, false, false>"),
        "K2b": (lambda: attention._launch_k2_bwd(qkv2, *tables, out2, g2, lse2, d ** -0.5,
                                                 (ws, ws), 2),
                "attention_bwd_bf16_dq_kernel<64, true, false>"),
        "K8b 64": (lambda: attention._launch_k8_bwd(*grid, out8, g8, lse8, d ** -0.5, ws, 2),
                   "attention_bwd_wgmma_win_"),
        "K8b 80": (lambda: attention._launch_k8_bwd(*grid80, out80, g80, lse80, 80 ** -0.5, ws,
                                                    2),
                   "attention_bwd_bf16_dq_kernel<80, false, true>"),
    }
    for label, (fn, want) in cases.items():
        names = _device_kernels(fn)
        assert any(want in name for name in names), (label, names)
        if not want.startswith("attention_bwd_wgmma_"):
            assert not any("wgmma" in name for name in names), (label, names)
        if label.startswith("K8b"):  # passes A and B, then the pad reduce: three kernels
            assert len(names) == 3, (label, names)
            assert any("attention_bwd_pad_reduce_kernel" in name for name in names), (label, names)
        if label == "K8b 64":
            assert not any("attention_bwd_bf16_" in name for name in names), (label, names)
    from mia_tpu_torch.ops.cuda_build import load_library

    takes = load_library().mia_attention_rel_win_bwd_wgmma_takes
    assert takes(64, 14) and takes(64, 7) and not takes(80, 14) and not takes(64, 15)


# --- K3 and K6 forward in bfloat16: the warpgroup kernel (csrc/attention_fwd_wgmma.cuh) at head
# dim 64 with kh + kw <= 64, the mma.sync instance's statistics pass at head dim 80 and on the
# 64 x 64 grid; every one rounds the normalised p ---

# (batch, heads, head dim, key grid); K6 takes the same operands head-major
FWD_SHAPES = {"B=1": (1, 12, 64, (32, 32)), "B=8": (8, 12, 64, (32, 32)),
              "windows": (9, 12, 64, (14, 14)), "ragged": (2, 12, 64, (20, 27)),
              "head dim 80": (1, 16, 80, (32, 32)), "64x64": (1, 12, 64, (64, 64))}


def _fwd_operands(shape, cuda, seed):
    """K3's packed operands and K6's head-major ones (the same values)."""
    b, heads, d, k_hw = FWD_SHAPES[shape]
    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(seed), cuda)
    n = k_hw[0] * k_hw[1]
    qkv = randn(b, n, 3 * heads * d)
    rel_h, rel_w = randn(b * heads, n, k_hw[0]), randn(b * heads, n, k_hw[1])
    q, k, v = (t.reshape(b * heads, n, d).contiguous()
               for t in qkv.view(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    return ((qkv, rel_h, rel_w, d ** -0.5, k_hw, heads),
            (q, k, v, rel_h, rel_w, d ** -0.5, k_hw))


@pytest.mark.parametrize("kernel", ["K3", "K6"])
@pytest.mark.parametrize("shape", list(FWD_SHAPES))
def test_bf16_k3_and_k6_forward_hold_at_the_ulp_measure(cuda, kernel, shape):
    from mia_tpu_torch.ops import attention

    k3_args, k6_args = _fwd_operands(shape, cuda, seed=31)
    if kernel == "K3":
        args, launch, plain = k3_args, attention._launch_k3, attention.attention_rel_packed_bf16
        wrapper = attention.fused_attention_rel_packed
    else:
        args, launch, plain = k6_args, attention._launch_k6, attention.attention_rel_bf16
        wrapper = attention.fused_attention_rel
    counts = wrapper.launches, wrapper.bf16_launches
    out, lse = launch(*args, with_lse=True)
    want, want_lse = plain(*args)
    _bf16_ulps(f"{kernel} {shape}", out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-5, (kernel, shape)
    again, lse_again = launch(*args, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again), (kernel, shape)
    assert torch.equal(launch(*args), out)  # without the lse: the same output
    assert (wrapper.launches, wrapper.bf16_launches) == (counts[0], counts[1] + 3)


def test_bf16_forward_instances_follow_the_takes_rule(cuda):
    """Each K3 and K6 shape runs the instance that
    mia_attention_rel_fwd_wgmma_takes names: the warpgroup kernel at head dim
    64 with kh + kw <= 64, attention_fwd_bf16_kernel<D, 1, 64> otherwise."""
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops.cuda_build import load_library

    takes = load_library().mia_attention_rel_fwd_wgmma_takes
    for shape, (_, _, d, k_hw) in FWD_SHAPES.items():
        k3_args, k6_args = _fwd_operands(shape, cuda, seed=32)
        wgmma = bool(takes(d, *k_hw))
        assert wgmma == (d == 64 and sum(k_hw) <= 64), shape
        want = "attention_fwd_wgmma_kernel" if wgmma else f"attention_fwd_bf16_kernel<{d}, 1, 64>"
        for label, fn in (("K3", lambda: attention._launch_k3(*k3_args)),
                          ("K6", lambda: attention._launch_k6(*k6_args))):
            names = _device_kernels(fn)
            assert any(want in name for name in names), (label, shape, names)
            other = "attention_fwd_bf16_kernel" if wgmma else "attention_fwd_wgmma_kernel"
            assert not any(other in name for name in names), (label, shape, names)


@pytest.mark.parametrize("b,heads,d,ws", [(9, 12, 64, 14), (72, 12, 64, 14), (5, 4, 64, 9),
                                          (9, 16, 80, 14)])
def test_bf16_k2_holds_at_the_ulp_measure_on_its_own_rel_terms(cuda, b, heads, d, ws):
    """K2 against the plain bfloat16 K3 fed kernel R's terms (a term may
    round one ulp apart from the plain version's, which moves its scores by
    that ulp): the warpgroup forward at head dim 64 forms them in kernel R's
    order, so its log-sum-exp is the plain one of kernel R's terms too."""
    import chip_smoke
    from mia_tpu_torch.ops import attention

    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(33), cuda)
    n = ws * ws
    qkv, rh, rw = randn(b, n, 3 * heads * d), randn(n, d), randn(n, d)
    rh, rw = 0.1 * rh, 0.1 * rw
    scale = d ** -0.5
    out, lse = attention._launch_k2(qkv, rh, rw, scale, (ws, ws), heads, with_lse=True)
    terms = chip_smoke.kernel_r_terms(torch, qkv, rh, rw, out, lse, scale, (ws, ws), heads)
    rel_h, rel_w = (t.contiguous() for t in terms.split([ws, ws], -1))
    want, want_lse = attention.attention_rel_packed_bf16(qkv, rel_h, rel_w, scale, (ws, ws), heads)
    _bf16_ulps("K2", out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    again, lse_again = attention._launch_k2(qkv, rh, rw, scale, (ws, ws), heads, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)


def test_bf16_k2_and_k7_instances_follow_their_takes_rules(cuda):
    """K2 at head dim 64 on 14 x 14 windows is one launch of the warpgroup
    window kernel (no kernel R); at head dim 80 kernel R, then the mma.sync
    instance. K7 at head dim 64 runs the window kernel at N = 196, the
    two-walk warpgroup kernel at N = 1024, and the mma.sync instance at
    N = 35 (N % 4 != 0) and at head dim 80."""
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops.cuda_build import load_library

    lib = load_library()
    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(34), cuda)
    for d, heads, want in ((64, 12, ["attention_fwd_wgmma_window_kernel<0>"]),
                           (80, 16, ["attention_rel_terms_kernel",
                                     "attention_fwd_bf16_kernel<80, 0, 64>"])):
        assert bool(lib.mia_attention_rel_ik_fwd_wgmma_takes(d, 196, 14, 14)) == (d == 64)
        args = (randn(9, 196, 3 * heads * d), 0.1 * randn(196, d), 0.1 * randn(196, d),
                d ** -0.5, (14, 14), heads)
        names = _device_kernels(lambda: attention._launch_k2(*args))
        assert len(names) == len(want), (d, names)
        for w in want:
            assert any(w in name for name in names), (d, w, names)
    for bh, d, n, want in ((108, 64, 196, "attention_fwd_wgmma_window_kernel<2>"),
                           (12, 64, 1024, "attention_fwd_wgmma_kernel<64, true>"),
                           (4, 64, 35, "attention_fwd_bf16_kernel<64, 2, 64>"),
                           (16, 80, 196, "attention_fwd_bf16_kernel<80, 2, 64>")):
        assert bool(lib.mia_attention_dense_fwd_wgmma_takes(d, n)) == (d == 64 and n % 4 == 0)
        q, k, v = (randn(bh, n, d) for _ in range(3))
        bias = torch.randn(bh, n, n, device=cuda)
        names = _device_kernels(lambda: attention._launch_k7(q, k, v, bias, d ** -0.5))
        assert len(names) == 1 and want in next(iter(names)), (bh, d, n, names)


def test_bf16_k8_instance_follows_its_takes_rule(cuda):
    """K8 at head dim 64 on 14 x 14 windows is one launch of the warpgroup
    window kernel, on a grid that pads both ways too; at head dim 80 the
    mma.sync instance attention_fwd_bf16_kernel<80, 3, 64>."""
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops.cuda_build import load_library

    takes = load_library().mia_attention_rel_win_fwd_wgmma_takes
    randn = _bf16_randn(torch.Generator(device=cuda).manual_seed(35), cuda)
    ws = 14
    for d, heads, hw, want in ((64, 12, (32, 32), "attention_fwd_wgmma_window_kernel<3>"),
                               (64, 12, (20, 27), "attention_fwd_wgmma_window_kernel<3>"),
                               (80, 16, (32, 32), "attention_fwd_bf16_kernel<80, 3, 64>")):
        assert bool(takes(d, ws)) == (d == 64), d
        args = (randn(1, *hw, 3 * heads * d), randn(heads, *hw, ws), randn(heads, *hw, ws),
                randn(3, heads * d), d ** -0.5, ws, heads)
        names = _device_kernels(lambda: attention._launch_k8(*args))
        assert len(names) == 1 and want in next(iter(names)), (d, hw, names)
    assert not takes(64, 15) and not takes(64, 0) and takes(64, 7)


@pytest.mark.parametrize("bh,d,n", [(108, 64, 196), (12, 64, 1024), (4, 64, 35), (16, 80, 196)])
def test_bf16_k7_matches_plain(cuda, bh, d, n):
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn(bh, n, d, generator=gen, device=cuda).to(torch.bfloat16)
               for _ in range(3))
    bias = torch.randn(bh, n, n, generator=gen, device=cuda)
    bias[:, ::2, :min(64, n // 2)] = -float("inf")  # every row keeps a finite key
    got = attention._launch_k7(q, k, v, bias, d ** -0.5)
    _bf16_ulps("K7", got, attention.attention_dense_bf16(q, k, v, bias, d ** -0.5))
    assert torch.equal(got, attention._launch_k7(q, k, v, bias, d ** -0.5))


@pytest.mark.parametrize("b,hw,heads,d", [(1, (32, 32), 12, 64), (8, (32, 32), 12, 64),
                                          (12, (32, 32), 12, 64), (2, (20, 27), 12, 64),
                                          (2, (28, 28), 12, 64), (1, (32, 32), 16, 80)])
def test_bf16_k8_and_k8b_match_plain(cuda, b, hw, heads, d):
    """K8 at the forwards' ulp measure, at least 99.5% bit-equal, its lse
    within 1e-5 and two launches bit-identical (head dim 64: the warpgroup
    window kernel; 80: the mma.sync instance); K8b on that lse against its
    plain VJP (head dim 64: the warpgroup window passes; 80: the mma.sync
    instance), two launches bit-identical, dbias_kv's row 0 zero. 32 x 32
    pads the edge windows, 20 x 27 both ways at odd widths, 28 x 28 has no
    pad slot (dbias_kv zero)."""
    from mia_tpu_torch.ops import attention

    gen = torch.Generator(device=cuda).manual_seed(13)
    ws = 14

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)).to(torch.bfloat16)

    fwd = (randn(b, *hw, 3 * heads * d), randn(b * heads, *hw, ws), randn(b * heads, *hw, ws),
           randn(3, heads * d, scale=0.5))
    scale = d ** -0.5
    out, lse = attention._launch_k8(*fwd, scale, ws, heads, with_lse=True)
    want, want_lse = attention.attention_rel_win_bf16(*fwd, scale, ws, heads)
    _bf16_ulps("K8", out, want, min_equal=0.995)
    assert (lse - want_lse).abs().max().item() <= 1e-5
    again, lse_again = attention._launch_k8(*fwd, scale, ws, heads, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, lse_again)
    g = randn(b, *hw, heads * d)
    got = attention._launch_k8_bwd(*fwd, out, g, lse, scale, ws, heads)
    plain = attention.attention_rel_win_bwd_bf16(*fwd, out, g, lse, scale, ws, heads)
    for name, a, p in zip(("dqkv", "drel_h", "drel_w"), got, plain):
        _bf16_close(f"K8b {name}", a, p)
    if hw[0] % ws or hw[1] % ws:
        _bf16_close("K8b dbias_kv", got[3], plain[3])
        assert got[3][1:].any()
    else:
        assert not got[3].any()
    assert not got[3][0].any()
    again = attention._launch_k8_bwd(*fwd, out, g, lse, scale, ws, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(a, p) for a, p in zip(got, again))


@pytest.mark.parametrize("ws,hw", [(7, (20, 27)), (9, (18, 22))])
def test_bf16_k8b_window_instance_at_odd_window_sizes(cuda, ws, hw):
    """The warpgroup window instance at head dim 64 on odd windows (its rel
    rows by plain loads, one 64-slot tile or two), pad slots on both edges:
    within the bfloat16 measure of the plain VJP, dbias_kv's row 0 zero, two
    launches bit-identical."""
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops.cuda_build import load_library

    assert load_library().mia_attention_rel_win_bwd_wgmma_takes(64, ws)
    gen = torch.Generator(device=cuda).manual_seed(20)
    heads, d = 4, 64

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=cuda)).to(torch.bfloat16)

    fwd = (randn(2, *hw, 3 * heads * d), randn(2 * heads, *hw, ws), randn(2 * heads, *hw, ws),
           randn(3, heads * d, scale=0.5))
    out, lse = attention._launch_k8(*fwd, d ** -0.5, ws, heads, with_lse=True)
    g = randn(2, *hw, heads * d)
    got = attention._launch_k8_bwd(*fwd, out, g, lse, d ** -0.5, ws, heads)
    plain = attention.attention_rel_win_bwd_bf16(*fwd, out, g, lse, d ** -0.5, ws, heads)
    for name, a, p in zip(("dqkv", "drel_h", "drel_w", "dbias_kv"), got, plain):
        _bf16_close(f"K8b ws {ws} {name}", a, p)
    assert not got[3][0].any() and got[3][1:].any()
    again = attention._launch_k8_bwd(*fwd, out, g, lse, d ** -0.5, ws, heads)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(got, again))


@pytest.mark.parametrize("shape", [(1, 32, 32, 768), (2, 20, 27, 768)])
def test_bf16_k9_and_k9b_match_plain(cuda, shape):
    from mia_tpu_torch.ops import unpartition_residual as upr

    gen = torch.Generator(device=cuda).manual_seed(14)
    ws, c = 14, shape[-1]
    n_win = shape[0] * -(-shape[1] // ws) * -(-shape[2] // ws)
    windows = torch.randn(n_win, ws, ws, c, generator=gen, device=cuda).to(torch.bfloat16)
    shortcut = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    scale = 1.0 + 0.2 * torch.randn(c, generator=gen, device=cuda)
    bias = 0.1 * torch.randn(c, generator=gen, device=cuda)
    x_new, y, mu, rstd = upr._launch_k9(windows, shortcut, scale, bias, ws, with_stats=True)
    want_x, want_y = upr.unpartition_add_ln_plain(windows, shortcut, scale, bias, ws)
    torch.cuda.synchronize()
    assert torch.equal(x_new, want_x)
    _bf16_close("K9", y, want_y)
    dx_new = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    dy = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    got = upr._launch_k9_bwd(x_new, dx_new, dy, mu, rstd, scale, ws)
    plain = upr.unpartition_add_ln_bwd(x_new, dx_new, dy, mu, rstd, scale, ws)
    for name, a, p in zip(("dwindows", "dshortcut", "dscale", "dbias"), got, plain):
        if p.dtype == torch.float32:
            torch.cuda.synchronize()
            assert (a - p).abs().max().item() <= 1e-4 * p.abs().max().item(), name
        else:
            _bf16_close(f"K9b {name}", a, p)


# --- K10 / K10b in bfloat16: bfloat16 x, w, dy and outputs, a float32 bias and db ---


def _bf16_one_ulp(label, got, want, min_equal=0.99):
    """Every element within one bfloat16 ulp of the plain version's (the ulp
    taken at no less than 2^-6 of max |plain|) and ``min_equal`` of them
    bit-equal: both sum in float32 and round once, in another order."""
    _bf16_ulps(label, got, want, 1.0, min_equal)


def _dw_rounded_once(label, dw, x, wt, dy):
    """Hold ``dw`` to the float64 sum rounded once to bfloat16: every element
    within one ulp of it, and at most ``chip_smoke.k10b_dw_flips_allowed`` of
    them off it (dw sums 10^2-10^6 pixels, and the plain bfloat16 VJP's own
    float32 sum rounds a few of them the other way on the card)."""
    import chip_smoke
    from mia_tpu_torch.ops import upsample2x as up

    exact = up.conv_transpose2x_bwd_plain(x.double(), wt.double(), dy.double(), need_dx=False)[1]
    exact = exact.to(torch.bfloat16)
    _bf16_ulps(label, dw, exact, 1.0, 0.0)
    flips = int((dw != exact).sum())
    assert flips <= chip_smoke.k10b_dw_flips_allowed(exact.numel()), (label, flips, exact.numel())


def _bf16_stage_operands(shape, cuda, seed):
    b, h, w, cin, cout = shape
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(b, h, w, cin, generator=gen, device=cuda).to(torch.bfloat16)
    wt = (torch.randn(2, 2, cin, cout, generator=gen, device=cuda) * cin ** -0.5).to(torch.bfloat16)
    bias = torch.randn(cout, generator=gen, device=cuda)
    dy = torch.randn(b, 2 * h, 2 * w, cout, generator=gen, device=cuda).to(torch.bfloat16)
    return x, wt, bias, dy


def test_bf16_k10_and_k10b_match_plain_at_the_smoke_stages(cuda):
    """Every stage one ulp from the plain bfloat16 versions, at least 99%
    bit-equal; where the backward takes the one pass dx 99.9% bit-equal to
    the plain version and dw held to the float64 sum rounded once
    (``_dw_rounded_once``); db within 1e-4 relative; two backward launches bit-identical; dx alone equal to
    the full backward's."""
    import chip_smoke
    from mia_tpu_torch.ops import upsample2x as up

    for label, shape, _ in chip_smoke.BF16_UPSAMPLE_STAGES:
        one_pass = up.k10_routes(shape[:4], shape[4], torch.bfloat16)["dx"] == "one pass"
        x, wt, bias, dy = _bf16_stage_operands(shape, cuda, seed=15)
        counts = (up.conv_transpose2x.launches, up.conv_transpose2x.bf16_launches,
                  up.conv_transpose2x_fused_bwd.launches, up.conv_transpose2x_fused_bwd.bf16_launches)
        got = up.conv_transpose2x(x, wt, bias)
        first = up.conv_transpose2x_fused_bwd(x, wt, dy)
        again = up.conv_transpose2x_fused_bwd(x, wt, dy)
        only_dx = up.conv_transpose2x_fused_bwd(x, wt, dy, need_dw=False)
        torch.cuda.synchronize()
        # the bfloat16 instances, counted apart from the float32 ones
        assert (up.conv_transpose2x.launches, up.conv_transpose2x.bf16_launches,
                up.conv_transpose2x_fused_bwd.launches,
                up.conv_transpose2x_fused_bwd.bf16_launches) == (
            counts[0], counts[1] + 1, counts[2], counts[3] + 3), label
        _bf16_one_ulp(f"K10 bf16 {label}", got, up.conv_transpose2x_plain_bf16(x, wt, bias))
        dx, dw, db = up.conv_transpose2x_bwd_plain_bf16(x, wt, dy)
        _bf16_one_ulp(f"K10b bf16 dx {label}", first[0], dx, 0.999 if one_pass else 0.99)
        _bf16_one_ulp(f"K10b bf16 dw {label}", first[1], dw)
        if one_pass:
            _dw_rounded_once(f"K10b bf16 dw {label} against float64", first[1], x, wt, dy)
        assert first[2].dtype == torch.float32
        assert _rel_err(first[2], db) <= 1e-4, label
        assert all(torch.equal(a, c) for a, c in zip(first, again)), label
        assert only_dx[1] is None and only_dx[2] is None and torch.equal(only_dx[0], first[0])


def test_bf16_k10_module_trains_through_k10b(cuda):
    from mia_tpu_torch.models import EinsumConvTranspose2x
    from mia_tpu_torch.ops import upsample2x as up

    torch.manual_seed(16)
    cpu = EinsumConvTranspose2x(64, 32, use_kernel="always", compute_dtype=torch.bfloat16)
    card = EinsumConvTranspose2x(64, 32, use_kernel="always", compute_dtype=torch.bfloat16).to(cuda)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn(3, 20, 27, 64).to(torch.bfloat16)
    g = torch.randn(3, 40, 54, 32).to(torch.bfloat16)
    before = (up.conv_transpose2x.bf16_launches, up.conv_transpose2x_fused_bwd.bf16_launches)
    outs = {}
    for name, mod, dev in (("cpu", cpu, "cpu"), ("card", card, cuda)):
        xi = x.to(dev).requires_grad_()
        y = mod(xi)
        outs[name] = [t.cpu() for t in (y, *torch.autograd.grad(y, [xi, mod.weight, mod.bias],
                                                                 g.to(dev)))]
    assert (up.conv_transpose2x.bf16_launches, up.conv_transpose2x_fused_bwd.bf16_launches) == (
        before[0] + 1, before[1] + 1)
    y, dx, dw, db = outs["card"]
    want = outs["cpu"]
    assert y.dtype == dx.dtype == torch.bfloat16 and dw.dtype == db.dtype == torch.float32
    _bf16_one_ulp("module y", y, want[0])
    _bf16_one_ulp("module dx", dx, want[1])
    # the parameters are float32: their gradients are the bfloat16 ones widened
    _bf16_one_ulp("module dw", dw.to(torch.bfloat16), want[2].to(torch.bfloat16))
    _bf16_one_ulp("module db", db.to(torch.bfloat16), want[3].to(torch.bfloat16))


def test_bf16_k10_rejects_what_it_does_not_take(cuda):
    from mia_tpu_torch.ops import upsample2x as up

    bf = torch.bfloat16
    x, w = torch.rand(1, 4, 4, 16, device=cuda, dtype=bf), torch.rand(2, 2, 16, 8, device=cuda, dtype=bf)
    b = torch.rand(8, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        up.conv_transpose2x(torch.rand(1, 4, 4, 12, device=cuda, dtype=bf),
                            torch.rand(2, 2, 12, 8, device=cuda, dtype=bf), b)
    with pytest.raises(ValueError, match="w must be"):
        up.conv_transpose2x(x, w.float(), b)
    with pytest.raises(ValueError, match="b must be"):
        up.conv_transpose2x(x, w, b.to(bf))
    with pytest.raises(ValueError, match="16-byte aligned"):
        up.conv_transpose2x(torch.rand(65, device=cuda, dtype=bf)[1:].view(1, 2, 2, 16), w, b)


def test_bf16_k10_stages_take_the_route_the_dispatch_rule_names(cuda):
    """Each product by the 20-flops-a-byte rule, except the backward of a
    stage the one pass has an instance for (Cin <= 64, Cout <= 32): dx and dw
    take the one pass there (prompt-large 2-4, UNet 4, SAM 2, the ragged
    thin stages), the measurement's rule."""
    import chip_smoke
    from mia_tpu_torch.ops import upsample2x as up

    def expected(shape):
        b, h, w, cin, cout = shape
        pixels = b * h * w
        out = {}
        for p in up.PRODUCTS:
            m, n, k = {"forward": (pixels, 4 * cout, cin), "dx": (pixels, cin, 4 * cout),
                       "dw": (cin, 4 * cout, pixels)}[p]
            tc = 2 * m * n * k >= 20 * 2 * (m * k + k * n + m * n)  # bfloat16: 2 bytes an element
            out[p] = "tensor cores" if tc else "cuda cores"
        if cin <= 64 and cout <= 32 and pixels:
            out["dx"] = out["dw"] = "one pass"
        return out

    taken = {label: up.k10_routes(shape[:4], shape[4], torch.bfloat16)
             for label, shape, _ in chip_smoke.BF16_UPSAMPLE_STAGES}
    assert taken == {label: expected(shape) for label, shape, _ in chip_smoke.BF16_UPSAMPLE_STAGES}
    assert taken["prompt-large 3"] == {"forward": "tensor cores", "dx": "one pass",
                                       "dw": "one pass"}
    assert taken["prompt-large 4"] == {"forward": "cuda cores", "dx": "one pass",
                                       "dw": "one pass"}
    assert set(taken["prompt-large 1"].values()) == {"tensor cores"}
    # float32 keeps its two tile products at every stage
    for label, shape, _ in chip_smoke.UPSAMPLE_STAGES:
        assert "one pass" not in up.k10_routes(shape[:4], shape[4]).values(), label


@pytest.mark.parametrize("shape", [(12, 256, 256, 16, 16), (2, 5, 12, 16, 16), (3, 7, 3, 16, 8),
                                   (2, 9, 13, 24, 16), (12, 128, 128, 32, 16),
                                   (12, 64, 64, 64, 32), (1, 6, 21, 8, 24)])
def test_bf16_k10b_one_pass_holds_and_is_one_kernel_and_the_reduces(cuda, shape):
    """The one pass, the wrapper's route at every shape here (prompt-large
    2-4 and the ragged thin stages: Cin <= 64, Cout <= 32), is three
    launches, the pass and the reduces of dw and db; dx and dw one ulp from
    the plain bfloat16 VJP, dx 99.9% bit-equal to it, dw 99% to it and held
    to the float64 sum rounded once (``_dw_rounded_once``) at the smoke's
    stages (prompt-large 2-4, ragged 5 x 12), the K10 measure's 99% at the
    other ragged shapes, whose dw has 256-768 elements (one element on a
    rounding boundary reads 99.80% at 512); db within 1e-4 relative; two
    launches bit-identical; dx alone and dw alone equal to the full
    backward's; dx alone is the pass alone."""
    import chip_smoke
    from mia_tpu_torch.ops import upsample2x as up

    x, wt, _, dy = _bf16_stage_operands(shape, cuda, seed=18)
    assert up.k10_routes(shape[:4], shape[4], torch.bfloat16)["dx"] == "one pass", shape
    first = up._launch_k10_bwd(x, wt, dy)
    dx, dw, db = up.conv_transpose2x_bwd_plain_bf16(x, wt, dy)
    stage = shape in [s for _, s, _ in chip_smoke.BF16_UPSAMPLE_STAGES]
    _bf16_one_ulp(f"one pass dx {shape}", first[0], dx, 0.999 if stage else 0.99)
    _bf16_one_ulp(f"one pass dw {shape}", first[1], dw)
    if stage:
        _dw_rounded_once(f"one pass dw {shape} against float64", first[1], x, wt, dy)
    assert first[2].dtype == torch.float32 and _rel_err(first[2], db) <= 1e-4, shape
    again = up._launch_k10_bwd(x, wt, dy)
    only_dx = up._launch_k10_bwd(x, wt, dy, need_dw=False)
    only_dw = up._launch_k10_bwd(x, wt, dy, need_dx=False)
    torch.cuda.synchronize()
    assert all(torch.equal(a, c) for a, c in zip(first, again)), shape
    assert only_dx[1] is None and torch.equal(only_dx[0], first[0]), shape
    assert only_dw[0] is None and torch.equal(only_dw[1], first[1])
    assert torch.equal(only_dw[2], first[2]), shape
    names = _device_kernels(lambda: up._launch_k10_bwd(x, wt, dy))
    assert len(names) == 3, names
    assert any("conv_transpose2x_bwd_onepass_kernel" in name for name in names), names
    assert sum("conv_transpose2x_reduce_kernel" in name for name in names) == 2, names
    names = _device_kernels(lambda: up._launch_k10_bwd(x, wt, dy, need_dw=False))
    assert len(names) == 1 and "onepass" in next(iter(names)), names
