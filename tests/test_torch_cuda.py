"""K1-K9 on the card: the CUDA kernels against their plain PyTorch versions.

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


@pytest.mark.parametrize("b,heads,d,ws,tables", [(108, 12, 64, 14, False), (6, 3, 64, 7, True),
                                                 (4, 16, 80, 14, True), (3, 2, 64, 2, True)])
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


@pytest.mark.parametrize("b,heads,d,k_hw", [(12, 12, 64, (32, 32)), (2, 4, 64, (20, 27)),
                                            (2, 2, 80, (5, 9))])
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


@pytest.mark.parametrize("size", [64, 512])
def test_k5_bit_exact_against_plain(cuda, size):
    from mia_tpu_torch.ops import morphology

    gen = torch.Generator(device=cuda).manual_seed(7)
    masks = _cc_masks(gen, cuda, n=144 if size == 64 else 4, size=size)
    before = morphology.connected_components_fused.launches
    got = morphology.connected_components_fused(masks)
    want = morphology.connected_components(masks)
    torch.cuda.synchronize()
    assert morphology.connected_components_fused.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


# K6-K9 (forward kernels) against their plain versions, same tolerance as
# K2-K4; K9's x_new bit for bit (one float32 add).
@pytest.mark.parametrize("bh,d,k_hw", [(108, 64, (14, 14)), (12, 64, (32, 32)), (16, 80, (14, 14)),
                                       (6, 64, (10, 12)), (3, 64, (1, 3))])
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


@pytest.mark.parametrize("bh,d,n", [(108, 64, 196), (12, 64, 1024), (16, 80, 196), (5, 64, 120),
                                    (3, 64, 1)])
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
    before = attention.fused_attention_rel_win.launches
    got = attention.fused_attention_rel_win(qkv, rel_h, rel_w, bias_kv, d ** -0.5, ws, heads)
    want = attention.attention_rel_win(qkv, rel_h, rel_w, bias_kv, d ** -0.5, ws, heads)
    torch.cuda.synchronize()
    assert attention.fused_attention_rel_win.launches == before + 1
    assert got.shape == want.shape == (b, h, w, heads * d)
    assert _rel_err(got, want) <= 1e-5


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
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops import unpartition_residual as upr

    q = torch.randn(2, 16, 64, device=cuda, requires_grad=True)
    rel = torch.randn(2, 16, 4, device=cuda)
    grid = torch.randn(2, 5, 6, 4, device=cuda)
    calls = (
        lambda: attention.fused_attention_rel(q, q, q, rel, rel, 0.1, (4, 4)),
        lambda: attention.fused_attention(q, q, q, torch.zeros(2, 16, 16, device=cuda), 0.1),
        lambda: attention.fused_attention_rel_win(
            torch.randn(1, 5, 6, 384, device=cuda, requires_grad=True), grid, grid,
            torch.zeros(3, 128, device=cuda), 0.1, 4, 2),
        lambda: upr.unpartition_add_ln(
            torch.randn(4, 4, 4, 64, device=cuda, requires_grad=True),
            torch.randn(1, 5, 6, 64, device=cuda), torch.ones(64, device=cuda),
            torch.zeros(64, device=cuda), 4),
    )
    for call in calls:
        with pytest.raises(NotImplementedError, match="backward kernel"):
            call()
        with torch.no_grad():
            call()  # the same call serves


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
