"""K1 on the card: the CUDA kernel against its plain PyTorch version.

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
