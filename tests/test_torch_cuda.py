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
