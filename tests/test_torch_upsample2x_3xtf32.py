"""Why K10 and K10b fold each 32-deep slice of their 3xTF32 products into
float32 instead of chaining the tensor core's accumulator through the whole
depth, and why they split every operand instead of taking one TF32 pass.

The tensor-core route of ``mia_tpu_torch/csrc/upsample2x.cu`` runs the
forward (pixels x 4·Cout over Cin), ``dx`` (pixels x Cin over 4·Cout) and
``dw`` (Cin x 4·Cout over a chunk of pixels) as ``mma.sync.m16n8k8`` TF32:
three MMAs a k8 step (small·big, big·small, big·big), each step's exact sum
truncated into the float32 accumulator, a chain of ``FOLD`` deep started from
zero in every slice and added to a float32 result by one rounded add. These
tests emulate that order on the CPU with the helpers of
``test_torch_attention_3xtf32.py`` and hold it against float64: the forward
within ``KERNEL_TOL`` of max |float64|, ``dx`` and ``dw`` within ``BWD_TOL``,
as ``chip_smoke.py`` holds the kernels; one TF32 pass at least 10x further
off, and a chain through the whole depth at least 4x further off than the
fold.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_attention_3xtf32 import BWD_TOL, KERNEL_TOL, mma_3xtf32, mma_tf32

FOLD = 32  # the kernel's kFold: the depth of each MMA chain before its fold
SOURCE = Path(__file__).resolve().parents[1] / "mia_tpu_torch" / "csrc" / "upsample2x.cu"


def folded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in the kernel's order: per ``FOLD``-deep slice a 3xTF32 MMA
    chain from zero, added to the float32 result by one rounded add."""
    acc = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], FOLD):
        ks = slice(k0, k0 + FOLD)
        acc = acc + mma_3xtf32(torch.zeros_like(acc), a[:, ks], b[ks])
    return acc


def chained(a, b):
    """The same 3xTF32 MMAs chained through the whole depth."""
    return mma_3xtf32(torch.zeros(a.shape[0], b.shape[1]), a, b)


def one_pass(a, b):
    """One TF32 MMA a k8 step, chained through the whole depth."""
    return mma_tf32(torch.zeros(a.shape[0], b.shape[1]), a, b)


def product_case(case):
    """The operands of one product at a stage's depth (rows and columns cut
    to at most 128) as the kernel reads them, the float32 bias added after
    the fold (forward only), and the tolerance."""
    rng = np.random.default_rng(9)

    def randn(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.standard_normal(shape, dtype=np.float32))

    if case.startswith("forward"):  # x (pixels, Cin) . taps (Cin, 4·Cout), taps ~ Cin^-0.5
        cin = {"forward UNet 1": 512, "forward ragged Cin 520": 520}[case]
        return randn(128, cin), randn(cin, 128, scale=cin ** -0.5), randn(128), KERNEL_TOL
    if case == "dx UNet 1":  # dy (pixels, 4·Cout) . taps^T (4·Cout, Cin)
        return randn(128, 1024), randn(1024, 128, scale=512 ** -0.5), None, BWD_TOL
    # dw, one chunk of 3072 pixels: x^T (Cin, pixels) . dy (pixels, 4·Cout), x after a ReLU
    return randn(128, 3072).clamp_min(0.0), randn(3072, 128), None, BWD_TOL


def relative(got, want):
    return (got.double() - want).abs().max().item() / want.abs().max().item()


@pytest.mark.parametrize("case", ["forward UNet 1", "forward ragged Cin 520", "dx UNet 1",
                                  "dw chunk of 3072 pixels"])
def test_folded_3xtf32_keeps_float32_accuracy_where_a_chain_or_one_pass_does_not(case):
    a, b, bias, tol = product_case(case)
    want = a.double() @ b.double()
    results = {"fold": folded(a, b), "chain": chained(a, b), "one pass": one_pass(a, b)}
    if bias is not None:
        want = want + bias.double()
        results = {k: v + bias for k, v in results.items()}
    err = {k: relative(v, want) for k, v in results.items()}
    assert err["fold"] <= tol, f"{case}: folded 3xTF32 off by {err['fold']:.3g} of max |float64|"
    assert err["one pass"] >= 10 * err["fold"], f"{case}: {err}"
    assert err["chain"] >= 4 * err["fold"], f"{case}: the fold does not beat the chain, {err}"


def test_emulated_fold_depth_is_the_kernels():
    fold = re.search(r"constexpr int kFold = (\d+);", SOURCE.read_text())
    assert fold is not None and int(fold.group(1)) == FOLD
