"""The CPU model's own distance: how far a correct statistics-pass forward lands
from the plain bfloat16 versions, by the forwards' ulp measure, at the shapes
the card holds the bfloat16 forwards at.

The model walks the bfloat16 forwards' tile order on the CPU: pass 1 over
64-key tiles keeps the rows' maximum and sum online in float32, pass 2 takes
p = bf16(exp(S - m) / l) and O += p . V tile by tile in float32, then
bf16(O) (``tests/test_torch_bf16_fwd_fold.py`` holds the same order, with the
rel terms folded into S, against the Pallas kernels). Its scores are the
plain version's (q * scale rounded to bfloat16, plus the rel bias; K7: q . k
times the scale, plus the dense bias), so what parts it from the plain
version is only the order of the float32 sums: a probability on a rounding
boundary of bfloat16 rounds the other way and moves its row's outputs by a
few ulps. The largest distance over the shapes and seeds, plus one ulp, is
the limit ``chip_smoke.py`` (``BF16_FWD_ULPS``) and the card tests hold the
kernels to.

    python scripts/bf16_fwd_model_distance.py [--seeds 10] [--threads 4]

CPU only; a few minutes at four threads. Prints each case's (ulps, share
bit-equal) a seed, then the worst of each case and the largest distance.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from mia_tpu_torch.ops import attention  # noqa: E402

BF = torch.bfloat16
TILE = 64
ULP_FLOOR = 2.0 ** -6  # an element's ulp is taken at no less than this share of max |plain|


def agreement(got, want):
    """(largest distance in bfloat16 ulps of ``want``, share bit-equal)."""
    want = want.float()
    mag = want.abs()
    floor = max(mag.max().item() * ULP_FLOOR, 2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag.clamp_min(floor))) - 7)
    diff = (got.float() - want).abs()
    return (diff / ulp).max().item(), (diff == 0).float().mean().item()


def statistics_pass(scores, v, n):
    """The tile order: ``scores(k0, k1)`` → float32 (R, rows, k1 - k0); v (R, n, d)."""
    m = l = None
    for k0 in range(0, n, TILE):
        s = scores(k0, min(n, k0 + TILE))
        if m is None:
            m, l = torch.full(s.shape[:2], -torch.inf), torch.zeros(s.shape[:2])
        mn = torch.maximum(m, s.amax(-1))
        l = l * torch.exp(m - mn) + torch.exp(s - mn[..., None]).sum(-1)
        m = mn
    o = 0
    for k0 in range(0, n, TILE):
        p = torch.exp(scores(k0, min(n, k0 + TILE)) - m[..., None]) / l[..., None]
        o = o + p.to(BF).float() @ v[:, k0:k0 + TILE].float()
    return o.to(BF)


def rel_case(b, heads, k_hw, seed, d=64):
    """K3 (and K6, K2 and K8, whose windows are K3's arithmetic): packed qkv
    and rel terms drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    n = k_hw[0] * k_hw[1]

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(BF)

    qkv, rel_h, rel_w = randn(b, n, 3 * heads * d), randn(b * heads, n, k_hw[0]), randn(
        b * heads, n, k_hw[1])
    want = attention.attention_rel_packed_bf16(qkv, rel_h, rel_w, d ** -0.5, k_hw, heads)[0]
    q, k, v = (t.reshape(b * heads, n, d).float()
               for t in qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4))
    qs = (q * torch.tensor(d ** -0.5).to(BF).float()).to(BF).float()
    bias = (rel_h.float()[..., :, None] + rel_w.float()[..., None, :]).reshape(b * heads, n, n)
    o = statistics_pass(lambda k0, k1: qs @ k[:, k0:k1].transpose(1, 2) + bias[:, :, k0:k1], v, n)
    return agreement(o.reshape(b, heads, n, d).transpose(1, 2).reshape(b, n, heads * d), want)


def dense_case(bh, n, seed, d=64):
    """K7: head-major q, k, v and a float32 dense bias drawn from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(bh, n, d, generator=gen).to(BF) for _ in range(3))
    bias = torch.randn(bh, n, n, generator=gen)
    want = attention.attention_dense_bf16(q, k, v, bias, d ** -0.5)
    o = statistics_pass(lambda k0, k1: (q.float() @ k[:, k0:k1].float().transpose(1, 2))
                        * d ** -0.5 + bias[:, :, k0:k1], v, n)
    return agreement(o, want)


# the card's shapes: K3 at ViT-B/512 batch 1 and 8, windows of a batch-8 image set (K2, K6, K8),
# the ragged 20 x 27 grid, the 4096-token 64 x 64 grid; K7 on global tokens and windows
CASES = {"K3 B=1": lambda s: rel_case(1, 12, (32, 32), s),
         "K3 B=8": lambda s: rel_case(8, 12, (32, 32), s),
         "windows (72, 14x14)": lambda s: rel_case(72, 12, (14, 14), s),
         "grid 20x27": lambda s: rel_case(2, 12, (20, 27), s),
         "grid 64x64": lambda s: rel_case(1, 12, (64, 64), s),
         "K7 global": lambda s: dense_case(12, 1024, s),
         "K7 windows": lambda s: dense_case(108, 196, s)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=10)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    worst = {}
    for seed in range(args.seeds):
        row = []
        for name, case in CASES.items():
            ulps, equal = case(seed)
            had = worst.get(name, (0.0, 1.0))
            worst[name] = (max(had[0], ulps), min(had[1], equal))
            row.append(f"{name} {ulps:.4g} / {equal:.5f}")
        print(f"seed {seed}: " + "; ".join(row), flush=True)
    for name, (ulps, equal) in worst.items():
        print(f"worst {name}: {ulps:.4g} ulps, {equal:.5f} bit-equal")
    print(f"largest distance {max(u for u, _ in worst.values()):.4g} ulps; least share bit-equal "
          f"{min(e for _, e in worst.values()):.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
