"""Time variants of the bfloat16 warpgroup forward (K3 / K6,
``csrc/attention_fwd_wgmma.cuh``) against each other, through its C entry
``mia_attention_rel_fwd_wgmma_bf16``.

A variant tree is a copy of ``mia_tpu_torch/`` whose ``csrc/`` keeps
``attention_fwd_wgmma.cu`` (and every header) and no other ``.cu``, so that
its library builds in seconds; edit its kernel and name the tree on the
command line. Each tree runs in a process of its own: K3 at B=1 and B=8
(packed qkv, 12 heads, 32 x 32 tokens) and K6-shaped calls (one head) on 108
windows of 14 x 14 and 12 global rows of 1024 tokens, each held against the
plain bfloat16 version (ulps and share bit-equal, ``chip_smoke.bf16_ulps``;
the log-sum-exp's largest distance) and timed queued in turns with cuDNN
(``chip_smoke.library_turns_ms``). A variant that skips work prints its
(wrong) readings beside its time.

    python scripts/time_fwd_wgmma_variants.py TREE [TREE ...]

Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CASES = (("K3 B=1", 1, 12, (32, 32), 50), ("K3 B=8", 8, 12, (32, 32), 10),
         ("K6 windows", 108, 1, (14, 14), 20), ("K6 global", 12, 1, (32, 32), 20))


def one(tree: str) -> None:
    sys.path.insert(0, tree)
    sys.path.insert(1, str(ROOT))
    import torch

    import chip_smoke as cs
    from mia_tpu_torch.ops import attention
    from mia_tpu_torch.ops.cuda_build import load_library

    fn = load_library().mia_attention_rel_fwd_wgmma_bf16
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(5)
    bf = torch.bfloat16
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device).to(bf)

    readings = []
    for label, b, heads, k_hw, per_block in CASES:
        n = k_hw[0] * k_hw[1]
        qkv = randn(b, n, 3 * heads * 64)
        rel_h, rel_w = randn(b * heads, n, k_hw[0]), randn(b * heads, n, k_hw[1])
        out = torch.empty(b, n, heads * 64, device=device, dtype=bf)
        lse = torch.empty(b * heads, n, device=device)
        hd = heads * 64

        def call():
            base = qkv.data_ptr()
            err = fn(base, base + 2 * hd, base + 4 * hd, rel_h.data_ptr(), rel_w.data_ptr(),
                     out.data_ptr(), lse.data_ptr(), 3 * hd, hd, b, n, heads, *k_hw, 0.125,
                     torch.cuda.current_stream().cuda_stream)
            assert err == 0, f"cudaError {err}"

        call()
        want, want_lse = attention.attention_rel_packed_bf16(qkv, rel_h, rel_w, 0.125, k_hw, heads)
        torch.cuda.synchronize()
        ulps, equal = cs.bf16_ulps(torch, out, want)
        lse_err = (lse - want_lse).abs().max().item()
        q, k, v = cs.head_major(qkv, heads)
        bias = cs.dense_bias(rel_h, rel_w, b, heads)
        ms, lib_ms = cs.library_turns_ms(
            torch, f"{tree} {label}", call, lambda: sdpa(q, k, v, attn_mask=bias, scale=0.125),
            per_block)
        readings.append(f"{label} {ms * 1e3:.2f} us (cuDNN {lib_ms * 1e3:.2f}; {ulps:.3g} ulps "
                        f"{equal:.5f} bit-equal, lse {lse_err:.2g})")
    print(f"{tree}: " + "; ".join(readings), flush=True)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        one(argv[1])
        return 0
    for tree in argv:
        subprocess.run([sys.executable, __file__, "--one", tree], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
