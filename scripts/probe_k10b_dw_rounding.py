"""Count, on one GPU, the elements of K10b·bf16's dw that round the other
way from the float64 sum rounded once to bfloat16, for the backward of one
or more source trees (each on the route its own rule names) and for the
plain bfloat16 VJP (``conv_transpose2x_bwd_plain_bf16``: float32 sums on the
card), at the prompt-large stages 2-4 (batch 12) for a few seeds of the card
tests' operands (``tests/test_torch_cuda.py::_bf16_stage_operands``).

dw sums 10^5-10^6 pixels, so any two float32 orders round a few of its 1024-
8192 elements apart; this shows which side rounds them, and is the reading
behind ``chip_smoke.k10b_dw_flips_allowed``, the count of such elements the
card allows the one pass's dw. To read the tile products beside the one
pass, unpack a tree without the one pass (``git archive <commit>
mia_tpu_torch | tar -x -C <dir>``) and name it with ``--tree``; each tree
runs in a process of its own and builds its own kernel library. Each line
ends with a digest of the kernel's dw: equal digests across trees = the
same dw bit for bit.

    python scripts/probe_k10b_dw_rounding.py [--tree DIR ...] [--seeds 15 16 17 18]

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAGES = {"prompt-large 2": (12, 64, 64, 64, 32), "prompt-large 3": (12, 128, 128, 32, 16),
          "prompt-large 4": (12, 256, 256, 16, 16)}


def one(tree: str, seeds) -> None:
    sys.path.insert(0, tree)
    import torch

    from mia_tpu_torch.ops import upsample2x as up

    dev = torch.device("cuda")
    for label, (b, h, w, cin, cout) in STAGES.items():
        taken = up.k10_routes((b, h, w, cin), cout, torch.bfloat16)
        route = "/".join(sorted({taken["dx"], taken["dw"]}))
        for seed in seeds:
            gen = torch.Generator(device=dev).manual_seed(seed)
            x = torch.randn(b, h, w, cin, generator=gen, device=dev).to(torch.bfloat16)
            wt = (torch.randn(2, 2, cin, cout, generator=gen, device=dev)
                  * cin ** -0.5).to(torch.bfloat16)
            torch.randn(cout, generator=gen, device=dev)  # the bias the card tests draw here
            dy = torch.randn(b, 2 * h, 2 * w, cout, generator=gen, device=dev).to(torch.bfloat16)
            got = up._launch_k10_bwd(x, wt, dy, need_dx=False)[1]
            plain = up.conv_transpose2x_bwd_plain_bf16(x, wt, dy, need_dx=False)[1]
            exact = up.conv_transpose2x_bwd_plain(x.double(), wt.double(), dy.double(),
                                                  need_dx=False)[1].to(torch.bfloat16)
            digest = hashlib.sha1(got.view(torch.int16).cpu().numpy().tobytes()).hexdigest()[:12]
            print(f"{tree}: {label} seed {seed}: dw {exact.numel()} elements; rounded the other "
                  f"way from the float64 sum: kernel ({route}) {int((got != exact).sum())}, plain "
                  f"{int((plain != exact).sum())}; kernel against plain {int((got != plain).sum())}; "
                  f"digest {digest}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="root of a tree that holds mia_tpu_torch/")
    ap.add_argument("--seeds", type=int, nargs="+", default=[15, 16, 17, 18])
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process of one tree
    args = ap.parse_args(argv)
    if args.one:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("needs a CUDA device")
        one(args.one, args.seeds)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree, "--seeds",
                        *map(str, args.seeds)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
