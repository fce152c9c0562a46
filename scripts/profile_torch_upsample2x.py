"""K10 and K10b (the k2/s2 transposed convolution and its backward) stage by
stage on one GPU.

Runs ``chip_smoke.py``'s ``upsample_kernel_phase`` alone: every stage of the
SAM prompt-large upscaler (batch 12), the plain SAM upscaler (one prompt) and
the UNet decoder (batch 12, 256²) plus ragged grids, each held against the
plain PyTorch version (forward within 1e-5, ``dx``/``dw``/``db`` within 1e-4 of
max |plain|, two backward launches bit-identical) and timed in turns with it
by CUDA events, beside its bound and one ``F.conv_transpose2d`` call (autograd
through it for the backward). Prints the card first, and with ``--ptxas`` what
``nvcc -Xptxas -v`` says of ``csrc/upsample2x.cu`` (registers, shared memory,
spills). Needs a CUDA device.

    python scripts/profile_torch_upsample2x.py [--ptxas] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true", help="print the compiler's resource usage")
    ap.add_argument("--out", type=Path, default=None, help="also write the stages as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("a CUDA device is required", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from mia_tpu_torch.ops import cuda_build

    print(chip_smoke.card_line(), flush=True)
    if args.ptxas:
        done = subprocess.run(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", "/dev/null",
             str(cuda_build.CSRC_DIR / "upsample2x.cu")], capture_output=True, text=True)
        entry = ""
        for line in (done.stdout + done.stderr).splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
                entry = entry[max(entry.find("conv_transpose2x"), 0):]  # name and tile sizes
            elif "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
                print(f"{entry[:64]}: {line.strip()}", flush=True)
            elif "Used" in line:
                print(f"{entry[:64]}: {line.split(':', 1)[1].strip()}", flush=True)
        if done.returncode != 0:
            print(done.stderr, file=sys.stderr)
            return 1
    cuda_build.load_library()
    out = chip_smoke.upsample_kernel_phase(torch, torch.device("cuda", 0))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "upsample2x_stages.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
