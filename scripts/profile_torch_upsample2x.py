"""K10 and K10b (the k2/s2 transposed convolution and its backward) stage by
stage on one GPU, for one source tree or several.

Runs ``chip_smoke.py``'s ``upsample_kernel_phase`` alone: every stage of the
SAM prompt-large upscaler (batch 12), the plain SAM upscaler (one prompt) and
the UNet decoder (batch 12, 256²) plus ragged grids on both routes, each held
against the plain PyTorch version (forward within 1e-5, ``dx``/``dw``/``db``
within 1e-4 of max |plain|, two backward launches bit-identical, ``dx`` alone
equal to the full backward's) and timed in turns with it by CUDA events,
beside its float32 and 3xTF32 bounds and one ``F.conv_transpose2d`` call
(autograd through it for the backward) with TF32 and with full float32
convolutions. Prints the card first.

Several ``--tree`` arguments run in the given order, one process each (parent,
change, change, parent is the order that shows a drift of the card); each
tree builds its own kernel library and runs its own ``chip_smoke.py``. Unpack
the parent with ``git archive <commit> mia_tpu_torch chip_smoke.py | tar -x -C
<dir>``. The last lines are a table of K10's and K10b's time by stage and tree.

With ``--ptxas`` it times nothing: it compiles each tree's
``csrc/upsample2x.cu`` with ``nvcc -Xptxas -v`` and prints every kernel's
registers and spill and its ``HMMA.1688.F32.TF32`` (3xTF32) and
``HMMA.16816.F32.BF16`` (bfloat16) counts in the SASS (``cuobjdump``). Needs
nvcc, not a GPU.

    python scripts/profile_torch_upsample2x.py [--tree DIR ...] [--ptxas] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TAG = "upsample stages: "


def ptxas_report(trees) -> int:
    sys.path.insert(0, str(ROOT))
    from mia_tpu_torch.ops import cuda_build

    nvcc = cuda_build._nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            obj = Path(tmp) / f"{i}.o"
            src = Path(tree) / "mia_tpu_torch" / "csrc" / "upsample2x.cu"
            done = subprocess.run([nvcc, *cuda_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                                   str(obj), str(src)], capture_output=True, text=True)
            if done.returncode != 0:
                print(done.stderr, file=sys.stderr)
                return 1
            hmma, name = {}, None
            for line in subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                                       text=True, check=True).stdout.splitlines():
                m = re.match(r"\s+Function : (\S+)", line)
                if m:
                    name = m.group(1)
                    hmma[name] = [0, 0]
                elif name and "HMMA.1688.F32.TF32" in line:
                    hmma[name][0] += 1
                elif name and "HMMA.16816.F32.BF16" in line:
                    hmma[name][1] += 1
            print(f"{tree}: csrc/upsample2x.cu")
            name = ""
            for line in done.stderr.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    name = m.group(1)
                elif "Used" in line or ("spill" in line and " 0 bytes spill stores" not in line):
                    short = name[max(name.find("conv_transpose2x"), 0):][:64]
                    tf32, bf16 = hmma.get(name, (0, 0))
                    print(f"  {short}: {line.split(':', 1)[-1].strip()}; "
                          f"HMMA.1688.F32.TF32 {tf32}, HMMA.16816.F32.BF16 {bf16}", flush=True)
    return 0


def one_tree(tree: str, out: Path | None) -> None:
    """Run the tree's own upsample phase in this process."""
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch

    import chip_smoke
    from mia_tpu_torch.ops import cuda_build

    cuda_build.load_library()
    stages = chip_smoke.upsample_kernel_phase(torch, torch.device("cuda", 0))
    if out is not None:
        out.mkdir(parents=True, exist_ok=True)
        (out / "upsample2x_stages.json").write_text(json.dumps(stages, indent=1))
    print(TAG + json.dumps({name: {label: m["ms"] for label, m in entry["stages"].items()}
                            for name, entry in stages.items()}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="root of a tree that holds mia_tpu_torch/")
    ap.add_argument("--ptxas", action="store_true", help="print the compiler's resource usage")
    ap.add_argument("--out", type=Path, default=None, help="also write the stages as JSON here")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process of one tree
    args = ap.parse_args(argv)
    trees = args.tree or [str(ROOT)]
    if args.ptxas:
        return ptxas_report(trees)
    if args.one:
        one_tree(args.one, args.out)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("a CUDA device is required", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    rows = []
    for tree in trees:
        cmd = [sys.executable, __file__, "--one", tree]
        if args.out is not None and len(trees) == 1:
            cmd += ["--out", str(args.out)]
        done = subprocess.run(cmd, capture_output=True, text=True)
        lines = done.stdout.splitlines()
        print("\n".join(f"{tree}: {line}" for line in lines if not line.startswith(TAG)), flush=True)
        if done.returncode != 0:
            print(done.stderr[-4000:], file=sys.stderr)
            return 1
        rows.append((tree, json.loads(next(line for line in lines if line.startswith(TAG))[len(TAG):])))
    for name in ("K10", "K10b"):
        labels = list(rows[0][1][name])
        print(f"{name} us by stage: " + " | ".join(
            f"{label}: " + " / ".join(f"{r[name].get(label, float('nan')) * 1e3:.2f}" for _, r in rows)
            for label in labels))
    print("trees: " + " / ".join(tree for tree, _ in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
