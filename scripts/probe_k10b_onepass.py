"""Probe what sets the time of K10b·bf16's one pass
(``csrc/upsample2x.cu::conv_transpose2x_bwd_onepass_kernel``) on one GPU.

It builds variants of ``csrc/upsample2x.cu`` alone, each a text edit of the
source (``VARIANTS``), into libraries of their own under ``build/`` (one
``nvcc`` each, all started together), and times each variant's one pass
(``mia_conv_transpose2x_bwd_bf16``, whose rule sends every stage here to the
one pass; the script checks that it does) queued
(``chip_smoke.queued_ms``) at the stages asked for, beside the one pass
without dw (dx alone) and without dx (dw and db alone). It prints, for each
variant, the registers' spill as the SASS shows it (LDL/STL instructions),
the ``HMMA`` and ``LDSM`` counts of the instance a stage runs, and whether
dx, dw and db equal the unedited source's bit for bit. A variant that
computes nothing (``loads only``) reads the time of the stage ring's copies
alone.

    python scripts/probe_k10b_onepass.py [--stage pl4] [--stage pl2 ...]

Stages: pl2, pl3, pl4 (the prompt-large stages 2-4 at batch 12) and unet4
(12, 128, 128, 64 -> 32). Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "mia_tpu_torch" / "csrc"
STAGES = {"pl2": (12, 64, 64, 64, 32), "pl3": (12, 128, 128, 32, 16),
          "pl4": (12, 256, 256, 16, 16), "unet4": (12, 128, 128, 64, 32)}
# name -> (old text, new text) edits of upsample2x.cu
VARIANTS = {
    "as built": [],
    "loads only": [("    if (want_dx) {", "    if (want_dx && Cin < 0) {"),
                   ("    if (want_dw) {\n#pragma unroll\n      for (int pc",
                    "    if (want_dw && Cin < 0) {\n#pragma unroll\n      for (int pc")],
    "the largest instance at one block an SM": [
        ("__launch_bounds__(kOpThreads, kOpBlocksPerSm)",
         "__launch_bounds__(kOpThreads, kCin * kN4 >= 8192 ? 1 : kOpBlocksPerSm)")],
    "a ring of two stages": [("static constexpr int kStages = 4 * kStageBytes",
                              "static constexpr int kStages = 2 * kStageBytes + kWBytes <= "
                              "kOpBudget ? 2 : 4 * kStageBytes")],
}


def instance(cin: int, cout: int) -> str:
    """The mangled-name fragment of the instance (kCin, kN4) a stage runs."""
    k_cin = 16 if cin <= 16 else 32 if cin <= 32 else 64
    return f"onepass_kernelILi{k_cin}ELi{64 if 4 * cout <= 64 else 128}E"


def build(nvcc, flags, fragment):
    """Each variant's library → {name: (bwd entry, chunks entry, route entry)}; prints its SASS
    counts."""
    out = ROOT / "build" / "probe_k10b_onepass"
    procs = {}
    for i, (name, edits) in enumerate(VARIANTS.items()):
        d = out / str(i)
        d.mkdir(parents=True, exist_ok=True)
        for f in ("upsample2x.cu", "bf16_mma.cuh", "tf32_mma.cuh"):
            shutil.copy(SRC / f, d / f)
        text = (d / "upsample2x.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name!r}: its edit no longer applies to the source")
            text = text.replace(old, new)
        (d / "upsample2x.cu").write_text(text)
        procs[name] = (d, subprocess.Popen([nvcc, *flags, "-shared", "-o", str(d / "lib.so"),
                                            str(d / "upsample2x.cu")],
                                           stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"variant {name!r} does not build:\n{err[-3000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        bwd = lib.mia_conv_transpose2x_bwd_bf16
        bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        bwd.restype = ctypes.c_int
        chunks = lib.mia_conv_transpose2x_bwd_chunks_bf16
        chunks.argtypes = [ctypes.c_int] * 5
        chunks.restype = ctypes.c_longlong
        route = lib.mia_conv_transpose2x_route_bf16
        route.argtypes = [ctypes.c_int] * 6
        route.restype = ctypes.c_int
        libs[name] = (bwd, chunks, route)
        dump = subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(d / "lib.so")],
                              capture_output=True, text=True, check=True).stdout
        body, keep = [], False
        for line in dump.splitlines():
            if "Function :" in line:
                keep = fragment in line
            elif keep:
                body.append(line)
        print(f"{name}: {sum(('LDL' in x or 'STL' in x) for x in body)} LDL/STL, "
              f"{sum('HMMA' in x for x in body)} HMMA, {sum('LDSM' in x for x in body)} LDSM in "
              f"the instance {fragment}", flush=True)
    return libs


def probe(torch, cs, libs, shape, seed=4):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h, w, cin, cout = shape

    def randn(*s, scale=1.0):
        return (scale * torch.randn(s, generator=gen, device=dev)).to(torch.bfloat16)

    x, wt = randn(b, h, w, cin), randn(2, 2, cin, cout, scale=cin ** -0.5)
    dy = randn(b, 2 * h, 2 * w, cout)
    stream = torch.cuda.current_stream().cuda_stream
    calls, outs = {}, {}
    for name, (bwd, chunks_of, route) in libs.items():
        if route(b, h, w, cin, cout, 1) != 2:  # product 1 (dx) on route 2, the one pass
            raise SystemExit(f"{name}: {shape} does not take the one pass")
        chunks = int(chunks_of(b, h, w, cin, cout))
        dx, dw = torch.empty_like(x), torch.empty_like(wt)
        db = torch.empty(cout, device=dev)
        part = torch.empty(chunks * cin * 4 * cout, device=dev)
        sums = torch.empty(chunks * 4 * cout, device=dev)

        def call(bwd=bwd, dx=dx, dw=dw, db=db, part=part, sums=sums, need_dx=True, need_dw=True):
            err = bwd(x.data_ptr(), wt.data_ptr(), dy.data_ptr(), dx.data_ptr() if need_dx else None,
                      dw.data_ptr() if need_dw else None, db.data_ptr(), part.data_ptr(),
                      sums.data_ptr(), b, h, w, cin, cout, stream)
            if err:
                raise RuntimeError(f"{name}: cudaError {err}")

        call()
        torch.cuda.synchronize()
        calls[name], outs[name] = call, (dx.clone(), dw.clone(), db.clone())
    print(f"{shape}:", flush=True)
    for name, call in calls.items():
        same = [bool(torch.equal(a, c)) for a, c in zip(outs[name], outs["as built"])]
        ms = min(cs.queued_ms(torch, call, 5) for _ in range(2))
        print(f"  {name}: {ms * 1e3:.2f} us queued; dx, dw, db equal to the source as built: "
              f"{same}", flush=True)
    for label, kw in (("dx alone", {"need_dw": False}), ("dw and db alone", {"need_dx": False})):
        ms = min(cs.queued_ms(torch, lambda: calls["as built"](**kw), 5) for _ in range(2))
        print(f"  as built, {label}: {ms * 1e3:.2f} us queued", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", action="append", choices=sorted(STAGES))
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    import chip_smoke as cs
    from mia_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    stages = args.stage or ["pl4"]
    libs = build(_nvcc(), NVCC_FLAGS, instance(*STAGES[stages[0]][3:]))
    for key in stages:
        probe(torch, cs, libs, STAGES[key])
    return 0


if __name__ == "__main__":
    sys.exit(main())
