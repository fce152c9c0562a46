"""Time the attention kernels K2, K3, K6, K7, K8, K2b, K3b, K6b and K8b of a source tree on one GPU.

For comparing two versions of the attention templates
(``mia_tpu_torch/csrc/attention_{fwd,bwd}_tc.cuh``, ``attention_window.cuh``) or
of ``attention_rel.cu`` and ``attention_routes.cu`` within one run: unpack the other
tree with ``git archive <commit> mia_tpu_torch | tar -x -C <dir>`` and name it
with ``--tree``; every tree builds its own kernel library. Prints the card,
then K3b (global, ``(12, 1024, 2304)`` packed qkv) and K2b (windows, ``(108,
196, 2304)``) at the ViT-B/512 training shape for batch 12 as medians of 7
blocks of 10 launches by CUDA events, twice each, K3b's and K2b's largest
errors against their plain VJPs, a digest of K3b's and K2b's outputs on
inputs that do not depend on the tree's forward kernels (out and lse from the
plain forward: equal digests across trees mean bit-identical backward
kernels), and K6b (global and windows, head-major) and K8b. With
``--kernels`` each tree also runs K3b, K2b and the library yardstick
(autograd through one ``scaled_dot_product_attention`` call with the dense
bias, as ``chip_smoke.py`` times it) under ``torch.profiler`` and prints the
device kernels each one launches, with their times. Needs a CUDA device.

With ``--sass`` it times nothing: it compiles each tree's
``csrc/attention_rel.cu``, ``csrc/attention_routes.cu`` and
``csrc/ln_window.cu`` (K4 and K4b) with ``nvcc -Xptxas -v`` and prints, for
every kernel, its registers and spill, its ``HMMA.1688.F32.TF32``,
``HMMA.16816.F32.BF16``, ``ATOM`` and local-memory instructions, and whether
its SASS equals the first tree's, under its own name or another (so
``--tree build/parent --tree . --sass`` shows the kernels a change left as
they were). Needs nvcc and cuobjdump, not a GPU.

With ``--forward`` it times the forward kernels instead: K3 (global, 1024
tokens) and K2 (9 windows of 196 tokens an image) at the ViT-B/512 serving
shape B=1 and the training shape B=12, and K7 (dense bias) and K6 (rel
terms), both head-major, at both shapes too, each beside the library call
on the same operands (``scaled_dot_product_attention`` with the dense bias
built beforehand) and K7 and K6 also beside their plain versions, with
their largest errors against the plain versions; then K8 (windows carved
from the (B, 32, 32) token grid) at both shapes beside its plain version and
the library call on the partitioned windows; with ``--kernels`` the device
kernels of K3, K2, K7, K6 and K8 at B=1 and B=12 and of the library call at
B=1.

With ``--forward --bf16`` it times the bfloat16 instances of K3 and K2 on
bfloat16 operands at the ViT-B/512 serving shapes B=1 and B=8 (the shapes
``chip_smoke.py`` times), each beside its plain bfloat16 version and the
library call (``scaled_dot_product_attention`` on the same bfloat16
operands with a bfloat16 dense bias), with ``--kernels`` the device kernels
each launches, then K3's device time a (64-query, 64-key) tile pair at the
key grids 32x32, 20x27, 64x64 and 28x36 (whose rel rows of 32 and 64 floats
put the eight query rows of a warp's fragment in one shared-memory bank).

    python scripts/profile_torch_attention_bwd.py [--tree DIR] [--tree DIR2 ...] [--kernels]
        [--forward [--bf16] | --sass]

Several ``--tree`` arguments run in the given order, one process each
(parent, change, change, parent is the order that shows a drift of the card).
"""

from __future__ import annotations

import argparse
import difflib
import functools
import hashlib
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def time_ms(torch, fn, blocks=7, per_block=10):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(blocks):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(per_block):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_block)
    return sorted(times)[len(times) // 2]


def kernel_table(torch, label, fn, runs=3):
    """The device kernels of ``fn`` under the profiler: name, calls and
    milliseconds per run, longest first."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in kernels) / 1e3 / runs
    print(f"{label} under the profiler: {total:.4f} ms of device time per run")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / runs:9.4f} ms  x{e.count // runs}  {e.key[:150]}")
    return total


def library_backward(torch, qkv, rel_h, rel_w, scale, heads, g):
    """Autograd through one ``scaled_dot_product_attention`` call on K3b's
    operands with the dense bias (dq, dk, dv and the bias gradient)."""
    b, n, _ = qkv.shape
    q, k, v = (t.contiguous() for t in qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4))
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, heads, n, n)
    leaves = [t.detach().requires_grad_() for t in (q, k, v, bias)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves[:3], attn_mask=leaves[3],
                                                           scale=scale)
    g4 = g.view(b, n, heads, -1).transpose(1, 2).contiguous()
    return lambda: torch.autograd.grad(out, leaves, g4, retain_graph=True)


def _short_name(mangled: str) -> str:
    """``_ZN...attention_fwd_tc_kernelILi64ELb0ELi32EEEv...`` → ``attention_fwd_tc_kernel<64, false, 32>``."""
    m = re.search(r"(attention_[a-z0-9_]*?kernel)I((?:L[ib]\d+E)+)E", mangled)
    if not m:
        return mangled
    args = [v if t == "i" else ("true" if v == "1" else "false")
            for t, v in re.findall(r"L([ib])(\d+)E", m.group(2))]
    return f"{m.group(1)}<{', '.join(args)}>"


def sass_report(trees) -> None:
    """Registers, spill and instruction counts of every kernel of each tree's
    csrc/attention_rel.cu, attention_routes.cu and ln_window.cu, and whether
    its SASS equals the first tree's."""
    sys.path.insert(0, str(ROOT))
    from mia_tpu_torch.ops.cuda_build import NVCC_FLAGS, _nvcc

    nvcc = _nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    first = {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, tree in enumerate(trees):
            for source in ("attention_rel.cu", "attention_routes.cu", "ln_window.cu"):
                obj = Path(tmp) / f"{i}.{source}.o"
                src = Path(tree) / "mia_tpu_torch" / "csrc" / source
                log = subprocess.run([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", str(obj),
                                      str(src)], capture_output=True, text=True, check=True).stderr
                usage, name = {}, None
                for line in log.splitlines():
                    m = re.search(r"Compiling entry function '(\S+)'", line)
                    if m:
                        name = _short_name(m.group(1))
                    elif name and "bytes spill stores" in line:
                        usage[name] = [int(line.split("bytes spill stores")[0].split(",")[-1])]
                    elif name and "Used" in line and "registers" in line:
                        usage[name].insert(0, int(re.search(r"Used (\d+) registers", line).group(1)))
                sass, name = {}, None
                dump = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True,
                                      text=True, check=True).stdout
                for line in dump.splitlines():
                    m = re.match(r"\s+Function : (\S+)", line)
                    if m:
                        name = _short_name(m.group(1))
                        sass[name] = []
                    elif name:  # drop the addresses and the column padding
                        sass[name].append(" ".join(re.sub(r"/\*[0-9a-f]{4}\*/", "", line).split()))
                ref = first.setdefault(source, sass)
                print(f"{tree}: csrc/{source}")
                for name in sorted(sass):
                    body = sass[name]
                    regs, spill = usage.get(name, ["?", "?"])
                    # a renamed instance (other template arguments) is matched by its body
                    twin = next((other for other, b in ref.items() if b == body), None)
                    same = ("same SASS as the first tree" if ref.get(name) == body
                            else f"same SASS as the first tree's {twin}" if twin
                            else "not in the first tree" if name not in ref
                            else "SASS differs from the first tree")
                    print(f"  {name}: {regs} registers, {spill} bytes spill, "
                          f"{sum('HMMA.1688.F32.TF32' in x for x in body)} HMMA.1688.F32.TF32, "
                          f"{sum('HMMA.16816.F32.BF16' in x for x in body)} HMMA.16816.F32.BF16, "
                          f"{sum('ATOM' in x for x in body)} ATOM, "
                          f"{sum(('LDL' in x or 'STL' in x) for x in body)} LDL/STL; {same}")
                    if same == "SASS differs from the first tree":  # where it starts to differ
                        diff = difflib.unified_diff(ref[name], body, lineterm="", n=2)
                        for line in list(diff)[2:14]:
                            print(f"    {line}")


def bench_forward(tree: str, kernels: bool = False) -> None:
    import torch

    sys.path.insert(0, tree)
    from mia_tpu_torch.ops import attention

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(2)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    heads, d, ws, side = 12, 64, 14, 32
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    for b in (1, 12):
        qkv3 = randn(b, side * side, 3 * heads * d)
        rel_h, rel_w = (randn(b * heads, side * side, side) for _ in range(2))
        k3_args = (qkv3, rel_h, rel_w, scale, (side, side), heads)
        qkv2 = randn(b * 9, ws * ws, 3 * heads * d)
        k2_args = (qkv2, rh, rw, scale, (ws, ws), heads)
        err3 = float((attention._launch_k3(*k3_args) - attention.attention_rel_packed(*k3_args))
                     .abs().max() / attention.attention_rel_packed(*k3_args).abs().max())
        want2 = attention.attention_rel_packed_ik(*k2_args)
        err2 = float((attention._launch_k2(*k2_args) - want2).abs().max() / want2.abs().max())
        print(f"{tree}: B={b}: K3 within {err3:.3g}, K2 within {err2:.3g} of max |plain|")
        libs = []
        for qkv, (r_h, r_w) in ((qkv3, (rel_h, rel_w)),
                                (qkv2, attention.window_rel_terms(*k2_args[:3], (ws, ws), heads))):
            bb, n, _ = qkv.shape
            q, k, v = (t.contiguous() for t in qkv.view(bb, n, 3, heads, d).permute(2, 0, 3, 1, 4))
            bias = (r_h[:, :, :, None] + r_w[:, :, None, :]).reshape(bb, heads, n, n).contiguous()
            libs.append(lambda q=q, k=k, v=v, bias=bias: sdpa(q, k, v, attn_mask=bias,
                                                                 scale=scale))
        per_block = 20 if b == 1 else 5

        def k3(args=k3_args):
            return attention._launch_k3(*args)

        def k2(args=k2_args):
            return attention._launch_k2(*args)

        for _ in range(2):
            print(f"{tree}: B={b}: K3 {time_ms(torch, k3, per_block=per_block) * 1e3:.2f} us "
                  f"(library {time_ms(torch, libs[0], per_block=per_block) * 1e3:.2f}), "
                  f"K2 {time_ms(torch, k2, per_block=per_block) * 1e3:.2f} us "
                  f"(library {time_ms(torch, libs[1], per_block=per_block) * 1e3:.2f})",
                  flush=True)
        # K7 (a dense bias) and K6 (rel terms) on head-major operands: windows
        # (B·108, 196) and global tokens (B·12, 1024)
        heads_major = {}
        for shape, bh, k_hw in (("windows", b * 9 * heads, (ws, ws)),
                                ("global", b * heads, (side, side))):
            n = k_hw[0] * k_hw[1]
            q, k, v = (randn(bh, n, d) for _ in range(3))
            bias = randn(bh, n, n)
            r6h, r6w = randn(bh, n, k_hw[0]), randn(bh, n, k_hw[1])
            bias6 = (r6h[:, :, :, None] + r6w[:, :, None, :]).reshape(bh, n, n)
            for name, launch, plain, args, lib_bias in (
                    ("K7", attention._launch_k7, attention.attention_dense,
                     (q, k, v, bias, scale), bias),
                    ("K6", attention._launch_k6, attention.attention_rel,
                     (q, k, v, r6h, r6w, scale, k_hw), bias6)):
                want = plain(*args)
                err = float((launch(*args) - want).abs().max() / want.abs().max())
                heads_major[(name, shape)] = (
                    functools.partial(launch, *args), functools.partial(plain, *args),
                    functools.partial(sdpa, q[None], k[None], v[None], attn_mask=lib_bias[None],
                                      scale=scale))
                print(f"{tree}: B={b}: {name} {shape} ({bh}, {n}, {d}) within {err:.3g} of "
                      "max |plain|")
        for _ in range(2):
            print(f"{tree}: B={b}: " + ", ".join(
                f"{name} {shape} {time_ms(torch, fns[0], per_block=per_block) * 1e3:.2f} us "
                f"(plain {time_ms(torch, fns[1], per_block=per_block) * 1e3:.2f}, library "
                f"{time_ms(torch, fns[2], per_block=per_block) * 1e3:.2f})"
                for (name, shape), fns in heads_major.items()), flush=True)
        # K8: windows carved from the (b, 32, 32) token grid; the library call on
        # the partitioned windows with the dense bias, both built beforehand
        grid = randn(b, side, side, 3 * heads * d)
        r8h, r8w = (randn(b * heads, side, side, ws) for _ in range(2))
        k8_args = (grid, r8h, r8w, randn(3, heads * d, scale=0.5), scale, ws, heads)
        want8 = attention.attention_rel_win(*k8_args)
        err8 = float((attention._launch_k8(*k8_args) - want8).abs().max() / want8.abs().max())
        windows, w_h, w_w = attention.partition_rel_win(*k8_args[:4], ws, heads)
        bw, n8, _ = windows.shape
        q8, k8, v8 = (t.contiguous() for t in windows.view(bw, n8, 3, heads, d).permute(2, 0, 3, 1, 4))
        bias8 = (w_h[:, :, :, None] + w_w[:, :, None, :]).reshape(bw, heads, n8, n8).contiguous()
        k8_fns = (functools.partial(attention._launch_k8, *k8_args),
                  functools.partial(attention.attention_rel_win, *k8_args),
                  functools.partial(sdpa, q8, k8, v8, attn_mask=bias8, scale=scale))
        print(f"{tree}: B={b}: K8 ({b}, {side}, {side}) grid, {bw} windows, within {err8:.3g} of "
              "max |plain|")
        for _ in range(2):
            print(f"{tree}: B={b}: K8 {time_ms(torch, k8_fns[0], per_block=per_block) * 1e3:.2f} us "
                  f"(plain {time_ms(torch, k8_fns[1], per_block=per_block) * 1e3:.2f}, library "
                  f"{time_ms(torch, k8_fns[2], per_block=per_block) * 1e3:.2f})", flush=True)
        if kernels:
            kernel_table(torch, f"{tree}: K3 B={b}", k3)
            kernel_table(torch, f"{tree}: K2 B={b}", k2)
            for (name, shape), fns in heads_major.items():
                kernel_table(torch, f"{tree}: {name} {shape} B={b}", fns[0])
            kernel_table(torch, f"{tree}: K8 B={b}", k8_fns[0])
            if b == 1:
                kernel_table(torch, f"{tree}: library at K3's B=1 shape", libs[0])
                kernel_table(torch, f"{tree}: library at K2's B=1 shape", libs[1])


def bench_forward_bf16(tree: str, kernels: bool = False) -> None:
    import torch

    sys.path.insert(0, tree)
    from mia_tpu_torch.ops import attention

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(2)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(shape, generator=gen, device=device)).to(bf)

    heads, d, ws, side = 12, 64, 14, 32
    scale = d ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    for b in (1, 8):
        k3_args = (randn(b, side * side, 3 * heads * d),
                   *(randn(b * heads, side * side, side) for _ in range(2)), scale, (side, side),
                   heads)
        k2_args = (randn(b * 9, ws * ws, 3 * heads * d), rh, rw, scale, (ws, ws), heads)
        fns = {}
        for name, launch, plain, args in (
                ("K3", attention._launch_k3, attention.attention_rel_packed, k3_args),
                ("K2", attention._launch_k2, attention.attention_rel_packed_ik, k2_args)):
            qkv = args[0]
            r_h, r_w = (args[1:3] if name == "K3" else
                        attention.window_rel_terms(*args[:3], args[4], heads))
            bb, n, _ = qkv.shape
            q, k, v = (t.contiguous() for t in qkv.view(bb, n, 3, heads, d).permute(2, 0, 3, 1, 4))
            bias = (r_h[:, :, :, None] + r_w[:, :, None, :]).reshape(bb, heads, n, n).contiguous()
            want = plain(*args)
            err = float((launch(*args) - want).abs().max() / want.abs().max())
            print(f"{tree}: bf16 B={b}: {name} ({bb}, {n}) within {err:.3g} of max |plain|")
            fns[name] = (functools.partial(launch, *args), functools.partial(plain, *args),
                         functools.partial(sdpa, q, k, v, attn_mask=bias, scale=scale))
        per_block = 20 if b == 1 else 5
        for _ in range(2):
            print(f"{tree}: bf16 B={b}: " + ", ".join(
                f"{name} {time_ms(torch, f[0], per_block=per_block) * 1e3:.2f} us (plain "
                f"{time_ms(torch, f[1], per_block=per_block) * 1e3:.2f}, library "
                f"{time_ms(torch, f[2], per_block=per_block) * 1e3:.2f})"
                for name, f in fns.items()), flush=True)
        if kernels:
            for name, f in fns.items():
                kernel_table(torch, f"{tree}: {name} bf16 B={b}", f[0])
                kernel_table(torch, f"{tree}: library at {name}'s bf16 B={b} shape", f[2])
    if kernels:  # K3 at other key grids: device time a (64-query, 64-key) tile pair
        for b, k_hw in ((1, (32, 32)), (2, (20, 27)), (1, (64, 64)), (2, (28, 36))):
            n = k_hw[0] * k_hw[1]
            args = (randn(b, n, 3 * heads * d), randn(b * heads, n, k_hw[0]),
                    randn(b * heads, n, k_hw[1]), scale, k_hw, heads)
            pairs = b * heads * (-(-n // 64)) ** 2
            ms = kernel_table(torch, f"{tree}: K3 bf16 B={b} grid {k_hw[0]}x{k_hw[1]}",
                              functools.partial(attention._launch_k3, *args))
            print(f"{tree}: K3 bf16 grid {k_hw[0]}x{k_hw[1]} B={b}: {pairs} tile pairs, "
                  f"{ms * 1e6 / pairs:.1f} ns a pair")


def bench(tree: str, kernels: bool = False) -> None:
    import torch

    sys.path.insert(0, tree)
    from mia_tpu_torch.ops import attention

    device = torch.device("cuda")
    gen = torch.Generator(device=device)
    gen.manual_seed(3)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    heads, d, ws, side, b = 12, 64, 14, 32, 12
    scale = d ** -0.5
    rh, rw = randn(ws * ws, d, scale=0.1), randn(ws * ws, d, scale=0.1)
    qkv2 = randn(b * 9, ws * ws, 3 * heads * d)
    out2, lse2 = attention._launch_k2(qkv2, rh, rw, scale, (ws, ws), heads, with_lse=True)
    g2 = randn(b * 9, ws * ws, heads * d)
    qkv3 = randn(b, side * side, 3 * heads * d)
    rel_h, rel_w = (randn(b * heads, side * side, side) for _ in range(2))
    out3, lse3 = attention._launch_k3(qkv3, rel_h, rel_w, scale, (side, side), heads,
                                      with_lse=True)
    g3 = randn(b, side * side, heads * d)

    def k2b():
        return attention._launch_k2_bwd(qkv2, rh, rw, out2, g2, lse2, scale, (ws, ws), heads, False)

    def k3b():
        return attention._launch_k3_bwd(qkv3, rel_h, rel_w, out3, g3, lse3, scale, (side, side),
                                        heads)

    want = attention.attention_rel_packed_bwd(qkv3, rel_h, rel_w, out3, g3, scale, (side, side),
                                              heads)
    err = max(float((a - w).abs().max() / w.abs().max()) for a, w in zip(k3b(), want))
    print(f"{tree}: K3b within {err:.3g} of max |plain|")
    want = attention.attention_rel_packed_ik_bwd(qkv2, rh, rw, out2, g2, scale, (ws, ws), heads,
                                                 False)
    err = float((k2b()[0] - want[0]).abs().max() / want[0].abs().max())
    print(f"{tree}: K2b within {err:.3g} of max |plain|")
    # the backward kernels on the plain forward's out and lse, hashed
    q, k, _ = qkv3.view(b, side * side, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias = (rel_h[:, :, :, None] + rel_w[:, :, None, :]).reshape(b, heads, side * side, -1)
    lse3p = torch.logsumexp((q * scale) @ k.transpose(-2, -1) + bias, -1).reshape(b * heads, -1)
    out3p = attention.attention_rel_packed(qkv3, rel_h, rel_w, scale, (side, side), heads)
    r2h, r2w = attention.window_rel_terms(qkv2, rh, rw, (ws, ws), heads)
    q, k, _ = qkv2.view(b * 9, ws * ws, 3, heads, d).permute(2, 0, 3, 1, 4)
    bias = (r2h[:, :, :, None] + r2w[:, :, None, :]).reshape(b * 9, heads, ws * ws, -1)
    lse2p = torch.logsumexp((q * scale) @ k.transpose(-2, -1) + bias, -1).reshape(b * 9 * heads, -1)
    out2p = attention.attention_rel_packed_ik(qkv2, rh, rw, scale, (ws, ws), heads)
    digests = [hashlib.sha1(b"".join(t.cpu().numpy().tobytes() for t in outs)).hexdigest()[:16]
               for outs in (attention._launch_k3_bwd(qkv3, rel_h, rel_w, out3p, g3, lse3p, scale,
                                                     (side, side), heads),
                            attention._launch_k2_bwd(qkv2, rh, rw, out2p, g2, lse2p, scale,
                                                     (ws, ws), heads, True))]
    print(f"{tree}: digests of K3b, K2b (tables) on the plain forward's out and lse: "
          f"{digests[0]}, {digests[1]}")
    for _ in range(2):
        print(f"{tree}: K3b B=12 {time_ms(torch, k3b):.4f} ms, K2b B=12 "
              f"{time_ms(torch, k2b):.4f} ms", flush=True)
    if kernels:
        kernel_table(torch, f"{tree}: K3b B=12", k3b)
        kernel_table(torch, f"{tree}: K2b B=12", k2b)
        kernel_table(torch, f"{tree}: library backward at K3b's B=12 shape",
                     library_backward(torch, qkv3, rel_h, rel_w, scale, heads, g3))
    # K6b on head-major operands: global tokens (B·12, 1024) with K3b's rel
    # terms, and windows (B·108, 196)
    k6b = {}
    for shape, bh, k_hw in (("global", b * heads, (side, side)), ("windows", b * 9 * heads, (ws, ws))):
        n = k_hw[0] * k_hw[1]
        q, k, v, g6 = (randn(bh, n, d) for _ in range(4))
        r6h, r6w = (rel_h, rel_w) if shape == "global" else (randn(bh, n, ws), randn(bh, n, ws))
        out6, lse6 = attention._launch_k6(q, k, v, r6h, r6w, scale, k_hw, with_lse=True)
        args6 = (q, k, v, r6h, r6w, out6, g6, lse6, scale, k_hw)
        want = attention.attention_rel_bwd(q, k, v, r6h, r6w, out6, g6, scale, k_hw)
        err = max(float((a - w).abs().max() / w.abs().max())
                  for a, w in zip(attention._launch_k6_bwd(*args6), want))
        print(f"{tree}: K6b {shape} ({bh}, {n}, {d}) within {err:.3g} of max |plain|")
        k6b[shape] = functools.partial(attention._launch_k6_bwd, *args6)
    for _ in range(2):
        print(f"{tree}: " + ", ".join(f"K6b {shape} B=12 {time_ms(torch, fn, per_block=5):.4f} ms"
                                      for shape, fn in k6b.items()), flush=True)
    if kernels:
        for shape, fn in k6b.items():
            kernel_table(torch, f"{tree}: K6b {shape} B=12", fn)
    if hasattr(attention, "_launch_k8_bwd"):
        grid = randn(b, side, side, 3 * heads * d)
        r8h, r8w = (randn(b * heads, side, side, ws) for _ in range(2))
        bias_kv = randn(3, heads * d)
        out8, lse8 = attention._launch_k8(grid, r8h, r8w, bias_kv, scale, ws, heads, with_lse=True)
        g8 = randn(b, side, side, heads * d)
        ms = time_ms(torch, lambda: attention._launch_k8_bwd(grid, r8h, r8w, bias_kv, out8, g8,
                                                             lse8, scale, ws, heads), per_block=5)
        print(f"{tree}: K8b B=12 {ms:.4f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", help="root of a tree that holds mia_tpu_torch/")
    ap.add_argument("--kernels", action="store_true",
                    help="also list the device kernels of K3b, K2b and the library call")
    ap.add_argument("--forward", action="store_true",
                    help="time the forward kernels K3, K2, K7, K6, K8 and the library call instead")
    ap.add_argument("--bf16", action="store_true",
                    help="with --forward: the bfloat16 instances of K3 and K2")
    ap.add_argument("--sass", action="store_true",
                    help="compile each tree's attention_rel.cu and attention_routes.cu and "
                         "compare registers and SASS")
    ap.add_argument("--one", help=argparse.SUPPRESS)  # the child process of one tree
    args = ap.parse_args(argv)
    if args.sass:
        sass_report(args.tree or [str(ROOT)])
        return 0
    if args.one:
        run = bench_forward_bf16 if args.forward and args.bf16 else bench_forward if args.forward \
            else bench
        run(args.one, args.kernels)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    for tree in args.tree or [str(ROOT)]:
        subprocess.run([sys.executable, __file__, "--one", tree]
                       + (["--kernels"] if args.kernels else [])
                       + (["--forward"] if args.forward else [])
                       + (["--bf16"] if args.bf16 else []), check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
