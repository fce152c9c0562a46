"""Concurrent builds of the port's native libraries.

Two builds that share a process id (as processes in different pid
namespaces over one checkout do) must both end with the library built and
loaded: each compiles into a temporary file or directory of its own and
publishes it with ``os.replace``. A real build failure keeps its behaviour:
the host decoder reports why, ``cuda_build`` raises with nvcc's stderr.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
SHARED_PID = 765


def _run_concurrently(script: str, n: int) -> list[dict]:
    """Run ``n`` interpreters on ``script``; each prints one JSON line.

    The script's imports happen first; then each waits for one common start
    time, so that the builds overlap."""
    start = time.time() + 6.0
    script = script.replace("WAIT_FOR_START", f"time.sleep(max(0.0, {start} - time.time()))")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs = [subprocess.Popen([sys.executable, "-c", script], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    results = []
    for proc in procs:
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    return results


def test_host_library_builds_sharing_a_pid_all_load(tmp_path):
    script = textwrap.dedent(f"""
        import json, os, pathlib, time
        os.getpid = lambda: {SHARED_PID}
        import mia_tpu_torch.native as native
        native._BUILD_DIR = pathlib.Path({str(tmp_path)!r})
        WAIT_FOR_START
        ok = native.is_available()
        print(json.dumps({{"ok": ok, "reason": native.unavailable_reason()}}))
    """)
    results = _run_concurrently(script, 4)
    reasons = {r["reason"] for r in results}
    if not any(r["ok"] for r in results):  # no g++ or no libpng here: all say why
        assert all(r.startswith("g++ failed") for r in reasons), reasons
        return
    assert all(r["ok"] for r in results), results
    assert reasons == {None}
    assert [p.suffix for p in tmp_path.iterdir()] == [".so"]  # no temporary file left


def test_host_library_build_failure_says_why(tmp_path, monkeypatch):
    import mia_tpu_torch.native as native

    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_CMD", ("g++", "-include", "no_such_header.h", "-shared",
                                         "{src}", "-o", "{out}"))
    native._load.cache_clear()
    try:
        assert not native.is_available()
        assert native.unavailable_reason().startswith("g++ failed")
    finally:
        native._load.cache_clear()
    assert list(tmp_path.iterdir()) == []


def _nvcc_stub(tmp_path: Path, body: str) -> Path:
    stub = tmp_path / "nvcc"
    stub.write_text(f"#!{sys.executable}\nimport sys, time\nargs = sys.argv[1:]\n{body}\n")
    stub.chmod(0o755)
    return stub


WRITE_OUTPUT = "time.sleep(0.3)\nopen(args[args.index('-o') + 1], 'w').write(' '.join(args))"


def test_kernel_library_builds_sharing_a_pid_all_publish(tmp_path):
    stub = _nvcc_stub(tmp_path, WRITE_OUTPUT)
    build = tmp_path / "build"
    script = textwrap.dedent(f"""
        import json, os, pathlib, time
        os.getpid = lambda: {SHARED_PID}
        from mia_tpu_torch.ops import cuda_build
        cuda_build._nvcc = lambda: {str(stub)!r}
        out = pathlib.Path({str(build)!r}) / "libmia_kernels_test.so"
        WAIT_FOR_START
        cuda_build._build(out)
        print(json.dumps({{"built": out.is_file()}}))
    """)
    results = _run_concurrently(script, 4)
    assert all(r["built"] for r in results), results
    assert [p.name for p in build.iterdir()] == ["libmia_kernels_test.so"]
    assert "-shared" in (build / "libmia_kernels_test.so").read_text()


def test_kernel_library_build_failure_raises_with_stderr(tmp_path, monkeypatch):
    from mia_tpu_torch.ops import cuda_build

    stub = _nvcc_stub(tmp_path, "sys.stderr.write('error: no such intrinsic')\nsys.exit(2)")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(stub))
    out = tmp_path / "build" / "libmia_kernels_test.so"
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        cuda_build._build(out)
    assert list(out.parent.iterdir()) == []
