"""Count how often the demo's k-means++ picks differ between the card and the CPU.

Runs ``chip_smoke.py``'s AL slice phase once (its trained round-0 model feeds
the demo), then the demo phase ``--runs`` times, in turns with the port's
``ops/distance.py::pairwise_distances`` and with the uncentred float32
expansion |x|² + |y|² − 2x·y (the JAX package's form). Each demo run trains
a grayscale ``al_train_torch`` model, serves it on the card and on the CPU
and compares the 10 ``active_select`` picks of the two sessions (the phase
prints "picks equal" or how far the CPU's closest decision lies from a tie).

    python scripts/profile_torch_demo_picks.py [--runs 3]

Prints one ``picks:`` line a demo run and the card's name and power limit.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def uncentred(orig):
    """``pairwise_distances`` with the l2 expansion on the points as given."""
    import torch

    def pairwise(x, y=None, metric="l2"):
        if metric not in ("l2", "euclidean"):
            return orig(x, y, metric)
        x = x.to(torch.float32)
        y = x if y is None else y.to(torch.float32)
        d2 = (x * x).sum(1, keepdim=True) + (y * y).sum(1, keepdim=True).T \
            - 2.0 * torch.matmul(x, y.T)
        return torch.sqrt(d2.clamp_min(0.0))
    return pairwise


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3, help="demo runs of each form")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from mia_tpu_torch.activelearning import selection, selectors
    from mia_tpu_torch.ops import cuda_build, distance

    cuda_build.load_library()
    forms = {"port": distance.pairwise_distances,
             "uncentred": uncentred(distance.pairwise_distances)}
    device = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="demo_picks_") as tmp:
        with contextlib.redirect_stdout(io.StringIO()):
            sl = cs.slice_phase(torch, Path(tmp))
        for i in range(args.runs):
            for name, fn in forms.items():
                for module in (distance, selection, selectors):
                    module.pairwise_distances = fn
                out = io.StringIO()
                try:
                    with contextlib.redirect_stdout(out):
                        cs.demo_phase(torch, device, Path(tmp) / f"run{i}_{name}", sl)
                    verdict = next(line.split("; ")[1] for line in out.getvalue().splitlines()
                                   if line.startswith("demo: card vs CPU"))
                except cs.SmokeFailure as e:
                    verdict = f"check failed: {str(e)[-90:]}"
                print(f"picks: run {i}, {name}: {verdict}", flush=True)
        for module in (distance, selection, selectors):
            module.pairwise_distances = forms["port"]
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
