"""Where the card's and the CPU's BADGE picks part, and why: a probe of
``chip_smoke.py``'s selector phase on one GPU.

Run from the repository root on a machine with a CUDA GPU::

    python3 scripts/probe_selection_ties.py --runs 3

Each run trains the smoke's AL slice UNet (``chip_smoke.slice_phase``: FUGC
at 32..512, 256², 2 rounds of 20 iterations; its training is not bit for
bit the same run to run), picks 8 of the 32 pool cases with ``--active-selector
badge`` on the card with float32 convolutions, and replays the CPU's
selection code on the card's own embeddings (``chip_smoke.CachedScorer``).
It prints both picks, the closest decision from a tie in float64
(``chip_smoke.kmeans_margin``), the centers the k-means++ core chooses from
those embeddings in float32 on the card, in float32 on the CPU and in float64
(distances as sums of squared differences), the largest relative distance of
either device's float32 candidate potentials from float64 along the float64
path, and, at the first step where a device parts from float64, the two
candidates' float64 potentials.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def kpp_steps(torch, x, seed, k, device, dtype):
    """The k-means++ core on ``x`` with the selectors' draws, step by step:
    (first center, [(candidates, their potentials, chosen), ...])."""
    from mia_tpu_torch.activelearning.selection import n_local_trials_for
    from mia_tpu_torch.ops.distance import pairwise_distances

    gen = torch.Generator().manual_seed(seed)
    u_first = torch.rand((), generator=gen)
    uniforms = torch.rand((k - 1, n_local_trials_for(k)), generator=gen).to(device, dtype)
    x = x.to(device, dtype)
    n = x.shape[0]
    w = torch.full((n,), 1.0 / n, device=device, dtype=dtype)
    cum = torch.cumsum(w, 0)
    first = torch.searchsorted(cum, u_first.to(device, dtype) * cum[-1]).clamp(0, n - 1)
    if dtype == torch.float64:
        d2 = (x[:, None, :] - x[None, :, :]).square().sum(-1)
    else:
        d2 = pairwise_distances(x, x, "l2").square()  # as the selection computes it
    closest, steps = d2[first], []
    for u in uniforms:
        pot = w * closest
        cand = torch.searchsorted(torch.cumsum(pot, 0), u * pot.sum()).clamp(0, n - 1)
        new_pot = (w[None, :] * torch.minimum(closest[None, :], d2[cand])).sum(1)
        chosen = cand[torch.argmin(new_pot)]
        closest = torch.minimum(closest, d2[chosen])
        steps.append((cand.tolist(), new_pot.double().cpu().tolist(), int(chosen)))
    return int(first), steps


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args(argv)

    import torch

    import chip_smoke as cs
    from mia_tpu_torch.activelearning import SELECTORS, ModelScorer, sweep_pool
    from mia_tpu_torch.models import UNet
    from mia_tpu_torch.ops import cuda_build

    if not torch.cuda.is_available():
        print("probe_selection_ties: a CUDA GPU is required", file=sys.stderr)
        return 2
    device, cpu, seed, budget = torch.device("cuda", 0), torch.device("cpu"), 1338, 8
    print(cs.card_line())
    cuda_build.load_library()
    for run in range(args.runs):
        with tempfile.TemporaryDirectory(prefix="probe_ties_") as tmp:
            trainer = cs.slice_phase(torch, Path(tmp))["trainer"]
            active = trainer.active_dataset
            cpu_model = UNet(trainer.model.cfg)
            cpu_model.load_state_dict({k: v.cpu() for k, v in trainer.model.state_dict().items()})
            host = ModelScorer(cpu_model, cpu, normalize=True)
            selector = SELECTORS["badge"](batch_size=8)
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                kept = cs.CachedScorer(torch, ModelScorer(trainer.model, device, normalize=True))
                got = selector.select_next_batch(active, budget, kept, seed=seed)
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            want = selector.select_next_batch(active, budget, host, seed=seed)
            replay = kept.replay_on_cpu()
            again = selector.select_next_batch(active, budget, replay, seed=seed)
            emb = torch.from_numpy(sweep_pool(active.get_pool_dataset(), 8,
                                              replay.badge_grad_embedding, cpu)[0])
            paths = {name: kpp_steps(torch, emb, seed, budget, dev, dt) for name, dev, dt in (
                ("card f32", device, torch.float32), ("CPU f32", cpu, torch.float32),
                ("f64", cpu, torch.float64))}
            ref = paths["f64"][1]
            print(f"run {run}: card {got}\n  CPU {want}\n  CPU on the card's embeddings {again}")
            print(f"  closest decision on the card's embeddings (float64): "
                  f"{cs.kmeans_margin(torch, emb, seed, budget):.3g}")
            for name, (first, steps) in paths.items():
                print(f"  {name}: centers {[first] + [s[2] for s in steps]}")
            for name in ("card f32", "CPU f32"):
                steps, worst = paths[name][1], 0.0
                for s, (cand, pot, chosen) in enumerate(steps):
                    worst = max(worst, max(abs(a - b) / b for a, b in zip(pot, ref[s][1])))
                    if chosen != ref[s][2]:
                        alt = {c: p for c, p in zip(ref[s][0], ref[s][1])}
                        print(f"  {name} parts from float64 at step {s + 1}: candidate "
                              f"{chosen} at {alt[chosen]!r}, float64's {ref[s][2]} at "
                              f"{alt[ref[s][2]]!r}")
                        break
                print(f"  {name}: candidate potentials up to {worst:.3g} from float64 "
                      f"(relative) up to that step")
            del trainer, kept, cpu_model
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
