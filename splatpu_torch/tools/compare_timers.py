"""The bench's per-call time under this tree's ``obs.profiling.time_fn``
beside an earlier tree's, on one card, in one process, in turns.

    python -m splatpu_torch.tools.compare_timers OTHER_ROOT [--device cpu]

``OTHER_ROOT`` holds a checkout of an earlier commit (``git archive``);
its ``splatpu_torch/obs/profiling.py`` is loaded from there as a module of
its own (which imports the rest of the port from this tree), and its
``time_fn`` times the same calls as this tree's.  The calls are
``bench_torch.py``'s: one forward + backward of its 100,000-Gaussian
scene at 1280x720 (on a card: K1, K2 and the routing), the means shifted
by i * 1e-7 in call i, with ``bench_torch``'s warm-up and iterations.
After one untimed call (the kernels' build), each of ``ROUNDS`` rounds
runs (other, this, this, other).  Prints every run's mean, spread and
timer, then the card's name and power limit, and last a JSON line with
each timer's runs and mean, their difference and the largest spread.
``--device cpu`` runs bench_torch's CPU size through the plain versions.
Run it from the repository's root (it imports ``bench_torch``).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
from pathlib import Path

import torch

from splatpu_torch.obs.profiling import time_fn

ROUNDS = 2
ORDER = ("other", "this", "this", "other")


def other_time_fn(other_root: Path):
    """``time_fn`` of ``other_root``'s ``splatpu_torch/obs/profiling.py``."""
    path = Path(other_root) / "splatpu_torch" / "obs" / "profiling.py"
    spec = importlib.util.spec_from_file_location("other_tree_profiling", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.time_fn


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other_root", type=Path)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    import bench_torch

    dev = torch.device(a.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("compare_timers: no CUDA device; pass --device cpu")
    timers = {"other": other_time_fn(a.other_root), "this": time_fn}
    cloud, cam, config = bench_torch.scene(dev)
    target = torch.zeros((3, cam.height, cam.width), device=dev)
    params = cloud.param_dict()

    def fwd_bwd(q):
        return bench_torch.loss_and_grads(cloud, q, cam, config, target)[2]

    def shifted(i):
        return (dict(params, means=params["means"] + i * 1e-7),)

    fwd_bwd(params)
    runs = {name: [] for name in timers}
    for _ in range(ROUNDS):
        for name in ORDER:
            stats = timers[name](fwd_bwd, warmup=bench_torch.WARMUP, iters=bench_torch.ITERS,
                                 args_fn=shifted, device=dev)
            runs[name].append(stats)
            print(f"  {name}: mean {stats['mean_ms']:.4f} ms, spread {stats['spread_ms']:.4f}"
                  f" ms ({stats['timer']})", flush=True)
    print(bench_torch.card_line() if dev.type == "cuda" else "device: cpu (plain versions)",
          flush=True)
    summary = {name: {"timer": r[0]["timer"], "means_ms": [s["mean_ms"] for s in r],
                      "spreads_ms": [s["spread_ms"] for s in r],
                      "mean_ms": statistics.mean(s["mean_ms"] for s in r)}
               for name, r in runs.items()}
    summary["this_minus_other_ms"] = summary["this"]["mean_ms"] - summary["other"]["mean_ms"]
    summary["largest_spread_ms"] = max(s["spread_ms"] for r in runs.values() for s in r)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
