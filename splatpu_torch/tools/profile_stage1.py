"""Where a stage-1 iteration's time goes, on the card.

    python -m splatpu_torch.tools.profile_stage1 [--iterations 60] [--views-per-step 1]

Fits BASELINE config 2 (``splatpu_torch.tools.train_scene``: the 27 rig
cameras at 1280x720, image and segmentation targets rendered from the
config-3 cloud, every third of its Gaussians as the initial points,
capacity factor 6.0) by calling ``fit`` itself under ``torch.profiler``,
after a warm-up fit of a few iterations.  No mutation falls in the window
(the first is at 500).  Prints the iterations' wall time, the host time of
each stage (the ``render``, ``loss``, ``backward`` and ``adam`` ranges),
and the device time by kernel inside the window from the first
iteration's start to the end of the last one's device work.  Set-up (kNN,
staging) is outside the window.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from splatpu_torch.io.checkpoint import load_cloud
from splatpu_torch.tools.train_scene import (
    render_stage1_targets,
    rig_scene_radius,
    stage1_points,
)
from splatpu_torch.train.stage1 import Stage1Config, fit
from splatpu_torch.train.stage2 import compact_cloud

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("render", "loss", "backward", "adam")
ITERATION = "stage1_iteration"


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--iterations", type=int, default=60)
    p.add_argument("--views-per-step", type=int, default=1)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    truth = compact_cloud(load_cloud(ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz", dev))
    views = render_stage1_targets(truth, impl="cuda", device=dev)
    pc, radius = stage1_points(truth), rig_scene_radius()
    config = Stage1Config(iterations=args.iterations, capacity_factor=6.0, renderer="cuda",
                          views_per_step=args.views_per_step)
    fit(pc, views, radius, Stage1Config(iterations=5, capacity_factor=6.0, renderer="cuda",
                                        views_per_step=args.views_per_step), device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit(pc, views, radius, config, device=dev)
        torch.cuda.synchronize()
        fit_ms = 1e3 * (time.perf_counter() - t0)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    its = sorted((e.time_range.start, e.time_range.end) for e in events
                 if e.name == ITERATION and e.device_type != cuda)
    if len(its) != args.iterations:
        raise SystemExit(f"found {len(its)} {ITERATION} ranges for {args.iterations} iterations")
    kernels, last_end = {}, its[-1][1]
    for e in events:
        if (e.device_type == cuda and e.name not in STAGES + (ITERATION,)
                and e.time_range.start >= its[0][0]):
            tot, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
            last_end = max(last_end, e.time_range.end)
    n = args.iterations
    window_ms = (last_end - its[0][0]) / 1e3
    host_ms = sum(b - a for a, b in its) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}; config 2, {args.views_per_step} view(s) per"
          f" iteration, {n} iterations")
    print(f"fit (set-up included) {fit_ms:.1f} ms; window {window_ms / n:.3f} ms per iteration;"
          f" host inside the iteration ranges {host_ms / n:.3f} ms per iteration")
    for ev in prof.key_averages():
        if ev.key in STAGES and ev.device_type != cuda:
            print(f"  host {ev.key:9s} {ev.cpu_time_total / 1e3 / n:9.3f} ms/iteration"
                  f" ({ev.count} calls)")
    for name, (tot, count) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:18]:
        print(f"  {tot / 1e3 / n:8.3f} ms/iteration x{count / n:7.1f}  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
