"""Where a stage-2 training step's time goes, on the card.

    python -m splatpu_torch.tools.profile_training [--timesteps 8] [--iterations 2]
                                                   [--path grid|manual|padded]

Trains config 3 (the 100,585-Gaussian cloud, the config3_100k_r5 network
with a fresh Adam, five 1280x720 views per step, uint8 targets rendered from
the cloud moved as in the config-3 run, ``splatpu_torch.tools.train_scene``)
by calling ``train`` itself under ``torch.profiler``, after a one-timestep
warm-up run.  Prints the steps' wall time (CUDA events), the host time of
each stage (the ``deform``, ``render``, ``loss``, ``backward``, ``adam`` and
``snapshot`` ranges of the step) and the device time by kernel inside the
steps' windows (each ``train_step`` range, which ends when the step is
enqueued: a kernel that starts after its step's range has ended is not
counted).  Setup (kNN graph,
encodings, staging) is outside those windows.  ``--path`` picks the render path: K1/K2 (``grid``, the default),
K4 (``manual``, through ``binning_overrides``) or K5 (``padded``:
``renderer="cuda_padded"`` with a budget measured at 16 px tiles over the
first timestep's cameras).
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from splatpu_torch.core.types import Camera, activate_cloud
from splatpu_torch.io.checkpoint import load_cloud, load_stage2_run
from splatpu_torch.render.api import demand_binning, measure_binning_demand
from splatpu_torch.tools.train_scene import render_targets
from splatpu_torch.train.stage2 import Stage2Config, compact_cloud, train

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("deform", "render", "loss", "backward", "adam", "snapshot")
STEP = "train_step"
HEAD = ("delta_scale", "double_residual", "zero_init_head", "time_gate_head")


class _Log:
    def __init__(self):
        self.step_ms = []

    def log(self, metrics, step):
        if "step_ms" in metrics:
            self.step_ms.append(float(metrics["step_ms"]))

    def flush(self):
        pass


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--timesteps", type=int, default=8)
    p.add_argument("--iterations", type=int, default=2)
    p.add_argument("--path", choices=("grid", "manual", "padded"), default="grid")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    run = ROOT / "runs" / "config3_100k_r5"
    net, head = load_stage2_run(run, device=dev)
    cloud = compact_cloud(load_cloud(ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz", dev))
    views = render_targets(cloud, args.timesteps, impl="cuda", device=dev)
    config = Stage2Config(
        total_iterations=args.iterations, warmup_iterations=1, learning_rate=head["lr"],
        hidden_dim=net.config.hidden_dim, residual_blocks=net.config.residual_blocks,
        timestep_count=args.timesteps, renderer="cuda", quirk_compat=head["quirk_compat"],
        view_staging="device_u8", timestep_order="shuffled", **{k: head[k] for k in HEAD},
    )
    if args.path == "manual":
        config = dataclasses.replace(config, binning_overrides={"kernel": "manual"})
    elif args.path == "padded":
        cams = Camera(w2c=torch.stack([torch.from_numpy(v.w2c) for v in views[0]]).float().to(dev),
                      K=torch.stack([torch.from_numpy(v.K) for v in views[0]]).float().to(dev),
                      width=views[0][0].width, height=views[0][0].height)
        demand = measure_binning_demand(activate_cloud(cloud), cams, tile=16)
        config = dataclasses.replace(config, renderer="cuda_padded", binning=demand_binning(
            *demand, tile=16, headroom=config.binning_headroom))
    warm = dataclasses.replace(config, total_iterations=1, timestep_count=1)
    train(cloud, views[:1], warm, initial_net=load_stage2_run(run, device=dev)[0], device=dev)
    torch.cuda.synchronize()
    log = _Log()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        train(cloud, views, config, logger=log, initial_net=net, device=dev)
        torch.cuda.synchronize()
    steps = len(log.step_ms)
    wall_ms = sum(log.step_ms)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    windows = sorted(
        (e.time_range.start, e.time_range.end) for e in events
        if e.name == STEP and e.device_type != cuda
    )
    if len(windows) != steps:
        raise SystemExit(f"found {len(windows)} {STEP} ranges for {steps} steps")

    def in_steps(t):
        return any(a <= t <= b for a, b in windows)

    # Device work only: the ranges also appear on the device timeline and
    # would count their kernels twice.
    kernels = {}
    for e in events:
        if e.device_type == cuda and e.name not in STAGES + (STEP,) and in_steps(e.time_range.start):
            tot, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    window_ms = sum(b - a for a, b in windows) / 1e3
    print(f"card: {torch.cuda.get_device_name(0)}; path {args.path}")
    print(f"steps {steps}: wall per step (CUDA events) {wall_ms / steps:.3f} ms;"
          f" profiled step windows {window_ms / steps:.3f} ms per step")
    for ev in prof.key_averages():
        if ev.key in STAGES and ev.device_type != cuda:
            print(f"  host {ev.key:9s} {ev.cpu_time_total / 1e3 / steps:9.3f} ms/step"
                  f" ({ev.count} calls)")
    for name, (tot, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:18]:
        print(f"  {tot / 1e3 / steps:8.3f} ms/step x{n / steps:7.1f}  {name[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
