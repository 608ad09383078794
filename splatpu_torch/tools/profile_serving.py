"""Where a served timestep's time goes, on the card.

    python -m splatpu_torch.tools.profile_serving [--timesteps 150]

Serves config 3 (the 100,585-Gaussian cloud and the config3_100k_r5 network,
five 1280x720 orbit views) by calling ``run_inference`` itself under
``torch.profiler``, after a 2-timestep warm-up rollout, so the loop that is
profiled is the loop that is served.  Prints the wall time per timestep,
the host time of each stage (the ``rollout``, ``render``, ``flags`` and
``frames`` ranges that ``run_inference`` marks), the device time by kernel,
and the device's busy and idle share of the window.  Per-timestep figures
divide by the rollout's timesteps plus the t=0 frame.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
from splatpu_torch.io.checkpoint import load_cloud, load_stage2_run
from splatpu_torch.train.inference import run_inference
from splatpu_torch.train.stage2 import Stage2Config, compact_cloud

ROOT = Path(__file__).resolve().parents[2]
STAGES = ("rollout", "render", "flags", "frames")


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--timesteps", type=int, default=150)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda")
    net, head = load_stage2_run(ROOT / "runs" / "config3_100k_r5", device=dev)
    config = Stage2Config(timestep_count=args.timesteps, quirk_compat=head["quirk_compat"])
    cloud = compact_cloud(load_cloud(ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz", dev))
    enc = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat)

    run_inference(net, cloud, enc, dataclasses.replace(config, timestep_count=2), device=dev)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        _, stats = run_inference(net, cloud, enc, config, device=dev)
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end)
    steps = args.timesteps + 1
    events = prof.key_averages()
    print(f"card: {torch.cuda.get_device_name(0)}")
    print(f"wall per timestep (CUDA events): {wall_ms / steps:.3f} ms over {steps} timesteps"
          f" ({args.timesteps} rollout steps + t=0), {stats['renders']} renders,"
          f" {stats['growths']} growths")
    cuda = torch.autograd.DeviceType.CUDA
    for ev in events:
        if ev.key in STAGES and ev.device_type != cuda:
            print(f"  host {ev.key:8s} {ev.cpu_time_total / 1e3 / steps:9.3f} ms/timestep"
                  f" ({ev.count} calls)")
    # Device work only: the stage ranges also appear on the device timeline
    # and would count their kernels twice.
    kernels = [ev for ev in events if ev.device_type == cuda and ev.key not in STAGES]
    dev_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3
    print(f"device busy {dev_ms / steps:.3f} ms/timestep "
          f"({100 * dev_ms / wall_ms:.1f}% of wall; idle {100 - 100 * dev_ms / wall_ms:.1f}%)")
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {ev.self_device_time_total / 1e3 / steps:8.3f} ms/timestep"
              f" x{ev.count / steps:7.1f}  {ev.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
