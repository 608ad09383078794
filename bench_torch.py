#!/usr/bin/env python3
"""Benchmark of the PyTorch port: the differentiable renderer's forward +
backward ms per frame, ``bench.py``'s workload on an NVIDIA GPU.

    python3 bench_torch.py [--chained N] [--profile N] [--device cpu]

One forward and backward of ``render(impl="pallas")`` (on a card: exact
binning, the forward composite K1, the backward composite K2 and the
routing kernel) over ``make_random_cloud(prng.key(0), 100000, extent=1.2,
scale_range=(0.005, 0.02))`` (the JAX package's draw) seen by a look-at
camera from (0, 0, -4) at 1280x720 with ``default_config(n)``'s budget.
The loss is mean |image - 0| + 0.1 mean depth; the gradients are taken
with respect to the means, colours, quaternions, opacity logits and log
scales.  Timing as in ``bench.py`` (``obs.profiling.time_fn``, the JAX
package's ``time_fn``): 3 warm-up calls, then 10 timed calls in two
batches, each read on the host clock from a synchronised card to the
completion of its last call, the means shifted by i * 1e-7 in call i; then
chains of 8 frames, each frame's means moved by 1e-12 times the last
frame's mean gradient, timed as one unit each (2 warm-up chains, 4 timed).
One untimed call before them reads the overflow and the pair count.

Prints the card's name and power limit, the per-call mean and spread (and
the first call's seconds, the kernels' build included, apart), each
kernel's launches over the run, whether the render overflowed its pair
budget and whether the kernels came from the persistent cache
(``obs/cache.py``, on for a card as in ``bench.py``), then as its last
line ``bench.py``'s JSON object (the same keys, ``vs_baseline`` against the
same nominal 10 ms).  ``--chained N`` adds a
second JSON line for chains of N frames, as ``bench.py`` does.
``--profile N`` first prints the card's busy share and its kernels over N
calls under ``torch.profiler``.

``--device cpu`` runs ``bench.py``'s size off the TPU (2,000 Gaussians at
256x256) through the plain PyTorch versions of the kernels.  Without a card
and without ``--device cpu`` the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from splatpu_torch import _build
from splatpu_torch.core import prng
from splatpu_torch.core.types import activate_cloud
from splatpu_torch.data.synthetic import make_lookat_camera, make_random_cloud
from splatpu_torch.obs.cache import enable_compilation_cache
from splatpu_torch.obs.profiling import launch_counts, time_fn
from splatpu_torch.render.api import default_config, render

BASELINE_MS = 10.0
N_GAUSSIANS = 100_000
WIDTH, HEIGHT = 1280, 720
CPU_GAUSSIANS = 2_000
CPU_SIZE = (256, 256)
WARMUP = 2
ITERS = 10
CHAIN = 8
CHAIN_WARMUP, CHAIN_ITERS = 1, 4
GRADS = ("means", "colors", "rotation_quaternions", "opacity_logits", "log_scales")


def scene(device):
    """(cloud, camera, budget) of the bench at ``device``'s size."""
    on_card = torch.device(device).type == "cuda"
    n = N_GAUSSIANS if on_card else CPU_GAUSSIANS
    w, h = (WIDTH, HEIGHT) if on_card else CPU_SIZE
    cloud = make_random_cloud(prng.key(0), n, extent=1.2, scale_range=(0.005, 0.02),
                              device=device)
    cam = make_lookat_camera(eye=(0, 0, -4.0), width=w, height=h, focal=0.8 * w, device=device)
    return cloud, cam, default_config(n)


def loss_and_grads(cloud, params, camera, config, target, impl="pallas"):
    """``bench.py``'s loss of ``cloud`` with ``params`` in place:
    (loss, render output, gradients by parameter name)."""
    leaves = {k: params[k].detach().requires_grad_(True) for k in GRADS}
    out = render(activate_cloud(cloud.replace(**{**params, **leaves})), camera, impl=impl,
                 config=config)
    loss = (out.image - target).abs().mean() + 0.1 * out.depth.mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), out, dict(zip(GRADS, grads))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True,
    ).stdout.strip().splitlines()[0]


def busy_share(fn, calls: int) -> None:
    """Print the card's busy share of ``calls`` calls of ``fn`` under
    ``torch.profiler`` and the kernels that take most of it."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
    wall_ms = start.elapsed_time(end) / calls
    kernels = [ev for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(ev.self_device_time_total for ev in kernels) / 1e3 / calls
    print(f"profiled {calls} calls: {wall_ms:.3f} ms per call (CUDA events), card busy"
          f" {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%; idle"
          f" {100 - 100 * busy_ms / wall_ms:.1f}%)", flush=True)
    for ev in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {ev.self_device_time_total / 1e3 / calls:8.3f} ms per call"
              f" x{ev.count / calls:6.1f}  {ev.key[:90]}", flush=True)


def main(chained: int = 0, device=None, profile: int = 0) -> dict:
    """Run the bench on ``device`` (the card unless given) and print its
    lines; returns the headline numbers and the run's launches."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device (torch.cuda.is_available() is false);"
                         " pass --device cpu for bench.py's CPU size")
    if profile and device.type != "cuda":
        raise SystemExit("bench_torch: --profile reads the card's busy share; it needs the card")
    if device.type == "cuda":
        enable_compilation_cache()
    before = launch_counts()
    cloud, cam, config = scene(device)
    target = torch.zeros((3, cam.height, cam.width), device=device)
    params = cloud.param_dict()

    def fwd_bwd(p):
        return loss_and_grads(cloud, p, cam, config, target)[2]

    def shifted(i):
        """Call i's inputs: the means moved by i * 1e-7."""
        return (dict(params, means=params["means"] + i * 1e-7),)

    def chain(n):
        """n frames, each frame's means moved by 1e-12 of the last gradient."""
        def run(p):
            means = p["means"]
            for _ in range(n):
                means = means + 1e-12 * fwd_bwd(dict(p, means=means))["means"]
            return means
        return run

    t0 = time.perf_counter()
    _, out, _ = loss_and_grads(cloud, params, cam, config, target)
    overflowed, pairs = bool(out.overflowed.any()), int(out.total_pairs.max())
    first_s = time.perf_counter() - t0
    del out
    if profile:
        busy_share(lambda: fwd_bwd(params), profile)
    stats = time_fn(fwd_bwd, warmup=WARMUP, iters=ITERS, args_fn=shifted, device=device)
    ms = stats["mean_ms"]
    def chain_ms(n):
        return time_fn(chain(n), warmup=CHAIN_WARMUP, iters=CHAIN_ITERS, args_fn=shifted,
                       device=device)["mean_ms"] / n

    cms8 = chain_ms(CHAIN)
    cms = chain_ms(chained) if chained else None
    launches = {k: n - before[k] for k, n in launch_counts().items()}

    print(card_line() if device.type == "cuda" else "device: cpu (plain versions)", flush=True)
    print(f"{cloud.capacity} Gaussians, {cam.width}x{cam.height}, tile {config.tile}, pairs"
          f" {pairs} of max_pairs {config.max_pairs}: per call mean {ms:.3f} ms, spread"
          f" {stats['spread_ms']:.3f} ms ({stats['timer']}); the first call {first_s:.2f} s"
          f" (a kernel build, where one runs, included)", flush=True)
    print(f"launches {json.dumps(launches)}", flush=True)
    print(f"overflowed {json.dumps(overflowed)}", flush=True)
    if device.type == "cuda":
        print(f"kernels: build_cached {json.dumps(_build.build_cached)}, loaded in"
              f" {_build.build_seconds:.2f} s ({_build.library_path()})", flush=True)
    line = {
        "metric": "rasterize_fwd_bwd_ms_per_frame",
        "value": round(ms, 3),
        "unit": "ms",
        "vs_baseline": round(BASELINE_MS / ms, 4),
        "chained_ms_per_frame": round(cms8, 3),
        "chain_length": CHAIN,
        "vs_baseline_chained": round(BASELINE_MS / cms8, 4),
    }
    print(json.dumps(line), flush=True)
    if chained:
        print(json.dumps({
            "metric": "rasterize_fwd_bwd_ms_per_frame_chained",
            "value": round(cms, 3),
            "unit": "ms",
            "chain_length": chained,
            "vs_baseline": round(BASELINE_MS / cms, 4),
        }), flush=True)
    return dict(line, ms=ms, spread_ms=stats["spread_ms"], timer=stats["timer"],
                chained_ms=cms, launches=launches, overflowed=overflowed)


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--chained", type=int, nargs="?", const=8, default=0)
    p.add_argument("--profile", type=int, default=0)
    p.add_argument("--device", default=None)
    a = p.parse_args()
    main(chained=a.chained, device=a.device, profile=a.profile)
