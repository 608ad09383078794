#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printed with its wall time and bounded by a watchdog:

1. device: require CUDA; print the card's name and power limit.
2. build: compile ``splatpu_torch/csrc/*.cu`` with nvcc (ptxas lines shown).
3. compare: the forward-composite kernel against its plain PyTorch version on
   the real 100,585-Gaussian cloud, five orbit cameras at 320x180, one launch.
4. serve: ``run_inference`` at full width: the config-3 checkpoint's network
   (hidden 128, 3 blocks, head settings from its stage2_result.json), the
   real cloud, 150 timesteps plus t=0, five 1280x720 views per timestep
   through the kernel.  The kernel's launch count is zeroed just before and
   read just after.
5. measure: at the served shapes (the t=0 frame's inputs), the kernel
   against its plain version, CUDA-event times of both, and the kernel's
   bound from this run's bytes and the work its data needs.

Prints one ``{"kernels": [...]}`` JSON line, then the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; nothing is
caught and continued.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import faulthandler
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
RUN = ROOT / "runs" / "config3_100k_r5"
TIMESTEPS = 150
SERVE_SIZE = (1280, 720)
COMPARE_SIZE = (320, 180)
TOL = {"image": 2e-5, "depth": 2e-4, "final_T": 2e-5}
LAST_MATCH_MIN = 0.9999

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_S = 3.35e12
# FP32 operations per evaluated (pixel, pair): dx, dy (2), the quadratic form
# (9), exp (1), opacity scale (1), min (1), two cut tests (2).  Per
# contribution: 1 - alpha, T * (1 - alpha), the T test, w = alpha * T, and a
# multiply-add per colour channel and for depth (2 each).
OPS_PER_EVAL = 16


def ops_per_contribution(c: int) -> int:
    return 4 + 2 * (c + 1)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


@contextlib.contextmanager
def phase(name: str, budget_s: int):
    """Print the phase's wall time; kill the process if it outlives budget_s
    (a watchdog thread, so a hang inside CUDA is bounded too)."""
    faulthandler.dump_traceback_later(budget_s, exit=True)
    t0 = time.perf_counter()
    print(f"[{name}] start", flush=True)
    yield
    faulthandler.cancel_dump_traceback_later()
    print(f"[{name}] done in {time.perf_counter() - t0:.2f} s", flush=True)


def cuda_ms(fn, reps: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got, ref) -> dict:
    import torch

    for name, a in zip(("image", "depth", "final_T"), got[:3]):
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name} has non-finite values")
    err = {k: float((a - b).abs().max()) for k, a, b in zip(TOL, got[:3], ref[:3])}
    err["last_match"] = float((got[3] == ref[3]).float().mean())
    return err


def check_errors(err: dict, where: str) -> None:
    line = ", ".join(f"{k} {v:.3e}" for k, v in err.items())
    print(f"  {where}: max|d| {line}", flush=True)
    for k, tol in TOL.items():
        if not err[k] <= tol:
            fail(f"{where}: {k} max|d| {err[k]:.3e} > {tol}")
    if err["last_match"] < LAST_MATCH_MIN:
        fail(f"{where}: last contributor matches on {err['last_match']:.6f} < {LAST_MATCH_MIN}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    if not (ROOT / "splatpu_torch").is_dir():
        print("FAIL: splatpu_torch/ is not beside chip_smoke.py", flush=True)
        return 1

    import numpy as np

    import splatpu_torch.render.composite as composite
    from splatpu_torch import _build
    from splatpu_torch.core.types import activate_cloud, stack_cameras
    from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
    from splatpu_torch.io.checkpoint import load_cloud, load_stage2_run
    from splatpu_torch.render.api import demand_binning, measure_binning_demand
    from splatpu_torch.render.exact import composite_inputs
    from splatpu_torch.train.inference import create_orbit_cameras, run_inference
    from splatpu_torch.train.stage2 import Stage2Config, compact_cloud

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    with phase("device", 60):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        print(f"  card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    with phase("build", 200):
        _build.load_library()
        print(f"  nvcc: {_build.build_seconds:.2f} s", flush=True)
        for line in _build.build_log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {line.strip()}", flush=True)

    with phase("compare", 180):
        cloud = compact_cloud(load_cloud(CLOUD, device=dev))
        if cloud.capacity != 100585:
            fail(f"expected 100585 alive Gaussians, got {cloud.capacity}")
        args = activate_cloud(cloud)
        w, h = COMPARE_SIZE
        cams_small = stack_cameras(list(create_orbit_cameras(w, h, device=dev).values()))
        cfg_small = demand_binning(*measure_binning_demand(args, cams_small))
        _, k = composite_inputs(args, cams_small, cfg_small)
        bg = torch.zeros(3, device=dev)
        kin = (k["table"], k["gid"], k["start"], k["end"], bg)
        got = composite.composite_fwd_cuda(*kin, **k["geometry"])
        torch.cuda.synchronize()
        ref = composite.composite_fwd_plain(*kin, **k["geometry"])
        print(f"  {w}x{h}, V=5, pairs/view max {int(k['end'][:, -1].max())}", flush=True)
        check_errors(compare(got, ref), f"{w}x{h}")

    with phase("serve", 420):
        net, head = load_stage2_run(RUN, device=dev)
        c = net.config
        print(f"  net: hidden {c.hidden_dim}, blocks {c.residual_blocks}, in {c.input_dim},"
              f" out {c.output_dim}; head {head}", flush=True)
        config = Stage2Config(
            timestep_count=TIMESTEPS, renderer="cuda", quirk_compat=head["quirk_compat"])
        enc = normalize_and_encode_means_and_rotations(
            cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat)
        torch.cuda.synchronize()
        composite.LAUNCHES = 0
        t0 = time.perf_counter()
        frames, stats = run_inference(net, cloud, enc, config, width=SERVE_SIZE[0],
                                      height=SERVE_SIZE[1], device=dev)
        serve_s = time.perf_counter() - t0
        launches = composite.LAUNCHES
        step_ms = np.array(stats["timestep_ms"])
        print(f"  {TIMESTEPS} timesteps + t=0, 5 x {SERVE_SIZE[0]}x{SERVE_SIZE[1]} each:"
              f" {serve_s:.2f} s wall", flush=True)
        print(f"  pair budget {stats['max_pairs']} (demand {stats['demand_pairs']},"
              f" span demand {stats['demand_span']} -> max_span {stats['max_span']});"
              f" pairs used (max per view) {stats['pairs_used']}", flush=True)
        print(f"  growths {stats['growths']}, residual overflow {stats['residual_overflow']},"
              f" renders {stats['renders']}, non-finite values {stats['nonfinite_pixels']}",
              flush=True)
        print(f"  composite_fwd launches {launches}", flush=True)
        print(f"  per-timestep ms (CUDA events): mean {step_ms.mean():.3f}"
              f" median {np.median(step_ms):.3f} min {step_ms.min():.3f}"
              f" max {step_ms.max():.3f}", flush=True)
        for name, fr in frames.items():
            shape = (SERVE_SIZE[1], SERVE_SIZE[0], 3)
            if len(fr) != TIMESTEPS + 1 or fr[0].shape != shape or fr[0].dtype != np.uint8:
                fail(f"camera {name}: {len(fr)} frames of {fr[0].shape} {fr[0].dtype}")
            print(f"  camera {name}: mean t=0 {fr[0].mean():.3f}, t={TIMESTEPS // 2}"
                  f" {fr[TIMESTEPS // 2].mean():.3f}, t={TIMESTEPS} {fr[-1].mean():.3f}", flush=True)
        if stats["nonfinite_pixels"]:
            fail(f"{stats['nonfinite_pixels']} non-finite image values")
        if stats["residual_overflow"]:
            fail("binning overflow left after growth")
        if launches < TIMESTEPS + 1:
            fail(f"composite_fwd launched {launches} times, expected >= {TIMESTEPS + 1}")
        if all(fr[0].mean() < 1.0 for fr in frames.values()):
            fail("every t=0 frame is black")
        del frames

    with phase("measure", 300):
        cams = stack_cameras(list(create_orbit_cameras(*SERVE_SIZE, device=dev).values()))
        _, k = composite_inputs(args, cams, stats["binning"])
        kin = (k["table"], k["gid"], k["start"], k["end"], bg)
        geo = k["geometry"]
        got = composite.composite_fwd_cuda(*kin, **geo)
        *ref, n_eval, n_contrib = composite.composite_fwd_plain(*kin, **geo, with_counts=True)
        err = compare(got, ref)
        check_errors(err, f"{SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs)")
        ms = cuda_ms(lambda: composite.composite_fwd_cuda(*kin, **geo), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: composite.composite_fwd_plain(*kin, **geo), reps=2, warmup=1)
        v, n, rec = k["table"].shape
        c = rec - 7
        pairs = int(k["end"][:, -1].sum())
        hw = geo["width"] * geo["height"]
        bytes_moved = 4 * (v * n * rec + pairs + 2 * k["start"].numel() + c + v * hw * (c + 3))
        evals, contribs = int(n_eval.sum()), int(n_contrib.sum())
        ops = OPS_PER_EVAL * evals + ops_per_contribution(c) * contribs
        t_bytes, t_ops = 1e3 * bytes_moved / PEAK_BYTES_S, 1e3 * ops / PEAK_FP32_FLOPS
        bound_ms = max(t_bytes, t_ops)
        print(f"  V={v} N={n} pairs={pairs}; evaluations {evals}, contributions {contribs}",
              flush=True)
        print(f"  kernel {ms:.4f} ms/launch, plain {plain_ms:.2f} ms; bound {bound_ms:.4f} ms"
              f" (bytes {bytes_moved} -> {t_bytes:.4f} ms, FP32 ops {ops} -> {t_ops:.4f} ms)",
              flush=True)

    kernels = [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "splatpu_torch/csrc/composite_fwd.cu",
        "replaces": "splatpu/render/exact.py:856 (_fwd_kernel_grid)",
        "launches": launches,
        "max_abs_err": max(err["image"], err["depth"], err["final_T"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }]
    print(f"total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
