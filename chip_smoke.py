#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases, each printed with its wall time and bounded by a watchdog:

1. device: require CUDA; print the card's name and power limit.
2. build: compile ``splatpu_torch/csrc/*.cu`` with nvcc, one process per
   source, all at once; print the registers of the kernels in
   ``PTXAS_NAMES`` and fail if one is missing.
3. compare: the forward-composite kernel K1 against its plain PyTorch
   version on the real 100,585-Gaussian cloud, five orbit cameras at
   320x180, one launch.
4. compare_bwd: at 5 x 320x180 and 5 x 1280x720 (five cameras of the
   training rig, the config-3 cloud at t = 0), on the cotangents of
   0.8 L1 + 0.2 (1 - SSIM) against the image shifted by a few pixels (plus
   small depth and final-T terms): the backward composite K2 against its
   plain version (per-pair rows), the routing kernel K3 against the plain
   routing, the whole ``CompositeTable`` backward "cuda" against "plain" on
   d(table), each scaled per row by the reference's largest value, 1e-4; and
   K2 + routing run twice, bitwise identical.
5. compare_manual: K4 (``kernel="manual"``), forward and backward, against
   its plain versions at 5 x 320x180 (orbit cameras) with 3 and with 9
   colour channels (the 9 from a seeded generator): image 2e-5, depth 2e-4,
   final T 2e-5, ``last`` identical; rows, the 16-row routing and the
   ``CompositeTable`` backward 1e-4 scaled per row; backward and routing
   bitwise identical across two runs.  Then one direct call whose ``gid``
   holds 2^24 + 2^20 slots, four tiles' segments placed above position
   2^24 and every other tile empty, against the plain versions handed the
   window of ``gid`` that holds those segments.
6. compare_padded: K5 (the padded composite), forward and backward, against
   its plain versions at 5 x 320x180 on padded pair streams built on the
   card at 16 px tiles, 3 and 9 channels, the same tolerances, the routing
   in its padded slot mode (the stream's ``q_of_slot``) and the
   ``CompositeG`` backward "cuda" against "plain".
7. serve, serve_manual, serve_padded: ``run_inference`` at full width: the
   config-3 checkpoint's network (hidden 128, 3 blocks, head settings from
   its stage2_result.json), the real cloud, five 1280x720 orbit views per
   timestep; ``serve`` 150 timesteps plus t=0 through K1, the other two
   NEW_SERVE_TIMESTEPS plus t=0 (a depth cut) through K4 and through K5 at
   a 16 px budget measured at 16 px.  Every kernel count is zeroed just
   before ``run_inference`` and read just after; the path's forward kernel
   must have run at every render and no other composite at all.
8. train, train_manual, train_padded: ``train`` at full width, cut in depth:
   the real cloud, the checkpoint's network with a fresh Adam, the head
   settings of its result file, targets rendered on the card from the cloud
   moved as in the config-3 run (27 cameras, 1280x720, uint8),
   ``view_staging="device_u8"``, five views per step, shuffled timesteps;
   ``train`` TRAIN_TIMESTEPS x TRAIN_ITERATIONS through K1/K2,
   ``train_manual`` (``binning_overrides={"kernel": "manual"}``) and
   ``train_padded`` (``renderer="cuda_padded"``, a 16 px budget measured at
   16 px) NEW_TRAIN_TIMESTEPS x NEW_TRAIN_ITERATIONS, instead of 150 x 40.
   Every kernel count is zeroed just before ``train`` and read just after;
   each step must launch its path's forward, backward and the routing
   kernel once, and no other composite.
9. measure, measure_manual, measure_padded: each forward kernel at the
   served shapes (the t=0 frame's inputs) against its plain version, CUDA-
   event times of both, and the bound from this run's bytes and the work
   its data needs.
10. measure_bwd, measure_manual, measure_padded: each backward kernel (and
   the routing) at the training shapes (five 1280x720 rig views at the
   trainer's final budget) against its plain version, CUDA-event times,
   the plain versions' times, one ``index_add_`` of the kept pairs' rows by
   (view, gid) as the routing's library yardstick, and the bounds from this
   run's inputs; the slots per (view, Gaussian) of both streams, and the
   routing in its padded mode at the padded path's training shapes against
   its plain version, with its time, the plain version's, one
   ``index_add_`` of the in-budget slots' rows by (view, gid) and its bound.

Prints one ``{"kernels": [...]}`` JSON line (the routing once per slot
mode, each with the launches of its paths), then the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; nothing is
caught and continued.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
N_GAUSSIANS = 100585   # alive in CLOUD
RUN = ROOT / "runs" / "config3_100k_r5"
TIMESTEPS = 150
SERVE_SIZE = (1280, 720)
COMPARE_SIZE = (320, 180)
TRAIN_TIMESTEPS = 8    # depth cut: config 3 trains 150 timesteps
TRAIN_ITERATIONS = 2   # depth cut: config 3 trains 40 sequence iterations
NEW_SERVE_TIMESTEPS = 10    # depth cut of serve_manual / serve_padded
NEW_TRAIN_TIMESTEPS = 2     # depth cut of train_manual / train_padded
NEW_TRAIN_ITERATIONS = 2
CHANNELS = (3, 9)      # colour channels K4 and K5 are compared at
BIG_P = (1 << 24) + (1 << 20)  # gid slots of K4's large-budget call
BIG_BASE = 1 << 24             # where its segments start
BIG_TILES = 4
BWD_TOL = 1e-4         # scaled per row by the reference's largest value
DEVICE = "cuda"
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

# Every kernel's launch counter: (module, attribute).
COUNTERS = {
    "composite_fwd": ("splatpu_torch.render.composite", "LAUNCHES"),
    "composite_bwd": ("splatpu_torch.render.composite", "BWD_LAUNCHES"),
    "route_pairs": ("splatpu_torch.render.route", "LAUNCHES"),
    "composite_manual_fwd": ("splatpu_torch.render.composite", "MANUAL_LAUNCHES"),
    "composite_manual_bwd": ("splatpu_torch.render.composite", "MANUAL_BWD_LAUNCHES"),
    "padded_fwd": ("splatpu_torch.render.padded", "LAUNCHES"),
    "padded_bwd": ("splatpu_torch.render.padded", "BWD_LAUNCHES"),
}
# ptxas's (mangled) kernel names -> the names printed with their registers:
# the 3-channel instances at the tiles the paths use (the backward kernels'
# template arguments are <C, tile>), the routing's 10 rows in both slot
# modes (<R, padded>), and the 9-channel and 16-row instances.  The build
# phase fails if one is missing from nvcc's log.
PTXAS_NAMES = {
    "composite_fwd_kernelILi3E": "composite_fwd",
    "composite_bwd_kernelILi3ELi32E": "composite_bwd",
    "composite_bwd_kernelILi3ELi16E": "composite_bwd tile 16",
    "route_pairs_kernelILi10ELb0E": "route_pairs",
    "route_pairs_kernelILi10ELb1E": "route_pairs padded",
    "route_pairs_kernelILi16ELb1E": "route_pairs R=16 padded",
    "manual_fwd_kernelILi3E": "composite_manual_fwd",
    "manual_bwd_kernelILi3ELi32E": "composite_manual_bwd",
    "manual_fwd_kernelILi9E": "composite_manual_fwd C=9",
    "manual_bwd_kernelILi9ELi32E": "composite_manual_bwd C=9",
    "padded_fwd_kernelILi3E": "padded_fwd", "padded_bwd_kernelILi3E": "padded_bwd",
    "padded_fwd_kernelILi9E": "padded_fwd C=9", "padded_bwd_kernelILi9E": "padded_bwd C=9",
}


def ops_per_contribution(c: int) -> int:
    return 4 + 2 * (c + 1)


# Backward, per evaluated (pixel, pair): the forward's 16.  Per live pair:
# 1 - alpha, the T division, chat (2 + 2C), w, dalpha (3), the suffix update
# (2), dpower (2), the rows (mx 4, my 4, ca 3, cb 3, cc 3, depth 1, colour C)
# and the sum of the 7 + C rows over the pixels.
def ops_bwd_per_live(c: int) -> int:
    return 30 + 3 * c + 7 + c


def launch_counts() -> dict:
    import importlib

    return {k: getattr(importlib.import_module(m), a) for k, (m, a) in COUNTERS.items()}


def zero_counts() -> None:
    import importlib

    for m, a in COUNTERS.values():
        setattr(importlib.import_module(m), a, 0)


class StepLog:
    """The trainer's logger: per-step metrics as floats, the kernel launches
    each step made, budget growths, and whether the first step changed the
    network's parameters."""

    def __init__(self, net, expected):
        self.net = net
        self.expected = expected
        self.before = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self.seen = None
        self.steps, self.growth_steps, self.growths = [], set(), 0
        self.changed_after_first = False

    def log(self, metrics, step):
        if "budget_growth" in metrics:
            self.growths = int(metrics["budget_growth"])
            self.growth_steps.add(step)
            print(f"  step {step}: budget growth -> {metrics}", flush=True)
            return
        now = launch_counts()
        launched = {k: n - (self.seen or {}).get(k, 0) for k, n in now.items()}
        self.seen = now
        m = {k: float(v) for k, v in metrics.items()}
        m["launched"] = launched
        if not self.steps:
            self.changed_after_first = any(
                not bool((v == self.before[k]).all()) for k, v in self.net.state_dict().items())
        self.steps.append((step, m))
        print(f"  step {step:2d}: loss {m['total']:.6f} (l1 {m['l1']:.5f} ssim {m['ssim']:.5f}"
              f" rig {m['rigidity']:.3e}) grad_norm {m['grad_norm']:.4e} lr"
              f" {m['learning_rate']:.4e} {m['step_ms']:.2f} ms; pairs {int(m['pairs'])}"
              f" / budget {int(m['max_pairs'])}; launches"
              f" {[launched[k] for k in self.expected]} of {list(self.expected)}", flush=True)

    def flush(self):
        pass


def rig_cams(dev, w, h, n=None):
    """The rig cameras (the first ``n``, or all 27) at w x h, batched."""
    import numpy as np
    import torch

    from splatpu_torch.core.types import Camera
    from splatpu_torch.tools.train_scene import rig_cameras

    cams = rig_cameras(w, h)[:n]
    return Camera(w2c=torch.from_numpy(np.stack([c[0] for c in cams])).to(dev),
                  K=torch.from_numpy(np.stack([c[1] for c in cams])).to(dev), width=w, height=h)


def cotangents(image, depth, tfin):
    """The cotangents of 0.8 L1 + 0.2 (1 - SSIM) against the image shifted by
    (3, 5) px, + 0.1 mean depth + 0.05 mean T."""
    import torch

    from splatpu_torch.core.ssim import ssim

    leaves = [x.detach().clone().requires_grad_(True) for x in (image, depth, tfin)]
    target = torch.roll(image, shifts=(3, 5), dims=(2, 3))
    loss = (0.8 * (leaves[0] - target).abs().mean() + 0.2 * (1.0 - ssim(leaves[0], target))
            + 0.1 * leaves[1].mean() + 0.05 * leaves[2].mean())
    return tuple(g.contiguous() for g in torch.autograd.grad(loss, leaves))


def table_case(args, cams, binning, fwd):
    """The exact stream's kernel inputs, ``fwd``'s outputs on them and their
    cotangents."""
    import torch

    from splatpu_torch.render.exact import composite_inputs

    streams, k = composite_inputs(args, cams, binning)
    kin = (k["table"].detach(), k["gid"], k["start"], k["end"],
           torch.zeros(args.colors.shape[1], device=args.colors.device))
    out = fwd(*kin, **k["geometry"])
    return dict(
        kin=kin, geo=k["geometry"], out=out, fwd=out[2:], cot=cotangents(*out[:3]),
        binning=binning,
        offsets=torch.stack([s.offsets for s in streams]),
        counts=torch.stack([s.counts for s in streams]),
        lane=torch.stack([s.lane for s in streams]),
    )


def bwd_case(args, cams, dev, binning=None):
    """K1's forward at ``cams`` and its cotangents (``table_case``)."""
    import splatpu_torch.render.composite as composite
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    if binning is None:
        binning = demand_binning(*measure_binning_demand(args, cams))
    return table_case(args, cams, binning, composite.composite_fwd_cuda)


def padded_case(args, cams, binning):
    """The padded pair streams' K5 inputs (records gathered by gid), K5's
    forward outputs on them, their cotangents, and the routing's inputs."""
    import torch

    import splatpu_torch.render.padded as padded
    from splatpu_torch.render.binning import build_pair_stream, tile_grid
    from splatpu_torch.render.composite import pack_table

    streams = [build_pair_stream(args, cams.view(i), binning) for i in range(cams.num_views)]
    table = torch.stack([pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity,
                                    s.splats.depth, s.g_colors) for s in streams]).detach()
    gid = torch.stack([s.gid for s in streams])
    rows = torch.arange(len(streams), device=gid.device)[:, None]
    stack = lambda f: torch.stack([getattr(s, f) for s in streams])  # noqa: E731
    tiles_x, tiles_y = tile_grid(cams.width, cams.height, 16)
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, width=cams.width, height=cams.height)
    kin = (table[rows, gid.long()].contiguous(), stack("start"), stack("end"),
           torch.zeros(args.colors.shape[1], device=gid.device))
    out = padded.padded_fwd_cuda(*kin, **geo)
    return dict(kin=kin, geo=geo, out=out, fwd=out[2:], cot=cotangents(*out[:3]), table=table,
                gid=gid, pos=stack("q_of_slot"), offsets=stack("emit_offsets"),
                counts=stack("emit_counts"))


def ptxas_summary(log: str) -> dict:
    """kernel -> 'N registers, M B smem; S bytes spill stores, ...' from
    nvcc's -Xptxas -v lines."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((v for k, v in PTXAS_NAMES.items() if k in line), None)
            spill = ""
        elif "bytes spill stores" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            out[name] = f"{line.split('ptxas info    :')[-1].strip()}; {spill}"
    return out


def print_slot_runs(what, counts) -> None:
    """The emission slots per (view, Gaussian): the routing walks each run
    serially."""
    c = counts.reshape(-1).long()
    print(f"  {what}: slots per (view, Gaussian) max {int(c.max())}, mean"
          f" {float(c.float().mean()):.3f}, over 32 {int((c > 32).sum())} of {c.numel()},"
          f" over 128 {int((c > 128).sum())}", flush=True)


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


def compare(got, ref) -> dict:
    import torch

    for name, a in zip(("image", "depth", "final_T"), got[:3]):
        if not bool(torch.isfinite(a).all()):
            fail(f"kernel {name} has non-finite values")
    err = {k: float((a - b).abs().max()) for k, a, b in zip(TOL, got[:3], ref[:3])}
    err["last_match"] = float((got[3] == ref[3]).float().mean())
    err["last_mismatches"] = int((got[3] != ref[3]).sum())
    return err


def check_errors(err: dict, where: str, last_exact: bool = False) -> None:
    line = ", ".join(f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}" for k, v in err.items())
    print(f"  {where}: max|d| {line}", flush=True)
    for k, tol in TOL.items():
        if not err[k] <= tol:
            fail(f"{where}: {k} max|d| {err[k]:.3e} > {tol}")
    if last_exact and err["last_mismatches"]:
        fail(f"{where}: last contributor differs on {err['last_mismatches']} pixels")
    if err["last_match"] < LAST_MATCH_MIN:
        fail(f"{where}: last contributor matches on {err['last_match']:.6f} < {LAST_MATCH_MIN}")


def check_rows(where: str, errs: dict) -> None:
    print(f"  {where}: " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + " (scaled per row)", flush=True)
    for k, v in errs.items():
        if not v <= BWD_TOL:
            fail(f"{where}: {k} scaled error {v:.3e} > {BWD_TOL}")


def check_only(counts: dict, expected: set, where: str) -> None:
    """Fail if a kernel outside ``expected`` launched on this path."""
    stray = {k: n for k, n in counts.items() if n and k not in expected}
    if stray:
        fail(f"{where}: kernels of another path launched: {stray}")


def fwd_bound(c, v, hw, evals, contribs, bytes_in):
    """(bound ms, bytes ms, ops ms, bytes, ops) of a forward composite: its
    inputs read once and its outputs (C + 3 values per pixel) written once;
    the operations its data needs."""
    bytes_moved = bytes_in + 4 * (c + v * hw * (c + 3))
    ops = OPS_PER_EVAL * evals + ops_per_contribution(c) * contribs
    t_bytes, t_ops = 1e3 * bytes_moved / PEAK_BYTES_S, 1e3 * ops / PEAK_FP32_FLOPS
    return max(t_bytes, t_ops), t_bytes, t_ops, bytes_moved, ops


def bwd_work(kin_start, last, geo, n_live):
    """Backward evaluations (every pixel from its tile's start to its last)
    and live steps (the forward's contributions)."""
    import torch

    from splatpu_torch.render.composite import to_tiles

    last_t = to_tiles(last[:, None].long(), geo["tiles_x"], geo["tiles_y"], geo.get("tile", 16),
                      fill=-1)[..., 0]
    start_t = kin_start.reshape(-1).long()[:, None]
    evals = int(torch.where(last_t >= 0, last_t - start_t + 1, torch.zeros_like(last_t)).sum())
    return evals, int(n_live.sum())


def kernel_entry(name, source, replaces, by_path, err, ms, plain_ms, bound, library_ms=None):
    bound_ms, t_bytes, t_ops = bound[:3]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": library_ms,
    }


def serve_path(name, net, cloud, config, expected_fwd, timesteps):
    """``run_inference`` with every count zeroed just before and read just
    after; checks the frames and that ``expected_fwd`` (and nothing else)
    launched at every render.  Returns (counts, stats)."""
    import numpy as np
    import torch

    from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
    from splatpu_torch.train.inference import run_inference

    enc = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    frames, stats = run_inference(net, cloud, enc, config, width=SERVE_SIZE[0],
                                  height=SERVE_SIZE[1], device=DEVICE)
    serve_s = time.perf_counter() - t0
    counts = launch_counts()
    step_ms = np.array(stats["timestep_ms"])
    print(f"  {timesteps} timesteps + t=0, 5 x {SERVE_SIZE[0]}x{SERVE_SIZE[1]} each, renderer"
          f" {config.renderer!r}, kernel {stats['binning'].kernel!r}, tile"
          f" {stats['binning'].tile}: {serve_s:.2f} s wall", flush=True)
    print(f"  pair budget {stats['max_pairs']} (demand {stats['demand_pairs']},"
          f" span demand {stats['demand_span']} -> max_span {stats['max_span']});"
          f" pairs used (max per view) {stats['pairs_used']}", flush=True)
    print(f"  growths {stats['growths']}, residual overflow {stats['residual_overflow']},"
          f" renders {stats['renders']}, non-finite values {stats['nonfinite_pixels']}",
          flush=True)
    print(f"  launches {counts}", flush=True)
    print(f"  per-timestep ms (CUDA events): mean {step_ms.mean():.3f}"
          f" median {np.median(step_ms):.3f} min {step_ms.min():.3f}"
          f" max {step_ms.max():.3f}", flush=True)
    for cam, fr in frames.items():
        shape = (SERVE_SIZE[1], SERVE_SIZE[0], 3)
        if len(fr) != timesteps + 1 or fr[0].shape != shape or fr[0].dtype != np.uint8:
            fail(f"{name}: camera {cam}: {len(fr)} frames of {fr[0].shape} {fr[0].dtype}")
        print(f"  camera {cam}: mean t=0 {fr[0].mean():.3f}, t={timesteps // 2}"
              f" {fr[timesteps // 2].mean():.3f}, t={timesteps} {fr[-1].mean():.3f}", flush=True)
    if stats["nonfinite_pixels"]:
        fail(f"{name}: {stats['nonfinite_pixels']} non-finite image values")
    if stats["residual_overflow"]:
        fail(f"{name}: binning overflow left after growth")
    if counts[expected_fwd] != stats["renders"] or stats["renders"] < timesteps + 1:
        fail(f"{name}: {expected_fwd} launched {counts[expected_fwd]} times in"
             f" {stats['renders']} renders, expected one per render, >= {timesteps + 1}")
    check_only(counts, {expected_fwd}, name)
    if all(fr[0].mean() < 1.0 for fr in frames.values()):
        fail(f"{name}: every t=0 frame is black")
    return counts, stats


def train_path(name, cloud, views, tcfg, expected, n_steps):
    """``train`` with every count zeroed just before and read just after;
    checks each step's launches (``expected`` once each, nothing else),
    losses, gradients and budget.  Returns (counts, log)."""
    import numpy as np
    import torch

    import splatpu_torch.train.stage2 as stage2
    from splatpu_torch.io.checkpoint import load_stage2_run

    tnet, _ = load_stage2_run(RUN, device=DEVICE)
    log = StepLog(tnet, expected)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    stage2.train(cloud, views, tcfg, logger=log, initial_net=tnet, device=DEVICE)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    counts = launch_counts()
    step_ms = np.array([m["step_ms"] for _, m in log.steps])
    print(f"  train(): {n_steps} steps in {train_s:.2f} s wall (setup and staging"
          f" included); step ms (CUDA events) mean {step_ms.mean():.2f} median"
          f" {np.median(step_ms):.2f} min {step_ms.min():.2f} max {step_ms.max():.2f};"
          f" launches {counts}; growths {log.growths}", flush=True)
    if len(log.steps) != n_steps:
        fail(f"{name}: logged {len(log.steps)} steps, expected {n_steps}")
    for k in expected:
        if counts[k] != n_steps:
            fail(f"{name}: {k} launched {counts[k]} times in {n_steps} steps, expected {n_steps}")
    check_only(counts, set(expected), name)
    for step_idx, m in log.steps:
        if not np.isfinite(m["total"]):
            fail(f"{name} step {step_idx}: non-finite loss {m['total']}")
        if not (np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
            fail(f"{name} step {step_idx}: grad_norm {m['grad_norm']}")
        if any(m["launched"][k] != (1 if k in expected else 0) for k in COUNTERS):
            fail(f"{name} step {step_idx}: kernel launches {m['launched']}")
        if m["binning_overflow"] and step_idx not in log.growth_steps:
            fail(f"{name} step {step_idx}: binning overflow not followed by growth")
    if log.steps[-1][1]["binning_overflow"]:
        fail(f"{name}: binning overflow left after growth at the last step")
    if not log.changed_after_first:
        fail(f"{name}: parameters unchanged after the first step")
    return counts, log


def compare_table_bwd(where, case, bwd, bwd_plain, impl):
    """A table kernel's backward and the routing against their plain
    versions, the ``CompositeTable`` backward ``impl`` against its plain
    twin, and the backward + routing run twice, bitwise identical."""
    import torch

    import splatpu_torch.render.route as route
    from splatpu_torch.render.exact import CompositeTable
    from splatpu_torch.tools.measure import row_scaled_err

    kin, geo, cot = case["kin"], case["geo"], case["cot"]
    rows = bwd(*kin, *case["fwd"], *cot, **geo)
    torch.cuda.synchronize()
    rows_ref = bwd_plain(*kin, *case["fwd"], *cot, **geo)
    pos = route.pos_of_slot_of(case["offsets"], kin[1], case["lane"])
    routed = route.route_pairs_cuda(rows, pos, case["offsets"], case["counts"])
    routed_ref = route.route_pairs_plain(rows, pos, case["offsets"], case["counts"])
    d_table = {}
    for key in (impl, ("plain", impl[1])):
        table = kin[0].clone().requires_grad_(True)
        outs = CompositeTable.apply(table, kin[4], *kin[1:4], case["offsets"],
                                    case["counts"], case["lane"], geo, key)
        torch.autograd.backward(outs[:3], cot)
        d_table[key[0]] = table.grad
    again = route.route_pairs_cuda(bwd(*kin, *case["fwd"], *cot, **geo), pos,
                                   case["offsets"], case["counts"])
    torch.cuda.synchronize()
    for name, x in (("rows", rows), ("routed", routed), ("d_table", d_table["cuda"])):
        if not bool(torch.isfinite(x).all()) or not bool((x != 0).any()):
            fail(f"{where}: {name} non-finite or all zero")
    check_rows(f"{where}, pairs/view max {int(kin[3][:, -1].max())}", {
        "rows": row_scaled_err(rows, rows_ref),
        "routing": row_scaled_err(routed, routed_ref),
        "CompositeTable d_table": row_scaled_err(d_table["cuda"], d_table["plain"]),
    })
    if not torch.equal(again, routed):
        fail(f"{where}: backward + routing not bitwise identical across two runs")
    print(f"  {where}: backward + routing bitwise identical across two runs", flush=True)


def big_budget_case(case):
    """K4 on one view whose four longest segments sit above pair position
    2^24 in a gid of BIG_P slots, every other tile empty, against the plain
    versions on the window of gid that holds those segments."""
    import torch

    import splatpu_torch.render.composite as composite
    from splatpu_torch.tools.measure import row_scaled_err

    table, gid, start, end, bg = (x[:1] if x.dim() > 1 else x for x in case["kin"])
    geo = case["geo"]
    lengths = (end - start)[0]
    tiles = torch.argsort(lengths, descending=True)[:BIG_TILES]
    dev = gid.device
    window = torch.cat([gid[0, int(start[0, t]):int(end[0, t])] for t in tiles.tolist()])
    lens = lengths[tiles]
    offs = torch.cumsum(lens, 0) - lens
    start_w = torch.zeros_like(start)
    end_w = torch.zeros_like(end)
    start_w[0, tiles] = offs.int()
    end_w[0, tiles] = (offs + lens).int()
    n_win = window.numel()
    gid_big = torch.zeros((1, BIG_P), dtype=torch.int32, device=dev)
    gid_big[0, BIG_BASE:BIG_BASE + n_win] = window
    start_b = torch.where(end_w > start_w, start_w + BIG_BASE, start_w)
    end_b = torch.where(end_w > start_w, end_w + BIG_BASE, end_w)
    got = composite.composite_manual_fwd_cuda(table, gid_big, start_b, end_b, bg, **geo)
    torch.cuda.synchronize()
    ref = composite.composite_manual_fwd_plain(table, window[None].contiguous(), start_w, end_w,
                                               bg, **geo)
    ref_last = torch.where(ref[3] >= 0, ref[3] + BIG_BASE, ref[3])
    where = f"P = 2^24 + 2^20, {BIG_TILES} tiles ({n_win} pairs) above 2^24"
    check_errors(compare(got, (*ref[:3], ref_last)), where, last_exact=True)
    if not bool((got[3] >= BIG_BASE).any()):
        fail(f"{where}: no pixel's last position lies above 2^24")
    cot = cotangents(*got[:3])
    last_w = torch.where(got[3] >= 0, got[3] - BIG_BASE, got[3])
    rows = composite.composite_manual_bwd_cuda(table, gid_big, start_b, end_b, bg, got[2], got[3],
                                               *cot, **geo)
    again = composite.composite_manual_bwd_cuda(table, gid_big, start_b, end_b, bg, got[2],
                                                got[3], *cot, **geo)
    torch.cuda.synchronize()
    rows_ref = composite.composite_manual_bwd_plain(table, window[None].contiguous(), start_w,
                                                    end_w, bg, got[2], last_w, *cot, **geo)
    inside = rows[0, BIG_BASE:BIG_BASE + n_win]
    outside = max(float(rows[0, :BIG_BASE].abs().max()),
                  float(rows[0, BIG_BASE + n_win:].abs().max()))
    check_rows(where, {"rows": row_scaled_err(inside, rows_ref[0])})
    if outside != 0.0 or not bool((inside != 0).any()):
        fail(f"{where}: rows outside the window {outside}, or none inside")
    if not torch.equal(rows, again):
        fail(f"{where}: backward not bitwise identical across two runs")
    print(f"  {where}: rows outside the window zero; backward bitwise identical across two"
          f" runs; rows {tuple(rows.shape)}", flush=True)


def compare_padded_case(where, args, cams, binning):
    """K5's forward and backward, the routing over the padded slots and the
    ``CompositeG`` backward, each against its plain version."""
    import torch

    import splatpu_torch.render.padded as padded
    import splatpu_torch.render.route as route
    from splatpu_torch.tools.measure import row_scaled_err

    case = padded_case(args, cams, binning)
    kin, geo, cot = case["kin"], case["geo"], case["cot"]
    torch.cuda.synchronize()
    ref = padded.padded_fwd_plain(*kin, **geo)
    check_errors(compare(case["out"], ref), where, last_exact=True)
    rows = padded.padded_bwd_cuda(*kin, *case["fwd"], *cot, **geo)
    torch.cuda.synchronize()
    rows_ref = padded.padded_bwd_plain(*kin, *case["fwd"], *cot, **geo)
    routing = (case["pos"], case["offsets"], case["counts"])
    routed = route.route_pairs_cuda(rows, *routing, padded=True)
    routed_ref = route.route_pairs_plain(rows, *routing, padded=True)
    d_table = {}
    for impl in ("cuda", "plain"):
        table = case["table"].clone().requires_grad_(True)
        outs = padded.CompositeG.apply(table, kin[3], case["gid"], kin[1], kin[2], case["pos"],
                                       case["offsets"], case["counts"], geo, impl)
        torch.autograd.backward(outs[:3], cot)
        d_table[impl] = table.grad
    again = route.route_pairs_cuda(padded.padded_bwd_cuda(*kin, *case["fwd"], *cot, **geo),
                                   *routing, padded=True)
    torch.cuda.synchronize()
    for name, x in (("rows", rows), ("routed", routed), ("d_table", d_table["cuda"])):
        if not bool(torch.isfinite(x).all()) or not bool((x != 0).any()):
            fail(f"{where}: {name} non-finite or all zero")
    check_rows(f"{where}, padded length {kin[0].shape[1]}", {
        "rows": row_scaled_err(rows, rows_ref),
        "routing": row_scaled_err(routed, routed_ref),
        "CompositeG d_table": row_scaled_err(d_table["cuda"], d_table["plain"]),
    })
    if not torch.equal(again, routed):
        fail(f"{where}: backward + routing not bitwise identical across two runs")
    print(f"  {where}: backward + routing bitwise identical across two runs", flush=True)


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
    import splatpu_torch.render.padded as padded
    import splatpu_torch.render.route as route
    from splatpu_torch import _build
    from splatpu_torch.core.types import Camera, RenderArgs, activate_cloud, stack_cameras
    from splatpu_torch.io.checkpoint import load_cloud, load_stage2_run
    from splatpu_torch.render.api import demand_binning, measure_binning_demand
    from splatpu_torch.render.exact import composite_inputs
    from splatpu_torch.tools.measure import cuda_ms, row_scaled_err
    from splatpu_torch.train.inference import create_orbit_cameras
    from splatpu_torch.train.stage2 import Stage2Config, compact_cloud

    dev = torch.device(DEVICE)
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
        regs = ptxas_summary(_build.build_log)
        for k, v in regs.items():
            print(f"  ptxas {k}: {v}", flush=True)
        missing = sorted(set(PTXAS_NAMES.values()) - set(regs))
        if missing:
            fail(f"nvcc's log names no register count for {missing}")
        if re.search(r"[1-9]\d* bytes spill", _build.build_log):
            print("  (some instances spill: see the log's spill lines)", flush=True)

    with phase("compare", 180):
        cloud = compact_cloud(load_cloud(CLOUD, device=dev))
        if cloud.capacity != N_GAUSSIANS:
            fail(f"expected {N_GAUSSIANS} alive Gaussians, got {cloud.capacity}")
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

    with phase("compare_bwd", 240):
        for w, h in (COMPARE_SIZE, SERVE_SIZE):
            case = bwd_case(args, rig_cams(dev, w, h, 5), dev)
            compare_table_bwd(f"K2 {w}x{h}, V=5", case, composite.composite_bwd_cuda,
                              composite.composite_bwd_plain, ("cuda", "grid"))
            del case

    # Colours from a seeded generator for the 9-channel comparisons.
    colors9 = torch.from_numpy(np.random.default_rng(9).uniform(
        0.0, 1.0, (cloud.capacity, 9)).astype(np.float32)).to(dev)
    args_by_c = {3: args, 9: RenderArgs(args.means3d, colors9, args.rotations, args.opacities,
                                        args.scales)}

    with phase("compare_manual", 300):
        w, h = COMPARE_SIZE
        for c in CHANNELS:
            binning = dataclasses.replace(
                demand_binning(*measure_binning_demand(args_by_c[c], cams_small)), kernel="manual")
            case = table_case(args_by_c[c], cams_small, binning, composite.composite_manual_fwd_cuda)
            torch.cuda.synchronize()
            ref = composite.composite_manual_fwd_plain(*case["kin"], **case["geo"])
            check_errors(compare(case["out"], ref), f"K4 {w}x{h}, V=5, C={c}", last_exact=True)
            compare_table_bwd(f"K4 {w}x{h}, V=5, C={c}", case, composite.composite_manual_bwd_cuda,
                              composite.composite_manual_bwd_plain, ("cuda", "manual"))
        big_budget_case(case)
        del case

    with phase("compare_padded", 300):
        for c in CHANNELS:
            binning16 = demand_binning(*measure_binning_demand(args_by_c[c], cams_small, tile=16),
                                       tile=16)
            compare_padded_case(f"K5 {w}x{h}, V=5, C={c}", args_by_c[c], cams_small, binning16)
        del args_by_c

    net, head = load_stage2_run(RUN, device=dev)
    c = net.config
    print(f"  net: hidden {c.hidden_dim}, blocks {c.residual_blocks}, in {c.input_dim},"
          f" out {c.output_dim}; head {head}", flush=True)
    orbit = stack_cameras(list(create_orbit_cameras(*SERVE_SIZE, device=dev).values()))
    served = {}

    with phase("serve", 420):
        config = Stage2Config(timestep_count=TIMESTEPS, renderer="cuda",
                              quirk_compat=head["quirk_compat"])
        served["serve"] = serve_path("serve", net, cloud, config, "composite_fwd", TIMESTEPS)

    with phase("serve_manual", 240):
        demand = measure_binning_demand(args, orbit)
        config = Stage2Config(timestep_count=NEW_SERVE_TIMESTEPS, renderer="cuda",
                              quirk_compat=head["quirk_compat"],
                              binning=demand_binning(*demand, overrides={"kernel": "manual"}))
        print(f"  depth cut: {NEW_SERVE_TIMESTEPS} timesteps (config 3 serves {TIMESTEPS})",
              flush=True)
        served["serve_manual"] = serve_path("serve_manual", net, cloud, config,
                                            "composite_manual_fwd", NEW_SERVE_TIMESTEPS)

    with phase("serve_padded", 240):
        config = Stage2Config(
            timestep_count=NEW_SERVE_TIMESTEPS, renderer="cuda_padded",
            quirk_compat=head["quirk_compat"],
            binning=demand_binning(*measure_binning_demand(args, orbit, tile=16), tile=16))
        print(f"  depth cut: {NEW_SERVE_TIMESTEPS} timesteps (config 3 serves {TIMESTEPS})",
              flush=True)
        served["serve_padded"] = serve_path("serve_padded", net, cloud, config, "padded_fwd",
                                            NEW_SERVE_TIMESTEPS)

    trained = {}
    with phase("train", 480):
        from splatpu_torch.tools.train_scene import render_targets

        t0 = time.perf_counter()
        views = render_targets(cloud, TRAIN_TIMESTEPS, *SERVE_SIZE, impl="cuda", device=dev)
        torch.cuda.synchronize()
        print(f"  targets: {TRAIN_TIMESTEPS} timesteps x {len(views[0])} cameras,"
              f" {SERVE_SIZE[0]}x{SERVE_SIZE[1]} uint8, rendered in"
              f" {time.perf_counter() - t0:.2f} s", flush=True)
        tc = net.config
        base_cfg = Stage2Config(
            total_iterations=TRAIN_ITERATIONS, warmup_iterations=1,
            learning_rate=head["lr"], hidden_dim=tc.hidden_dim,
            residual_blocks=tc.residual_blocks, views_per_step=5,
            timestep_count=TRAIN_TIMESTEPS, renderer="cuda",
            quirk_compat=head["quirk_compat"], view_staging="device_u8",
            timestep_order="shuffled", overflow_check_every=1,
            **{k: head[k] for k in ("delta_scale", "double_residual", "zero_init_head",
                                    "time_gate_head")},
        )
        print(f"  depth cut: {TRAIN_TIMESTEPS} timesteps x {TRAIN_ITERATIONS} sequence"
              f" iterations (config 3: 150 x 40); width untouched", flush=True)
        trained["train"] = train_path(
            "train", cloud, views, base_cfg, ("composite_fwd", "composite_bwd", "route_pairs"),
            TRAIN_ITERATIONS * TRAIN_TIMESTEPS)
        train_binning = dataclasses.replace(
            demand_binning(*measure_binning_demand(args, rig_cams(dev, *SERVE_SIZE))),
            max_pairs=int(trained["train"][1].steps[-1][1]["max_pairs"]))
        views = views[:NEW_TRAIN_TIMESTEPS]

    new_cfg = dataclasses.replace(base_cfg, total_iterations=NEW_TRAIN_ITERATIONS,
                                  timestep_count=NEW_TRAIN_TIMESTEPS)
    new_steps = NEW_TRAIN_ITERATIONS * NEW_TRAIN_TIMESTEPS
    with phase("train_manual", 300):
        print(f"  depth cut: {NEW_TRAIN_TIMESTEPS} timesteps x {NEW_TRAIN_ITERATIONS} sequence"
              f" iterations; binning_overrides kernel='manual'", flush=True)
        trained["train_manual"] = train_path(
            "train_manual", cloud, views,
            dataclasses.replace(new_cfg, binning_overrides={"kernel": "manual"}),
            ("composite_manual_fwd", "composite_manual_bwd", "route_pairs"), new_steps)

    with phase("train_padded", 300):
        t0_cams = Camera(w2c=torch.from_numpy(np.stack([v.w2c for v in views[0]])).to(dev),
                         K=torch.from_numpy(np.stack([v.K for v in views[0]])).to(dev),
                         width=SERVE_SIZE[0], height=SERVE_SIZE[1])
        padded_binning = demand_binning(*measure_binning_demand(args, t0_cams, tile=16), tile=16,
                                        headroom=new_cfg.binning_headroom)
        print(f"  depth cut: {NEW_TRAIN_TIMESTEPS} timesteps x {NEW_TRAIN_ITERATIONS} sequence"
              f" iterations; renderer 'cuda_padded', 16 px budget {padded_binning.max_pairs}",
              flush=True)
        trained["train_padded"] = train_path(
            "train_padded", cloud, views,
            dataclasses.replace(new_cfg, renderer="cuda_padded", binning=padded_binning),
            ("padded_fwd", "padded_bwd", "route_pairs"), new_steps)
        del views

    with phase("measure", 300):
        _, k = composite_inputs(args, orbit, served["serve"][1]["binning"])
        kin = (k["table"], k["gid"], k["start"], k["end"], bg)
        geo = k["geometry"]
        got = composite.composite_fwd_cuda(*kin, **geo)
        *ref, n_eval, n_contrib = composite.composite_fwd_plain(*kin, **geo, with_counts=True)
        err = compare(got, ref)
        check_errors(err, f"K1 {SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs)")
        ms = cuda_ms(lambda: composite.composite_fwd_cuda(*kin, **geo), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: composite.composite_fwd_plain(*kin, **geo), reps=2, warmup=1)
        v, n, rec = k["table"].shape
        pairs = int(k["end"][:, -1].sum())
        hw = geo["width"] * geo["height"]
        evals, contribs = int(n_eval.sum()), int(n_contrib.sum())
        k1_bound = fwd_bound(3, v, hw, evals, contribs,
                             4 * (v * n * rec + pairs + 2 * k["start"].numel()))
        print(f"  V={v} N={n} pairs={pairs}; evaluations {evals}, contributions {contribs}",
              flush=True)
        print(f"  K1 {ms:.4f} ms/launch, plain {plain_ms:.2f} ms; bound {k1_bound[0]:.4f} ms"
              f" (bytes {k1_bound[3]} -> {k1_bound[1]:.4f} ms, FP32 ops {k1_bound[4]} ->"
              f" {k1_bound[2]:.4f} ms)", flush=True)
        k1 = dict(err=max(err["image"], err["depth"], err["final_T"]), ms=ms, plain_ms=plain_ms,
                  bound=k1_bound)

    def measure_table_bwd(label, case, bwd, bwd_plain):
        """A table backward and the routing at the training shapes: errors,
        times, the index_add_ yardstick and both bounds."""
        kin, geo, cot, (tfin, last) = case["kin"], case["geo"], case["cot"], case["fwd"]
        offsets, counts, lane = case["offsets"], case["counts"], case["lane"]
        run = lambda: bwd(*kin, tfin, last, *cot, **geo)  # noqa: E731
        run_plain = lambda: bwd_plain(*kin, tfin, last, *cot, **geo)  # noqa: E731
        rows = run()
        pos = route.pos_of_slot_of(offsets, kin[1], lane)
        routed = route.route_pairs_cuda(rows, pos, offsets, counts)
        v, n, rec = kin[0].shape
        p = kin[1].shape[1]
        c = rec - 7
        # The library yardstick: one index_add_ of the kept pairs' rows by
        # (view, gid), index and rows gathered beforehand (not timed).
        kept = lane >= 0
        index = (kin[1].long() + n * torch.arange(v, device=dev)[:, None])[kept]
        kept_rows = rows[kept]
        library = lambda: torch.zeros((v * n, rec), device=dev).index_add_(0, index, kept_rows)  # noqa: E731
        lib_err = float((library().reshape(v, n, rec) - routed).abs().max())
        rows_ref = run_plain()
        routed_ref = route.route_pairs_plain(rows, pos, offsets, counts)
        check_rows(f"{label} at the training shapes", {
            "rows": row_scaled_err(rows, rows_ref), "routing": row_scaled_err(routed, routed_ref)})
        errs = (float((rows - rows_ref).abs().max()), float((routed - routed_ref).abs().max()))
        del rows_ref
        b_ms = cuda_ms(run, reps=20, warmup=3)
        b_plain_ms = cuda_ms(run_plain, reps=2, warmup=1)
        r_ms = cuda_ms(lambda: route.route_pairs_cuda(rows, pos, offsets, counts), reps=50,
                       warmup=5)
        r_plain_ms = cuda_ms(lambda: route.route_pairs_plain(rows, pos, offsets, counts),
                             reps=5, warmup=1)
        r_lib_ms = cuda_ms(library, reps=50, warmup=5)
        fwd_plain = (composite.composite_fwd_plain if bwd is composite.composite_bwd_cuda
                     else composite.composite_manual_fwd_plain)
        *_, n_live = fwd_plain(*kin, **geo, with_counts=True)
        evals, live = bwd_work(kin[2], last, geo, n_live)
        hw = geo["width"] * geo["height"]
        pairs = int(kin[3][:, -1].sum())
        n_kept = int(kept.sum())
        b_bytes = 4 * (v * n * rec + pairs + 2 * kin[2].numel() + c + v * hw * (c + 4)
                       + v * p * rec)
        b_ops = OPS_PER_EVAL * evals + ops_bwd_per_live(c) * live
        b_tb, b_to = 1e3 * b_bytes / PEAK_BYTES_S, 1e3 * b_ops / PEAK_FP32_FLOPS
        r_bytes = 4 * (n_kept * rec + v * p + 2 * v * n + v * n * rec)
        r_ops = n_kept * rec
        r_tb, r_to = 1e3 * r_bytes / PEAK_BYTES_S, 1e3 * r_ops / PEAK_FP32_FLOPS
        print(f"  V={v} N={n} P={p} pairs={pairs} kept={n_kept}; backward evaluations {evals},"
              f" live {live}", flush=True)
        print_slot_runs("exact stream", counts)
        print(f"  {label} {b_ms:.4f} ms/launch, plain {b_plain_ms:.2f} ms; bound"
              f" {max(b_tb, b_to):.4f} ms (bytes {b_bytes} -> {b_tb:.4f} ms, FP32 ops"
              f" {b_ops} -> {b_to:.4f} ms)", flush=True)
        print(f"  routing {r_ms:.4f} ms/launch, plain {r_plain_ms:.3f} ms, index_add_"
              f" {r_lib_ms:.4f} ms (max |d| vs kernel {lib_err:.3e}); bound"
              f" {max(r_tb, r_to):.4f} ms (bytes {r_bytes} -> {r_tb:.4f} ms, adds"
              f" {r_ops} -> {r_to:.5f} ms)", flush=True)
        return (dict(err=errs[0], ms=b_ms, plain_ms=b_plain_ms, bound=(max(b_tb, b_to), b_tb, b_to)),
                dict(err=errs[1], ms=r_ms, plain_ms=r_plain_ms, bound=(max(r_tb, r_to), r_tb, r_to),
                     library_ms=r_lib_ms))

    with phase("measure_bwd", 300):
        case = bwd_case(args, rig_cams(dev, *SERVE_SIZE, 5), dev, binning=train_binning)
        k2, k3 = measure_table_bwd("K2", case, composite.composite_bwd_cuda,
                                   composite.composite_bwd_plain)
        del case

    with phase("measure_manual", 300):
        b = served["serve_manual"][1]["binning"]
        case = table_case(args, orbit, b, composite.composite_manual_fwd_cuda)
        kin, geo = case["kin"], case["geo"]
        *ref, n_eval, n_contrib = composite.composite_manual_fwd_plain(*kin, **geo, with_counts=True)
        err = compare(case["out"], ref)
        check_errors(err, f"K4 {SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs, C=3)")
        ms = cuda_ms(lambda: composite.composite_manual_fwd_cuda(*kin, **geo), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: composite.composite_manual_fwd_plain(*kin, **geo), reps=2,
                           warmup=1)
        v, n, rec = kin[0].shape
        pairs = int(kin[3][:, -1].sum())
        bound = fwd_bound(3, v, SERVE_SIZE[0] * SERVE_SIZE[1], int(n_eval.sum()),
                          int(n_contrib.sum()), 4 * (v * n * rec + pairs + 2 * kin[2].numel()))
        print(f"  K4 fwd {ms:.4f} ms/launch, plain {plain_ms:.2f} ms; bound {bound[0]:.4f} ms"
              f" (bytes {bound[3]} -> {bound[1]:.4f} ms, FP32 ops {bound[4]} -> {bound[2]:.4f}"
              f" ms); evaluations {int(n_eval.sum())}, contributions {int(n_contrib.sum())}",
              flush=True)
        k4f = dict(err=max(err["image"], err["depth"], err["final_T"]), ms=ms, plain_ms=plain_ms,
                   bound=bound)
        manual_train = dataclasses.replace(
            train_binning, kernel="manual",
            max_pairs=int(trained["train_manual"][1].steps[-1][1]["max_pairs"]))
        case = table_case(args, rig_cams(dev, *SERVE_SIZE, 5), manual_train,
                          composite.composite_manual_fwd_cuda)
        k4b, _ = measure_table_bwd("K4 bwd", case, composite.composite_manual_bwd_cuda,
                                   composite.composite_manual_bwd_plain)
        del case

    with phase("measure_padded", 300):
        case = padded_case(args, orbit, served["serve_padded"][1]["binning"])
        kin, geo = case["kin"], case["geo"]
        *ref, n_eval, n_contrib = padded.padded_fwd_plain(*kin, **geo, with_counts=True)
        err = compare(case["out"], ref)
        check_errors(err, f"K5 {SERVE_SIZE[0]}x{SERVE_SIZE[1]} (t=0 inputs, C=3)")
        ms = cuda_ms(lambda: padded.padded_fwd_cuda(*kin, **geo), reps=20, warmup=3)
        plain_ms = cuda_ms(lambda: padded.padded_fwd_plain(*kin, **geo), reps=2, warmup=1)
        v, pp, rec = kin[0].shape
        pairs = int((kin[2] - kin[1]).sum())
        hw = SERVE_SIZE[0] * SERVE_SIZE[1]
        bound = fwd_bound(3, v, hw, int(n_eval.sum()), int(n_contrib.sum()),
                          4 * (pairs * rec + 2 * kin[1].numel()))
        print(f"  K5 fwd V={v} Pp={pp} pairs={pairs}: {ms:.4f} ms/launch, plain {plain_ms:.2f}"
              f" ms; bound {bound[0]:.4f} ms (bytes {bound[3]} -> {bound[1]:.4f} ms, FP32 ops"
              f" {bound[4]} -> {bound[2]:.4f} ms); evaluations {int(n_eval.sum())},"
              f" contributions {int(n_contrib.sum())}", flush=True)
        k5f = dict(err=max(err["image"], err["depth"], err["final_T"]), ms=ms, plain_ms=plain_ms,
                   bound=bound)
        pb = trained["train_padded"][1]
        case = padded_case(args, rig_cams(dev, *SERVE_SIZE, 5), dataclasses.replace(
            padded_binning, max_pairs=int(pb.steps[-1][1]["max_pairs"])))
        kin, geo, cot, (tfin, last) = case["kin"], case["geo"], case["cot"], case["fwd"]
        run = lambda: padded.padded_bwd_cuda(*kin, tfin, last, *cot, **geo)  # noqa: E731
        run_plain = lambda: padded.padded_bwd_plain(*kin, tfin, last, *cot, **geo)  # noqa: E731
        rows, rows_ref = run(), run_plain()
        check_rows("K5 bwd at the training shapes", {"rows": row_scaled_err(rows, rows_ref)})
        k5b_err = float((rows - rows_ref).abs().max())
        del rows_ref
        b_ms = cuda_ms(run, reps=20, warmup=3)
        b_plain_ms = cuda_ms(run_plain, reps=2, warmup=1)
        *_, n_live = padded.padded_fwd_plain(*kin, **geo, with_counts=True)
        evals, live = bwd_work(kin[1], last, geo, n_live)
        v, pp, rec = kin[0].shape
        c = rec - 7
        pairs = int((kin[2] - kin[1]).sum())
        b_bytes = 4 * (pairs * rec + 2 * kin[1].numel() + c + v * hw * (c + 4) + v * pp * rec)
        b_ops = OPS_PER_EVAL * evals + ops_bwd_per_live(c) * live
        b_tb, b_to = 1e3 * b_bytes / PEAK_BYTES_S, 1e3 * b_ops / PEAK_FP32_FLOPS
        print(f"  K5 bwd V={v} Pp={pp} pairs={pairs}; evaluations {evals}, live {live}:"
              f" {b_ms:.4f} ms/launch, plain {b_plain_ms:.2f} ms; bound {max(b_tb, b_to):.4f} ms"
              f" (bytes {b_bytes} -> {b_tb:.4f} ms, FP32 ops {b_ops} -> {b_to:.4f} ms)",
              flush=True)
        k5b = dict(err=k5b_err, ms=b_ms, plain_ms=b_plain_ms, bound=(max(b_tb, b_to), b_tb, b_to))
        pos, offsets, counts = case["pos"], case["offsets"], case["counts"]
        run = lambda: route.route_pairs_cuda(rows, pos, offsets, counts, padded=True)  # noqa: E731
        run_plain = lambda: route.route_pairs_plain(rows, pos, offsets, counts, padded=True)  # noqa: E731
        print_slot_runs("padded stream", counts)
        routed, routed_ref = run(), run_plain()
        check_rows("routing, padded mode, at the training shapes",
                   {"routing": row_scaled_err(routed, routed_ref)})
        rp_err = float((routed - routed_ref).abs().max())
        # The library yardstick at these shapes: one index_add_ of the rows
        # of the slots inside the budget by (view, gid), gathered beforehand
        # (not timed); the same function unless the render overflowed.
        s_len, n = pos.shape[1], offsets.shape[1]
        in_budget = (torch.arange(s_len, device=dev)[None]
                     < counts.long().sum(1, keepdim=True))
        q = pos.long()
        index = (torch.gather(case["gid"].long(), 1, q)
                 + n * torch.arange(v, device=dev)[:, None])[in_budget]
        slot_rows = torch.gather(rows, 1, q[..., None].expand(-1, -1, rec))[in_budget]
        library = lambda: torch.zeros((v * n, rec), device=dev).index_add_(0, index, slot_rows)  # noqa: E731
        lib_err = float((library().reshape(v, n, rec) - routed).abs().max())
        rp_ms = cuda_ms(run, reps=50, warmup=5)
        rp_plain_ms = cuda_ms(run_plain, reps=5, warmup=1)
        rp_lib_ms = cuda_ms(library, reps=50, warmup=5)
        # Bytes: the rows and slot-map entries of the slots inside the budget
        # once each (a clipped slot reads slot S - 1's again), the offsets
        # and counts, the table written once; one add per row of every slot.
        n_read = int(in_budget.sum())
        rp_bytes = 4 * (n_read * (rec + 1) + 2 * v * n + v * n * rec)
        rp_ops = int(counts.long().sum()) * rec
        rp_tb, rp_to = 1e3 * rp_bytes / PEAK_BYTES_S, 1e3 * rp_ops / PEAK_FP32_FLOPS
        print(f"  routing, padded mode (S={s_len}, slots in budget {n_read}): {rp_ms:.4f}"
              f" ms/launch, plain {rp_plain_ms:.3f} ms, index_add_ {rp_lib_ms:.4f} ms (max |d|"
              f" vs kernel {lib_err:.3e}); bound {max(rp_tb, rp_to):.4f} ms (bytes {rp_bytes} ->"
              f" {rp_tb:.4f} ms, adds {rp_ops} -> {rp_to:.5f} ms)", flush=True)
        k3p = dict(err=rp_err, ms=rp_ms, plain_ms=rp_plain_ms,
                   bound=(max(rp_tb, rp_to), rp_tb, rp_to), library_ms=rp_lib_ms)
        del case, rows, routed, routed_ref, index, slot_rows

    for k, v in ptxas_summary(_build.build_log).items():
        print(f"  ptxas {k}: {v}", flush=True)
    launched = {path: counts for path, (counts, _) in {**served, **trained}.items()}
    by_path = lambda name: {p: c[name] for p, c in launched.items() if c[name]}  # noqa: E731
    # The routing kernel has one counter; its slot mode follows the path.
    routes = by_path("route_pairs")
    routes_padded = {p: k for p, k in routes.items() if p == "train_padded"}
    routes_exact = {p: k for p, k in routes.items() if p not in routes_padded}
    kernels = [
        kernel_entry("composite_fwd", "splatpu_torch/csrc/composite_fwd.cu",
                     "splatpu/render/exact.py:856 (_fwd_kernel_grid)", by_path("composite_fwd"),
                     **k1),
        kernel_entry("composite_bwd", "splatpu_torch/csrc/composite_bwd.cu",
                     "splatpu/render/exact.py:994 (_bwd_kernel_grid)", by_path("composite_bwd"),
                     **k2),
        kernel_entry("route_pairs", "splatpu_torch/csrc/route_pairs.cu",
                     "splatpu/render/exact.py:1320 (_cumsum_pairs_pallas)", routes_exact, **k3),
        kernel_entry("route_pairs_padded", "splatpu_torch/csrc/route_pairs.cu",
                     "splatpu/render/exact.py:1320 (_cumsum_pairs_pallas); slot semantics of"
                     " splatpu/render/pallas_composite.py:507-513", routes_padded, **k3p),
        kernel_entry("composite_manual_fwd", "splatpu_torch/csrc/composite_manual_fwd.cu",
                     "splatpu/render/exact.py:608 (_fwd_kernel)", by_path("composite_manual_fwd"),
                     **k4f),
        kernel_entry("composite_manual_bwd", "splatpu_torch/csrc/composite_manual_bwd.cu",
                     "splatpu/render/exact.py:679 (_bwd_kernel)", by_path("composite_manual_bwd"),
                     **k4b),
        kernel_entry("padded_fwd", "splatpu_torch/csrc/padded_fwd.cu",
                     "splatpu/render/pallas_composite.py:113 (_fwd_kernel)",
                     by_path("padded_fwd"), **k5f),
        kernel_entry("padded_bwd", "splatpu_torch/csrc/padded_bwd.cu",
                     "splatpu/render/pallas_composite.py:200 (_bwd_kernel)",
                     by_path("padded_bwd"), **k5b),
    ]
    for entry in kernels:
        if not entry["launches"]:
            fail(f"{entry['name']} launched on no path")
    print(f"total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
