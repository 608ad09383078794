#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU and
check them.

    python3 chip_smoke.py

Phases, each printed with its wall time and bounded by a watchdog:

1. device: require CUDA; print the card's name and power limit.
2. build: compile ``splatpu_torch/csrc/*.cu`` with nvcc, one process per
   source, all at once (ptxas lines shown).
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
5. serve: ``run_inference`` at full width: the config-3 checkpoint's network
   (hidden 128, 3 blocks, head settings from its stage2_result.json), the
   real cloud, 150 timesteps plus t=0, five 1280x720 views per timestep
   through K1.  K1's launch count is zeroed just before and read just after.
6. train: ``train`` at full width, cut in depth: the real cloud, the
   checkpoint's network with a fresh Adam, the head settings of its result
   file, targets rendered on the card from the cloud moved as in the
   config-3 run (27 cameras, 1280x720, uint8), ``view_staging="device_u8"``,
   five views per step, shuffled timesteps; TRAIN_TIMESTEPS timesteps x
   TRAIN_ITERATIONS sequence iterations instead of 150 x 40.  Every kernel
   count is zeroed just before ``train`` and read just after; each step must
   launch K1, K2 and the routing kernel once.
7. measure: at the served shapes (the t=0 frame's inputs), K1 against its
   plain version, CUDA-event times of both, and K1's bound from this run's
   bytes and the work its data needs.
8. measure_bwd: at the training shapes (five 1280x720 rig views at the
   trainer's final budget), K2 and the routing kernel against their plain
   versions (1e-4 scaled per row; the JSON line's max_abs_err), CUDA-event
   times, the
   plain versions' times, one ``index_add_`` of the kept pairs' rows by
   (view, gid) as the routing's library yardstick, and the bounds from this
   run's inputs.

Prints one ``{"kernels": [...]}`` JSON line, then the card line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero; nothing is
caught and continued.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
TRAIN_TIMESTEPS = 8    # depth cut: config 3 trains 150 timesteps
TRAIN_ITERATIONS = 2   # depth cut: config 3 trains 40 sequence iterations
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


def ops_per_contribution(c: int) -> int:
    return 4 + 2 * (c + 1)


# Backward, per evaluated (pixel, pair): the forward's 16.  Per live pair:
# 1 - alpha, the T division, chat (2 + 2C), w, dalpha (3), the suffix update
# (2), dpower (2), the rows (mx 4, my 4, ca 3, cb 3, cc 3, depth 1, colour C)
# and the sum of the 7 + C rows over the pixels.
def ops_bwd_per_live(c: int) -> int:
    return 30 + 3 * c + 7 + c


def row_scaled_err(got, ref) -> float:
    """max over the last dimension's rows of max|got - ref| / max|ref|."""
    d = (got - ref).abs().reshape(-1, got.shape[-1]).amax(0)
    s = ref.abs().reshape(-1, ref.shape[-1]).amax(0)
    return float((d / s.clamp(min=1e-30)).max())


class StepLog:
    """The trainer's logger: per-step metrics as floats, the kernel launches
    each step made, budget growths, and whether the first step changed the
    network's parameters."""

    def __init__(self, net):
        import splatpu_torch.render.composite as composite
        import splatpu_torch.render.route as route

        self.net = net
        self.before = {k: v.detach().clone() for k, v in net.state_dict().items()}
        self.counts = lambda: (composite.LAUNCHES, composite.BWD_LAUNCHES, route.LAUNCHES)  # noqa: E731
        self.seen = None
        self.steps, self.growth_steps, self.growths = [], set(), 0
        self.changed_after_first = False

    def log(self, metrics, step):
        if "budget_growth" in metrics:
            self.growths = int(metrics["budget_growth"])
            self.growth_steps.add(step)
            print(f"  step {step}: budget growth -> {metrics}", flush=True)
            return
        now = self.counts()
        launched = [a - b for a, b in zip(now, self.seen or (0, 0, 0))]
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
              f" / budget {int(m['max_pairs'])}; launches K1/K2/route {launched}", flush=True)

    def flush(self):
        pass


def rig_all(dev):
    """All 27 rig cameras at the served size, batched."""
    import numpy as np
    import torch

    from splatpu_torch.core.types import Camera
    from splatpu_torch.tools.train_scene import rig_cameras

    cams = rig_cameras(*SERVE_SIZE)
    return Camera(w2c=torch.from_numpy(np.stack([c[0] for c in cams])).to(dev),
                  K=torch.from_numpy(np.stack([c[1] for c in cams])).to(dev),
                  width=SERVE_SIZE[0], height=SERVE_SIZE[1])


def bwd_case(args, cams, dev, binning=None):
    """K1's forward at ``cams`` and the cotangents of 0.8 L1 + 0.2 (1 - SSIM)
    against its image shifted by (3, 5) px, + 0.1 mean depth + 0.05 mean T."""
    import torch

    import splatpu_torch.render.composite as composite
    from splatpu_torch.core.ssim import ssim
    from splatpu_torch.render.api import demand_binning, measure_binning_demand
    from splatpu_torch.render.exact import composite_inputs

    if binning is None:
        binning = demand_binning(*measure_binning_demand(args, cams))
    streams, k = composite_inputs(args, cams, binning)
    kin = (k["table"].detach(), k["gid"], k["start"], k["end"],
           torch.zeros(3, device=dev))
    image, depth, tfin, last = composite.composite_fwd_cuda(*kin, **k["geometry"])
    leaves = [x.detach().clone().requires_grad_(True) for x in (image, depth, tfin)]
    target = torch.roll(image, shifts=(3, 5), dims=(2, 3))
    loss = (0.8 * (leaves[0] - target).abs().mean() + 0.2 * (1.0 - ssim(leaves[0], target))
            + 0.1 * leaves[1].mean() + 0.05 * leaves[2].mean())
    cot = tuple(g.contiguous() for g in torch.autograd.grad(loss, leaves))
    return dict(
        kin=kin, geo=k["geometry"], fwd=(tfin, last), cot=cot, binning=binning,
        offsets=torch.stack([s.offsets for s in streams]),
        counts=torch.stack([s.counts for s in streams]),
        lane=torch.stack([s.lane for s in streams]),
    )


def ptxas_summary(log: str) -> dict:
    """kernel -> 'N registers, M B smem' from nvcc's -Xptxas -v lines."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = next((k for k in ("composite_fwd", "composite_bwd", "route_pairs")
                         if k in line), None)
        elif name and "Used" in line and "registers" in line:
            out[name] = line.split("ptxas info    :")[-1].strip()
    return out


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

    with phase("compare_bwd", 240):
        import splatpu_torch.render.route as route
        from splatpu_torch.core.types import Camera
        from splatpu_torch.render.exact import CompositeTable
        from splatpu_torch.tools.train_scene import rig_cameras

        def rig5(w, h):
            cams = rig_cameras(w, h)[:5]
            return Camera(w2c=torch.from_numpy(np.stack([c[0] for c in cams])).to(dev),
                          K=torch.from_numpy(np.stack([c[1] for c in cams])).to(dev),
                          width=w, height=h)

        for w, h in (COMPARE_SIZE, SERVE_SIZE):
            case = bwd_case(args, rig5(w, h), dev)
            kin, geo, cot = case["kin"], case["geo"], case["cot"]
            rows = composite.composite_bwd_cuda(*kin, *case["fwd"], *cot, **geo)
            torch.cuda.synchronize()
            rows_ref = composite.composite_bwd_plain(*kin, *case["fwd"], *cot, **geo)
            pos = route.pos_of_slot_of(case["offsets"], kin[1], case["lane"])
            routed = route.route_pairs_cuda(rows, pos, case["offsets"], case["counts"])
            routed_ref = route.route_pairs_plain(rows, pos, case["offsets"], case["counts"])
            d_table = {}
            for impl in ("cuda", "plain"):
                table = kin[0].clone().requires_grad_(True)
                outs = CompositeTable.apply(table, kin[4], *kin[1:4], case["offsets"],
                                            case["counts"], case["lane"], geo, impl)
                torch.autograd.backward(outs[:3], cot)
                d_table[impl] = table.grad
            again = route.route_pairs_cuda(
                composite.composite_bwd_cuda(*kin, *case["fwd"], *cot, **geo), pos,
                case["offsets"], case["counts"])
            torch.cuda.synchronize()
            for name, x in (("K2 rows", rows), ("routed", routed), ("d_table", d_table["cuda"])):
                if not bool(torch.isfinite(x).all()) or not bool((x != 0).any()):
                    fail(f"{w}x{h}: {name} non-finite or all zero")
            err = {
                "K2 rows": row_scaled_err(rows, rows_ref),
                "routing": row_scaled_err(routed, routed_ref),
                "CompositeTable d_table": row_scaled_err(d_table["cuda"], d_table["plain"]),
            }
            print(f"  {w}x{h}, V=5, pairs/view max {int(kin[3][:, -1].max())}: "
                  + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
                  + f" (scaled per row); max abs rows {float((rows - rows_ref).abs().max()):.3e},"
                  f" routed {float((routed - routed_ref).abs().max()):.3e}", flush=True)
            for k, v in err.items():
                if not v <= BWD_TOL:
                    fail(f"{w}x{h}: {k} scaled error {v:.3e} > {BWD_TOL}")
            if not torch.equal(again, routed):
                fail(f"{w}x{h}: K2 + routing not bitwise identical across two runs")
            print(f"  {w}x{h}: K2 + routing bitwise identical across two runs", flush=True)
            del case, rows, rows_ref, d_table

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

    with phase("train", 480):
        import splatpu_torch.train.stage2 as stage2
        from splatpu_torch.tools.train_scene import render_targets

        t0 = time.perf_counter()
        views = render_targets(cloud, TRAIN_TIMESTEPS, *SERVE_SIZE, impl="cuda", device=dev)
        torch.cuda.synchronize()
        print(f"  targets: {TRAIN_TIMESTEPS} timesteps x {len(views[0])} cameras,"
              f" {SERVE_SIZE[0]}x{SERVE_SIZE[1]} uint8, rendered in"
              f" {time.perf_counter() - t0:.2f} s", flush=True)
        tnet, thead = load_stage2_run(RUN, device=dev)
        tc = tnet.config
        tcfg = stage2.Stage2Config(
            total_iterations=TRAIN_ITERATIONS, warmup_iterations=1,
            learning_rate=thead["lr"], hidden_dim=tc.hidden_dim,
            residual_blocks=tc.residual_blocks, views_per_step=5,
            timestep_count=TRAIN_TIMESTEPS, renderer="cuda",
            quirk_compat=thead["quirk_compat"], view_staging="device_u8",
            timestep_order="shuffled", overflow_check_every=1,
            **{k: thead[k] for k in ("delta_scale", "double_residual", "zero_init_head",
                                     "time_gate_head")},
        )
        print(f"  depth cut: {TRAIN_TIMESTEPS} timesteps x {TRAIN_ITERATIONS} sequence"
              f" iterations (config 3: 150 x 40); width untouched", flush=True)
        log = StepLog(tnet)
        torch.cuda.synchronize()
        composite.LAUNCHES = composite.BWD_LAUNCHES = route.LAUNCHES = 0
        t0 = time.perf_counter()
        tnet, _, _, _ = stage2.train(cloud, views, tcfg, logger=log, initial_net=tnet, device=dev)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        train_launches = {"composite_fwd": composite.LAUNCHES,
                          "composite_bwd": composite.BWD_LAUNCHES,
                          "route_pairs": route.LAUNCHES}
        n_steps = TRAIN_ITERATIONS * TRAIN_TIMESTEPS
        step_ms = np.array([m["step_ms"] for _, m in log.steps])
        print(f"  train(): {n_steps} steps in {train_s:.2f} s wall (setup and staging"
              f" included); step ms (CUDA events) mean {step_ms.mean():.2f} median"
              f" {np.median(step_ms):.2f} min {step_ms.min():.2f} max {step_ms.max():.2f};"
              f" launches {train_launches}; growths {log.growths}", flush=True)
        if len(log.steps) != n_steps:
            fail(f"train logged {len(log.steps)} steps, expected {n_steps}")
        for name, n in train_launches.items():
            if n != n_steps:
                fail(f"{name} launched {n} times in {n_steps} training steps, expected {n_steps}")
        for step_idx, m in log.steps:
            if not np.isfinite(m["total"]):
                fail(f"step {step_idx}: non-finite loss {m['total']}")
            if not (np.isfinite(m["grad_norm"]) and m["grad_norm"] > 0):
                fail(f"step {step_idx}: grad_norm {m['grad_norm']}")
            if any(d != 1 for d in m["launched"]):
                fail(f"step {step_idx}: kernel launches {m['launched']}, expected one each")
            if m["binning_overflow"] and step_idx not in log.growth_steps:
                fail(f"step {step_idx}: binning overflow not followed by growth")
        if log.steps[-1][1]["binning_overflow"]:
            fail("binning overflow left after growth at the last step")
        if not log.changed_after_first:
            fail("parameters unchanged after the first step")
        train_binning = dataclasses.replace(
            demand_binning(*measure_binning_demand(args, rig_all(dev))),
            max_pairs=int(log.steps[-1][1]["max_pairs"]))
        del views

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

    with phase("measure_bwd", 300):
        from splatpu_torch.render.composite import to_tiles

        case = bwd_case(args, rig5(*SERVE_SIZE), dev, binning=train_binning)
        kin, geo, cot, (tfin, last) = case["kin"], case["geo"], case["cot"], case["fwd"]
        offsets, counts, lane = case["offsets"], case["counts"], case["lane"]
        bwd = lambda: composite.composite_bwd_cuda(*kin, tfin, last, *cot, **geo)  # noqa: E731
        bwd_plain = lambda: composite.composite_bwd_plain(*kin, tfin, last, *cot, **geo)  # noqa: E731
        rows = bwd()
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
        rows_ref = bwd_plain()
        routed_ref = route.route_pairs_plain(rows, pos, offsets, counts)
        train_err = {"K2 rows": row_scaled_err(rows, rows_ref),
                     "routing": row_scaled_err(routed, routed_ref)}
        print("  at the training shapes: " + ", ".join(
            f"{k} {v:.3e}" for k, v in train_err.items()) + " (scaled per row)", flush=True)
        for k, e in train_err.items():
            if not e <= BWD_TOL:
                fail(f"training shapes: {k} scaled error {e:.3e} > {BWD_TOL}")
        k2_abs = float((rows - rows_ref).abs().max())
        k3_abs = float((routed - routed_ref).abs().max())
        del rows_ref
        k2_ms = cuda_ms(bwd, reps=20, warmup=3)
        k2_plain_ms = cuda_ms(bwd_plain, reps=2, warmup=1)
        k3_ms = cuda_ms(lambda: route.route_pairs_cuda(rows, pos, offsets, counts), reps=50, warmup=5)
        k3_plain_ms = cuda_ms(lambda: route.route_pairs_plain(rows, pos, offsets, counts), reps=5,
                              warmup=1)
        k3_lib_ms = cuda_ms(library, reps=50, warmup=5)
        # The work these inputs need: every (pixel, pair) from the tile's start
        # to the pixel's last is evaluated; the contributing ones are live.
        *_, n_eval_f, n_live = composite.composite_fwd_plain(*kin, **geo, with_counts=True)
        last_t = to_tiles(last[:, None].long(), geo["tiles_x"], geo["tiles_y"], geo["tile"],
                          fill=-1)[..., 0]
        start_t = kin[2].reshape(-1).long()[:, None]
        evals = int(torch.where(last_t >= 0, last_t - start_t + 1, torch.zeros_like(last_t)).sum())
        live = int(n_live.sum())
        hw = geo["width"] * geo["height"]
        pairs = int(kin[3][:, -1].sum())
        n_kept = int(kept.sum())
        k2_bytes = 4 * (v * n * rec + pairs + 2 * kin[2].numel() + c + v * hw * (c + 4)
                        + v * p * rec)
        k2_ops = OPS_PER_EVAL * evals + ops_bwd_per_live(c) * live
        k2_tb, k2_to = 1e3 * k2_bytes / PEAK_BYTES_S, 1e3 * k2_ops / PEAK_FP32_FLOPS
        k3_bytes = 4 * (n_kept * rec + v * p + 2 * v * n + v * n * rec)
        k3_ops = n_kept * rec
        k3_tb, k3_to = 1e3 * k3_bytes / PEAK_BYTES_S, 1e3 * k3_ops / PEAK_FP32_FLOPS
        regs = ptxas_summary(_build.build_log)
        print(f"  V={v} N={n} P={p} pairs={pairs} kept={n_kept}; backward evaluations {evals},"
              f" live {live}", flush=True)
        print(f"  K2 {k2_ms:.4f} ms/launch, plain {k2_plain_ms:.2f} ms; bound"
              f" {max(k2_tb, k2_to):.4f} ms (bytes {k2_bytes} -> {k2_tb:.4f} ms, FP32 ops"
              f" {k2_ops} -> {k2_to:.4f} ms); ptxas {regs.get('composite_bwd')}", flush=True)
        print(f"  routing {k3_ms:.4f} ms/launch, plain {k3_plain_ms:.3f} ms, index_add_"
              f" {k3_lib_ms:.4f} ms (max |d| vs kernel {lib_err:.3e}); bound"
              f" {max(k3_tb, k3_to):.4f} ms (bytes {k3_bytes} -> {k3_tb:.4f} ms, adds"
              f" {k3_ops} -> {k3_to:.5f} ms); ptxas {regs.get('route_pairs')}", flush=True)
        print(f"  K1 ptxas {regs.get('composite_fwd')}", flush=True)

    kernels = [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "splatpu_torch/csrc/composite_fwd.cu",
        "replaces": "splatpu/render/exact.py:856 (_fwd_kernel_grid)",
        "launches": launches + train_launches["composite_fwd"],
        "launches_by_path": {"serve": launches, "train": train_launches["composite_fwd"]},
        "max_abs_err": max(err["image"], err["depth"], err["final_T"]),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": None,
    }, {
        "name": "composite_bwd",
        "route": "cuda",
        "source": "splatpu_torch/csrc/composite_bwd.cu",
        "replaces": "splatpu/render/exact.py:994 (_bwd_kernel_grid)",
        "launches": train_launches["composite_bwd"],
        "launches_by_path": {"train": train_launches["composite_bwd"]},
        "max_abs_err": k2_abs,
        "ms": k2_ms,
        "plain_ms": k2_plain_ms,
        "bound_ms": max(k2_tb, k2_to),
        "bound_by": "operations" if k2_to >= k2_tb else "bytes",
        "library_ms": None,
    }, {
        "name": "route_pairs",
        "route": "cuda",
        "source": "splatpu_torch/csrc/route_pairs.cu",
        "replaces": "splatpu/render/exact.py:1320 (_cumsum_pairs_pallas)",
        "launches": train_launches["route_pairs"],
        "launches_by_path": {"train": train_launches["route_pairs"]},
        "max_abs_err": k3_abs,
        "ms": k3_ms,
        "plain_ms": k3_plain_ms,
        "bound_ms": max(k3_tb, k3_to),
        "bound_by": "operations" if k3_to >= k3_tb else "bytes",
        "library_ms": k3_lib_ms,
    }]
    print(f"total {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
