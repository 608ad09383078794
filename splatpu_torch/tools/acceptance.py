"""The acceptance runs on the JAX package's truth scene (port of
``scripts/acceptance_full.py`` and ``scripts/floor_psnr.py``).

    python -m splatpu_torch.tools.acceptance floor  [--cloud PATH] [--out DIR]
    python -m splatpu_torch.tools.acceptance stage1 [--iters 30000]
        [--prune-opacity-final F] [--eval-psnr-at 2500,5000,...]
        [--resume-from CKPT] [--stop-after N] [--out DIR]
    python -m splatpu_torch.tools.acceptance stage2 [--cloud PATH] [--iters 40]
        [--lr F] [--hidden N] [--blocks N] [--delta-scale F] [--no-quirk]
        [--no-double-residual] [--zero-init-head] [--time-gate-head]
        [--resume-from CKPT] [--stop-after N] [--out DIR]

Every subcommand takes ``--width``, ``--height``, ``--cameras``, ``--truth``
(the scene) and ``--device`` (default ``cuda``, where every render goes
through K1, and every backward through K2 and the routing kernel; ``cpu``
for tests, through their plain versions).  ``--out`` is a directory, by
default ``splatpu_acceptance`` under the system's temporary directory.

The scene is the JAX scripts' (``acceptance_full.py:33-53``): the truth
cloud is read from ``runs/acceptance_truth/truth_n120000.npz`` (BASELINE
configs 2 and 3) or ``truth_n250000.npz`` (config 4, ``--truth-n 250000``
there), which ``scripts/export_acceptance_truth.py`` writes from the JAX
package's threefry draw (``data.synthetic.make_random_cloud(prng.key(0),
n, extent=1.0, scale_range=(0.004, 0.02))`` draws the same cloud); the
rig is
``train_scene.rig_cameras`` (27 look-at cameras at 1280x720), the motion
``train_scene.moved_means`` with the flagship's rot_rate 0.003 and bob_amp
0.1.  Every target
and evaluation render runs under a budget sized from demand with headroom
1.5 over every rig camera, in chunks of at most 8 cameras, and raises if it
overflows, as the JAX scripts assert.

- ``floor`` (``floor_psnr.py:40-130``): PSNR between the undeformed fitted
  cloud (default ``runs/s1_ceiling_r4b/densified_cloud.npz``) and the truth
  moved to t in {0, 1, 75, 150}, at the first 5 cameras, both rendered as
  float32 under the truth's budget; writes ``floor.json`` with the keys of
  ``runs/floor_100k.json`` (and ``overflowed``: the JAX script does not
  check the fitted cloud's renders, so this one reports them).
- ``stage1`` (``acceptance_full.py:179-353``): float32 image and
  segmentation targets at every camera, every third truth point
  (``default_rng(0).choice``) as the initial points, ``fit`` with capacity
  factor 6.0, checkpoints every 2,500 iterations, scene radius 4.4; PSNR of
  the first 5 views at ``--eval-psnr-at`` (each under a budget sized from
  the cloud of that moment; the JAX script reuses its first) and at the
  end.  Writes ``stage1_metrics.jsonl`` (the TPU log's keys),
  ``stage1_result.json`` (the JAX keys, after every evaluation and chunk)
  and, at the end, ``densified_cloud.npz``.
- ``stage2`` (``acceptance_full.py:356-681``): 150 timesteps x 27 cameras
  of uint8 truth views staged in host memory, ``train`` with the settings
  of the TPU's stage-2 run of the truth scene (``STAGE2_RUNS``: its result
  file's ``head``, ``schedule``, ``motion``, timesteps and sequence
  iterations, and the view staging it ran with), each overridden by the
  JAX script's flag of the same name where given, a checkpoint every 5
  sequence iterations, and the rollout PSNR at t1 / t75 / t150 of camera 0
  every 5.  The 120,000-Gaussian scene's run is the config-3 flagship
  (``runs/config3_100k_r5``, ``scripts/run_flagship_r5.sh``'s
  ``device_rotate`` staging: 8 resident cameras, restaged every 10
  sequence iterations); the 250,000-Gaussian scene's is config 4
  (``runs/config4_250k``: the truth animated, ``--cloud`` pointed at the
  truth npz; the round-4 script's "host" staging, and its defaults for
  the keys that result lacks, ``schedule`` and ``time_gate_head``).
  Writes ``stage2_metrics.jsonl`` and ``stage2_result.json`` (the JAX
  keys).

``--stop-after N`` ends the process at the first checkpoint at least N
iterations (stage 1) or sequence iterations (stage 2) after its start, with
``"completed": false``; ``--resume-from`` continues from that checkpoint,
appending to the metrics and keeping the PSNR series.  As in both
packages' trainers, a resumed run draws its views from
``default_rng(seed + start)``, so a chunked run follows an unbroken one
exactly only up to the first chunk boundary.  Each result also records
the host's peak RSS, the wall time per chunk and the milliseconds per
iteration (stage 1: the fit's wall time less its evaluations; stage 2: the
median of the logged ``step_ms``, CUDA events on a card), with the
rollout evaluations kept out of both.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import resource
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from splatpu_torch.core.types import Camera, GaussianCloud, activate_cloud
from splatpu_torch.data.dataset import ViewData
from splatpu_torch.io.checkpoint import load_checkpoint, load_cloud, save_cloud
from splatpu_torch.obs.metrics import MetricsLogger
from splatpu_torch.obs.quality import psnr
from splatpu_torch.render.api import demand_binning, measure_binning_demand, render, render_dual
from splatpu_torch.tools.train_scene import moved_means, rig_cameras, stage1_points

ROOT = Path(__file__).resolve().parents[2]
TRUTH = ROOT / "runs" / "acceptance_truth" / "truth_n120000.npz"
FITTED = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
# The TPU's stage-2 run of each truth scene, by its Gaussian count, and
# the view staging that run used; another scene (the tests') takes the
# first.  Keys a result lacks take the JAX script's defaults
# (``acceptance_full.py:712-749``).
STAGE2_RUNS = {
    120_000: ("config3_100k_r5", dict(view_staging="device_rotate", resident_cameras=8,
                                      restage_every=10)),
    250_000: ("config4_250k", dict(view_staging="host")),
}
SCRIPT_SCHEDULE = {"steps_per_timestep": 1, "timestep_order": "sequential", "hidden_dim": 128,
                   "residual_blocks": 3}
DEFAULT_OUT = Path(tempfile.gettempdir()) / "splatpu_acceptance"
STAGE_CHUNK = 8          # cameras per staged render
STAGING_HEADROOM = 1.5   # demand headroom of every target and evaluation budget
EVAL_VIEWS = 5
FLOOR_TIMESTEPS = (0, 1, 75, 150)
SCENE_RADIUS = 4.4
STAGE2_CHECKPOINT_EVERY = 5  # sequence iterations, as the rollout evaluation
STAGE2_EVAL_EVERY = 5
CONFIG2 = "BASELINE config 2 shape (synthetic)"


@dataclasses.dataclass
class Scene:
    truth: GaussianCloud
    camera: Camera          # every rig camera, batched, on the device
    width: int
    height: int

    @property
    def count(self) -> int:
        return self.camera.num_views

    def cameras(self, idx: list) -> Camera:
        return Camera(w2c=self.camera.w2c[idx], K=self.camera.K[idx], width=self.width,
                      height=self.height)

    def moved(self, t: int, rot_rate: float, bob_amp: float) -> GaussianCloud:
        """The truth with its foreground turned and bobbed to timestep t."""
        means = self.truth.means.cpu().numpy()
        fg = self.truth.segmentation_masks[:, 0].cpu().numpy() > 0.5
        m = moved_means(means, fg, t, rot_rate, bob_amp)
        return self.truth.replace(means=torch.from_numpy(m).to(self.truth.means.device))


def shown(path) -> str:
    """``path`` relative to the repository when it lies inside it."""
    path = Path(path).resolve()
    return str(path.relative_to(ROOT)) if path.is_relative_to(ROOT) else str(path)


def load_scene(args) -> Scene:
    dev = torch.device(args.device)
    rig = rig_cameras(args.width, args.height, args.cameras)
    camera = Camera(w2c=torch.from_numpy(np.stack([c[0] for c in rig])).to(dev),
                    K=torch.from_numpy(np.stack([c[1] for c in rig])).to(dev),
                    width=args.width, height=args.height)
    return Scene(load_cloud(args.truth, device=dev), camera, args.width, args.height)


def staging_binning(cloud: GaussianCloud, camera: Camera):
    """The budget of the demand over ``camera``'s views with headroom 1.5
    (``acceptance_full.py:97-112``)."""
    return demand_binning(*measure_binning_demand(activate_cloud(cloud), camera),
                          headroom=STAGING_HEADROOM)


@torch.no_grad()
def render_views(scene: Scene, cloud: GaussianCloud, binning, views=None,
                 segmentation: bool = False, check: bool = True):
    """``cloud`` at the rig's cameras (``views``: a slice, default all) in
    chunks of STAGE_CHUNK: (images (V, 3, H, W), segmentations or None,
    whether any render overflowed).  ``check`` raises on an overflow."""
    args = activate_cloud(cloud)
    idx = list(range(scene.count))[views or slice(None)]
    images, segs, overflowed = [], [], False
    for c0 in range(0, len(idx), STAGE_CHUNK):
        cam = scene.cameras(idx[c0:c0 + STAGE_CHUNK])
        if segmentation:
            out, seg = render_dual(args, cloud.segmentation_masks, cam, config=binning)
            segs.append(seg.image)
            ovf = out.overflowed | seg.overflowed
        else:
            out = render(args, cam, config=binning)
            ovf = out.overflowed
        overflowed = overflowed or bool(ovf.any())
        images.append(out.image)
    if check and overflowed:
        raise RuntimeError("a staging render overflowed its budget")
    return torch.cat(images), (torch.cat(segs) if segmentation else None), overflowed


def psnr_first_views(scene: Scene, cloud: GaussianCloud, targets) -> list:
    """PSNR of the first EVAL_VIEWS views against ``targets`` under a budget
    sized from ``cloud``'s demand."""
    binning = staging_binning(cloud, scene.camera)
    imgs, _, _ = render_views(scene, cloud, binning, views=slice(0, EVAL_VIEWS))
    return [float(psnr(imgs[i], targets[i])) for i in range(imgs.shape[0])]


def peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def fresh_metrics_path(out_dir: Path, name: str, resuming: bool) -> Path:
    """A metrics file of an earlier run is moved aside (the logger appends);
    a resumed run appends (``acceptance_full.py:83-94``)."""
    path = out_dir / name
    if path.exists() and not resuming:
        i = 1
        while (rotated := path.with_suffix(f".prev{i}.jsonl")).exists():
            i += 1
        path.rename(rotated)
        print(f"  rotated stale metrics -> {rotated.name}")
    return path


def prior_result(path: Path, resuming: bool) -> dict:
    if resuming and path.exists():
        return json.loads(path.read_text())
    return {}


def chunk_end(start: int, total: int, stop_after, every: int) -> int:
    """Where this process stops: ``total``, or the first multiple of
    ``every`` at least ``stop_after`` past ``start``."""
    if not stop_after:
        return total
    return min(total, -(-(start + stop_after) // every) * every)


def run_floor(args) -> dict:
    scene = load_scene(args)
    motion = stage2_settings(scene.truth.capacity)["motion"]
    fitted = load_cloud(args.cloud, device=args.device)
    binning = staging_binning(scene.truth, scene.camera)
    ncam = slice(0, EVAL_VIEWS)
    fitted_imgs, _, fitted_ovf = render_views(scene, fitted, binning, views=ncam, check=False)
    rows, overflowed = {}, {"fitted": fitted_ovf}
    for t in FLOOR_TIMESTEPS:
        imgs, _, ovf = render_views(scene, scene.moved(t, motion["rot_rate"], motion["bob_amp"]),
                                    binning, views=ncam, check=False)
        overflowed[f"t{t}"] = ovf
        ps = [float(psnr(fitted_imgs[i], imgs[i])) for i in range(imgs.shape[0])]
        rows[f"t{t}"] = {"per_cam": ps, "mean": float(np.mean(ps))}
        print(f"t={t}: floor PSNR mean {np.mean(ps):.4f} dB ({ps})", flush=True)
    result = {
        "cloud": shown(args.cloud),
        "motion": motion,
        "scene": {"truth_n": scene.truth.capacity, "cameras": scene.count,
                  "resolution": f"{scene.width}x{scene.height}"},
        "floor_psnr": rows,
        "overflowed": overflowed,
        "note": "PSNR(undeformed fitted cloud, moved truth at t); t=0 is the static fit quality",
    }
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "floor.json").write_text(json.dumps(result, indent=2))
    return result


def stage1_targets(scene: Scene) -> list:
    """Every rig view's float32 image (clipped to [0, 1]) and segmentation
    (``acceptance_full.py:115-176``)."""
    binning = staging_binning(scene.truth, scene.camera)
    images, segs, _ = render_views(scene, scene.truth, binning, segmentation=True)
    images = torch.clamp(images, 0.0, 1.0)
    w2c, K = scene.camera.w2c.cpu().numpy(), scene.camera.K.cpu().numpy()
    return [ViewData(camera_index=i, w2c=w2c[i], K=K[i], width=scene.width, height=scene.height,
                     image=images[i], segmentation=segs[i]) for i in range(scene.count)]


def run_stage1(args) -> dict:
    from splatpu_torch.growth.densify import DensifyConfig
    from splatpu_torch.train.stage1 import Stage1Config, fit

    t0 = time.time()
    resuming = args.resume_from is not None
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result_path = out_dir / "stage1_result.json"
    prior = prior_result(result_path, resuming)
    scene = load_scene(args)
    views = stage1_targets(scene)
    targets = torch.stack([v.image for v in views[:EVAL_VIEWS]])
    pc = stage1_points(scene.truth)
    sync(args.device)
    print(f"[{time.time() - t0:.0f}s] targets rendered ({scene.count} cameras at"
          f" {scene.width}x{scene.height}); {len(pc)} initial points", flush=True)

    start = int(load_checkpoint(args.resume_from)["i"]) + 1 if resuming else 0
    every = args.checkpoint_every
    end = chunk_end(start, args.iters, args.stop_after, every)
    dcfg = DensifyConfig()
    if args.prune_opacity_final is not None:
        dcfg = dataclasses.replace(dcfg, prune_opacity_final=args.prune_opacity_final)
    cfg = Stage1Config(iterations=end, capacity_factor=6.0, densify=dcfg, checkpoint_every=every,
                       checkpoint_path=str(out_dir / "stage1_ckpt.msgpack"))
    logger = MetricsLogger(jsonl_path=fresh_metrics_path(out_dir, "stage1_metrics.jsonl",
                                                         resuming))
    eval_at = sorted(int(x) for x in (args.eval_psnr_at or "").split(",") if x.strip())
    psnr_series = list(prior.get("psnr_series", []))
    chunks = list(prior.get("chunks", []))
    wall_before = float(prior.get("wall_seconds", 0.0))
    eval_s = [0.0]

    def record(done, metrics, completed=False, **extra):
        rec = {
            "config": CONFIG2,
            "prune_opacity_final": dcfg.prune_opacity_final,
            "iterations_done": done,
            "iterations_total": args.iters,
            "cameras": scene.count,
            "resolution": f"{scene.width}x{scene.height}",
            "last": {k: float(v) for k, v in metrics.items() if np.ndim(v) == 0},
            "psnr_series": psnr_series,
            "chunks": chunks,
            "wall_seconds": wall_before + time.time() - t0,
            "completed": completed,
            **extra,
        }
        result_path.write_text(json.dumps(rec, indent=2))
        return rec

    def on_iteration(i, cloud, metrics):
        done = i + 1
        if done in eval_at:
            t_eval = time.time()
            ps = psnr_first_views(scene, cloud, targets)
            psnr_series.append({"iteration": done, "gaussians": int(cloud.n_alive()),
                                "psnr_mean": float(np.mean(ps)), "psnr_first5_views": ps})
            eval_s[0] += time.time() - t_eval
            print(f"  [psnr@{done}] {np.mean(ps):.4f} dB", flush=True)
            logger.flush()
            record(done, metrics)
        if done % args.print_every == 0:
            print(f"  [{time.time() - t0:.0f}s] iteration {done}: total_loss"
                  f" {float(metrics['total_loss']):.6f}, n_alive {int(cloud.n_alive())}",
                  flush=True)

    sync(args.device)
    t_fit = time.time()
    cloud, metrics = fit(pc, views, scene_radius=SCENE_RADIUS, config=cfg, logger=logger,
                         resume_from=args.resume_from, on_iteration=on_iteration,
                         on_iteration_every=1, device=args.device)
    sync(args.device)
    fit_s = time.time() - t_fit
    logger.close()
    chunks.append({"from": start, "to": end, "fit_seconds": fit_s, "eval_seconds": eval_s[0],
                   "ms_per_iteration": 1e3 * (fit_s - eval_s[0]) / max(end - start, 1),
                   "peak_rss_gb": peak_rss_gb()})
    print(f"[{time.time() - t0:.0f}s] iterations {start}..{end - 1} in {fit_s:.1f} s"
          f" ({chunks[-1]['ms_per_iteration']:.3f} ms per iteration without evaluations);"
          f" alive {int(cloud.n_alive())}", flush=True)
    if end < args.iters:
        return record(end, metrics)
    ps = psnr_first_views(scene, cloud, targets)
    n_alive = int(cloud.n_alive())
    final = {"iteration": args.iters, "gaussians": n_alive, "psnr_mean": float(np.mean(ps)),
             "psnr_first5_views": ps}
    psnr_series.append(final)
    save_cloud(out_dir / "densified_cloud.npz", cloud)
    return record(args.iters, metrics, completed=True, gaussians_final=n_alive,
                  iterations=args.iters, psnr_first5_views=ps, psnr_mean=final["psnr_mean"])


def stage2_settings(truth_n: int, args=None) -> dict:
    """``Stage2Config`` fields, the motion, the label, the sequence
    iterations and the timesteps of the TPU's stage-2 run of the
    ``truth_n``-Gaussian scene, from its JAX result file's ``head``,
    ``schedule`` and ``motion``, with ``args``' head flags applied."""
    name, staging = STAGE2_RUNS.get(truth_n, next(iter(STAGE2_RUNS.values())))
    r = json.loads((ROOT / "runs" / name / "stage2_result.json").read_text())
    head, sched = r["head"], {**SCRIPT_SCHEDULE, **r.get("schedule", {})}
    config = dict(
        learning_rate=head["lr"], delta_scale=head["delta_scale"],
        double_residual=head["double_residual"], zero_init_head=head["zero_init_head"],
        time_gate_head=head.get("time_gate_head", False), quirk_compat=head["quirk_compat"],
        hidden_dim=sched["hidden_dim"], residual_blocks=sched["residual_blocks"],
        steps_per_timestep=sched["steps_per_timestep"], timestep_order=sched["timestep_order"],
        **staging,
    )
    if args is not None:
        given = {"learning_rate": args.lr, "hidden_dim": args.hidden,
                 "residual_blocks": args.blocks, "delta_scale": args.delta_scale,
                 "quirk_compat": False if args.no_quirk else None,
                 "double_residual": False if args.no_double_residual else None,
                 "zero_init_head": True if args.zero_init_head else None,
                 "time_gate_head": True if args.time_gate_head else None}
        config.update({k: v for k, v in given.items() if v is not None})
    return {
        "run": name,
        "config": config,
        "motion": r["motion"],
        "label": r["config"],
        "iters": r["sequence_iterations_total"],
        "timesteps": r["timesteps"],
    }


def stage_truth_views(scene: Scene, timesteps: int, motion: dict):
    """(T, C, 3, H, W) uint8 host array: the truth moved to t = 1..T at
    every camera (``acceptance_full.py:417-476``), no overflow allowed."""
    binning = staging_binning(scene.truth, scene.camera)
    out = np.empty((timesteps, scene.count, 3, scene.height, scene.width), np.uint8)
    for t in range(1, timesteps + 1):
        imgs, _, _ = render_views(scene, scene.moved(t, motion["rot_rate"], motion["bob_amp"]),
                                  binning)
        out[t - 1] = torch.round(torch.clamp(imgs, 0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()
    return out


def overflow_stats(path: Path) -> dict:
    if not path.exists():
        return {}
    rows = [json.loads(line) for line in path.open()]
    flags = [r["binning_overflow"] for r in rows if "binning_overflow" in r]
    return {"steps_logged": len(flags), "overflow_steps": int(sum(f > 0 for f in flags)),
            "overflow_max": float(max(flags, default=0.0))}


def run_stage2(args) -> dict:
    from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
    from splatpu_torch.train.stage2 import Stage2Config, compact_cloud, rollout_step, train

    t0 = time.time()
    resuming = args.resume_from is not None
    scene = load_scene(args)
    settings = stage2_settings(scene.truth.capacity, args)
    iters = args.iters or settings["iters"]
    timesteps = args.timesteps or settings["timesteps"]
    motion = settings["motion"]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    result_path = out_dir / "stage2_result.json"
    metrics_path = out_dir / "stage2_metrics.jsonl"
    prior = prior_result(result_path, resuming)
    initial = load_cloud(args.cloud, device=args.device)

    sync(args.device)
    t_stage = time.time()
    all_imgs = stage_truth_views(scene, timesteps, motion)
    staging_s = time.time() - t_stage
    print(f"[{time.time() - t0:.0f}s] staged {timesteps} timesteps x {scene.count} cameras"
          f" ({all_imgs.nbytes / 2**30:.2f} GiB uint8) in {staging_s:.1f} s; peak RSS"
          f" {peak_rss_gb():.2f} GiB", flush=True)
    w2c, K = scene.camera.w2c.cpu().numpy(), scene.camera.K.cpu().numpy()
    views_by_timestep = [
        [ViewData(camera_index=i, w2c=w2c[i], K=K[i], width=scene.width, height=scene.height,
                  image=all_imgs[t, i], segmentation=np.zeros((3, 1, 1), np.float32))
         for i in range(scene.count)]
        for t in range(timesteps)
    ]

    every = STAGE2_CHECKPOINT_EVERY
    cfg = Stage2Config(
        total_iterations=iters, warmup_iterations=max(1, iters // 10), timestep_count=timesteps,
        checkpoint_every=every, checkpoint_path=str(out_dir / "stage2_ckpt.msgpack"),
        **settings["config"],
    )
    logger = MetricsLogger(jsonl_path=fresh_metrics_path(out_dir, "stage2_metrics.jsonl",
                                                         resuming))

    # The evaluation cloud and encoding, as ``stage2.setup`` builds them.
    dense = compact_cloud(initial.to(args.device))
    enc_init = normalize_and_encode_means_and_rotations(
        dense.means, dense.rotation_quaternions, quirk_compat=cfg.quirk_compat)
    eval_binning = staging_binning(dense, scene.camera)
    eval_ts = (1, timesteps // 2, timesteps)

    def eval_rollout(net) -> dict:
        """Autoregressive rollout PSNR of camera 0 at t1, T/2 and T
        (``acceptance_full.py:542-558``)."""
        enc_prev, ps = enc_init, {}
        for t in range(1, timesteps + 1):
            rolled, enc_prev = rollout_step(net, dense, enc_init, enc_prev, float(t), cfg)
            if t in eval_ts:
                img, _, _ = render_views(scene, rolled, eval_binning, views=slice(0, 1))
                target = torch.from_numpy(all_imgs[t - 1, 0].astype(np.float32) / 255.0)
                ps[f"t{t}"] = float(psnr(img[0], target.to(img.device)))
        return ps

    start = int(load_checkpoint(args.resume_from)["seq_it"]) + 1 if resuming else 0
    end = chunk_end(start, iters, args.stop_after, every)
    psnr_series = list(prior.get("rollout_psnr_series", []))
    chunks = list(prior.get("chunks", []))
    wall_before = float(prior.get("wall_seconds", 0.0))
    result = {
        "config": settings["label"],
        "reference_run": f"runs/{settings['run']}",
        "gaussians": scene.truth.capacity,
        "animated_cloud": shown(args.cloud),
        "timesteps": timesteps,
        "sequence_iterations_total": iters,
        "motion": motion,
        "resolution": f"{scene.width}x{scene.height}",
        "cameras": scene.count,
        "head": {"lr": cfg.learning_rate, "delta_scale": cfg.delta_scale,
                 "double_residual": cfg.double_residual, "zero_init_head": cfg.zero_init_head,
                 "time_gate_head": cfg.time_gate_head, "quirk_compat": cfg.quirk_compat},
        "schedule": {"steps_per_timestep": cfg.steps_per_timestep,
                     "timestep_order": cfg.timestep_order, "hidden_dim": cfg.hidden_dim,
                     "residual_blocks": cfg.residual_blocks},
        "staging": {"view_staging": cfg.view_staging, "resident_cameras": cfg.resident_cameras,
                    "restage_every": cfg.restage_every},
    }
    eval_s = [0.0]

    def write_result(done, metrics, final=False, **extra):
        logger.flush()
        result.update(
            sequence_iterations_done=done, total_steps_done=done * timesteps,
            last_step={k: float(v) for k, v in (metrics or {}).items() if np.ndim(v) == 0},
            binning=overflow_stats(metrics_path), rollout_psnr_series=psnr_series,
            chunks=chunks, wall_seconds=wall_before + time.time() - t0, completed=final, **extra)
        result_path.write_text(json.dumps(result, indent=2))

    def on_iteration(seq_it, net, resolved, metrics):
        result["max_pairs"] = resolved.binning.max_pairs
        done = seq_it + 1
        if done % STAGE2_EVAL_EVERY == 0 or done == iters:
            t_eval = time.time()
            psnr_series.append({"seq_it": done, **eval_rollout(net)})
            eval_s[0] += time.time() - t_eval
            print(f"  [{time.time() - t0:.0f}s] rollout PSNR @ seqit {done}: {psnr_series[-1]}",
                  flush=True)
        write_result(done, metrics)
        return done >= end and done < iters

    sync(args.device)
    t_train = time.time()
    _, _, _, last = train(initial, views_by_timestep, cfg, logger=logger, device=args.device,
                          resume_from=args.resume_from, on_iteration=on_iteration)
    sync(args.device)
    train_s = time.time() - t_train
    logger.close()
    rows = [json.loads(line) for line in metrics_path.open()]
    step_ms = [r["step_ms"] for r in rows if "step_ms" in r and r["step"] > start * timesteps]
    chunks.append({"from": start, "to": end, "staging_seconds": staging_s,
                   "train_seconds": train_s, "eval_seconds": eval_s[0],
                   "ms_per_step_median": float(np.median(step_ms)) if step_ms else None,
                   "wall_ms_per_step": 1e3 * (train_s - eval_s[0])
                   / max((end - start) * timesteps, 1),
                   "peak_rss_gb": peak_rss_gb()})
    print(f"[{time.time() - t0:.0f}s] sequence iterations {start}..{end - 1}: {train_s:.1f} s"
          f" ({eval_s[0]:.1f} s of rollout evaluation); median step"
          f" {chunks[-1]['ms_per_step_median']} ms", flush=True)
    if end < iters:
        write_result(end, last)
        return result
    totals = [r["total"] for r in rows if "total" in r]
    psnr_final = psnr_series[-1] if psnr_series else {}
    write_result(iters, last, final=True, loss_first_seqit=float(np.mean(totals[:timesteps])),
                 loss_last_seqit=float(np.mean(totals[-timesteps:])), rollout_psnr=psnr_final)
    return result


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="splatpu-torch-acceptance")
    sub = p.add_subparsers(dest="stage", required=True)

    def common(q):
        q.add_argument("--out", type=Path, default=DEFAULT_OUT)
        q.add_argument("--truth", type=Path, default=TRUTH, help="the truth cloud npz")
        q.add_argument("--width", type=int, default=1280)
        q.add_argument("--height", type=int, default=720)
        q.add_argument("--cameras", type=int, default=27)
        q.add_argument("--device", default="cuda", help="torch device (cuda, or cpu for tests)")
        return q

    f = common(sub.add_parser("floor", help="the do-nothing floor (scripts/floor_psnr.py)"))
    f.add_argument("--cloud", type=Path, default=FITTED)

    s1 = common(sub.add_parser("stage1", help="the config-2 (or config-4) fit"))
    s1.add_argument("--iters", type=int, default=30_000)
    s1.add_argument("--prune-opacity-final", type=float, default=None,
                    help="the final prune's opacity threshold (default DensifyConfig's 0.25)")
    s1.add_argument("--eval-psnr-at", default=None,
                    help="comma-separated iterations at which to evaluate the first-5-view PSNR")
    s1.add_argument("--checkpoint-every", type=int, default=2500)
    s1.add_argument("--print-every", type=int, default=500)

    s2 = common(sub.add_parser("stage2", help="the config-3 flagship run (config 4 on the"
                                              " 250,000-Gaussian truth)"))
    s2.add_argument("--cloud", type=Path, default=FITTED)
    s2.add_argument("--iters", type=int, default=None, help="default: the TPU run's (40, 30)")
    s2.add_argument("--timesteps", type=int, default=None, help="default: the TPU run's 150")
    # The JAX script's head flags (acceptance_full.py:703-738); unset, the
    # TPU run's value.
    s2.add_argument("--lr", type=float, default=None)
    s2.add_argument("--hidden", type=int, default=None, help="deformation-net hidden dim")
    s2.add_argument("--blocks", type=int, default=None, help="deformation-net residual blocks")
    s2.add_argument("--delta-scale", type=float, default=None, help="head output scale")
    s2.add_argument("--no-quirk", action="store_true",
                    help="the interleaved sin/cos encoding, not the reference's quirk")
    s2.add_argument("--no-double-residual", action="store_true",
                    help="drop the network-adds-input residual")
    s2.add_argument("--zero-init-head", action="store_true", help="zero-init the output layer")
    s2.add_argument("--time-gate-head", action="store_true",
                    help="gate the head output by progress t/T")

    for q in (s1, s2):
        q.add_argument("--resume-from", type=Path, default=None)
        q.add_argument("--stop-after", type=int, default=None,
                       help="end this process at the first checkpoint this many iterations"
                            " after its start")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    run = {"floor": run_floor, "stage1": run_stage1, "stage2": run_stage2}[args.stage]
    return run(args)


if __name__ == "__main__":
    sys.stdout.reconfigure(line_buffering=True)
    result = main()
    print(json.dumps({k: v for k, v in result.items() if k not in ("psnr_series", "chunks")},
                     indent=2))
