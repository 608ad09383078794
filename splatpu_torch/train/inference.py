"""Free-viewpoint inference: the deformation rollout rendered from the five
orbit cameras (port of ``splatpu/train/inference.py:28-325``).

Five virtual cameras (yaw 0/90/180/270 at distance 2.4 and height 1.3, and a
top view at 4.5) at 1280x720 with per-view focal factors 0.82/0.52/0.52/
0.52/0.35.  Each timestep 1..T deforms the initial cloud from the previous
step's encoding and renders all five views in one batched render; the t=0
frame comes last and is put first, as in the JAX package.  ``timestep_count``
is also the progress normaliser, so a shorter rollout is a different
computation, not a prefix.

``config.renderer`` picks the render path (``render/api.py``); with no
``config.binning`` the budget is sized at 32 px tiles, as in the JAX
package, so the padded path (``"cuda_padded"``) needs a 16 px binning and
``kernel="manual"`` comes in through the binning, not through
``binning_overrides``, which serving does not read.

The pair budget is sized from measured demand (the orbit cameras and the
timestep-0 real views, where given); an overflowed render is rendered again
under a doubled budget (pair and span growth apart), at most
``MAX_BUDGET_GROWTHS`` times.  Frames come back as uint8 (H, W, 3) arrays;
with an ``output_directory`` they are also written as
``frames/<camera>/<t:06d>.png`` and each camera's as a video
(``io/video.py``: MP4, or GIF where imageio writes no MP4 or is not
installed).  With real views
(``views_by_timestep``) each timestep's mean image loss (0.8 L1 + 0.2
(1 - SSIM)) over them is taken, in one render per image size.

The stages of each timestep are ``torch.profiler`` ranges named ``rollout``,
``render``, ``flags`` (the overflow read), ``frames`` (uint8 to the host)
and ``eval`` (the real-view loss); ``splatpu_torch.tools.profile_serving``
reads them.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import defaultdict
from pathlib import Path
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from splatpu_torch.core.ssim import ssim
from splatpu_torch.core.types import Camera, GaussianCloud, activate_cloud, stack_cameras
from splatpu_torch.dynamics.network import DeformationNet
from splatpu_torch.io.video import write_frame, write_video
from splatpu_torch.render.api import (
    PADDED_IMPLS,
    demand_binning,
    measure_binning_demand,
    render,
    resolve_impl,
)
from splatpu_torch.render.binning import DEFAULT_TILE, grow_for_span_overflow
from splatpu_torch.train.losses import L1_WEIGHT, SSIM_WEIGHT
from splatpu_torch.train.stage2 import Stage2Config, rollout_step

RENDER_WIDTH = 1280
RENDER_HEIGHT = 720
MAX_BUDGET_GROWTHS = 4  # as the JAX package's inference loop


def create_transformation_matrix(yaw_degrees: float, height: float, distance: float):
    y = np.radians(yaw_degrees)
    return np.array(
        [
            [np.cos(y), 0.0, -np.sin(y), 0.0],
            [0.0, 1.0, 0.0, height],
            [np.sin(y), 0.0, np.cos(y), distance],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )


def create_orbit_cameras(
    width: int = RENDER_WIDTH, height: int = RENDER_HEIGHT, device="cuda"
) -> dict[str, Camera]:
    specs = {
        "000": (create_transformation_matrix(0, 1.3, 2.4), 0.82),
        "090": (create_transformation_matrix(90, 1.3, 2.4), 0.52),
        "180": (create_transformation_matrix(180, 1.3, 2.4), 0.52),
        "270": (create_transformation_matrix(270, 1.3, 2.4), 0.52),
        "top": (
            np.array(
                [
                    [1.0, 0.0, 0.0, 0.0],
                    [0.0, 0.0, -1.0, 0.0],
                    [0.0, 1.0, 0.0, 4.5],
                    [0.0, 0.0, 0.0, 1.0],
                ]
            ),
            0.35,
        ),
    }
    cameras = {}
    for name, (w2c, aspect) in specs.items():
        K = np.array(
            [
                [aspect * width, 0.0, width / 2.0],
                [0.0, aspect * width, height / 2.0],
                [0.0, 0.0, 1.0],
            ]
        )
        cameras[name] = Camera(
            w2c=torch.tensor(w2c, dtype=torch.float32, device=device),
            K=torch.tensor(K, dtype=torch.float32, device=device),
            width=width,
            height=height,
        )
    return cameras


def to_uint8_frames(images: torch.Tensor) -> np.ndarray:
    """(V, 3, H, W) float -> (V, H, W, 3) uint8 on the host, clipped and
    truncated like the JAX package's ``to_uint8_frame``."""
    with record_function("frames"):
        u8 = (255.0 * torch.clamp(images, 0.0, 1.0)).to(torch.uint8)
        return u8.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def group_by_resolution(views, device) -> dict[tuple[int, int], tuple[Camera, torch.Tensor]]:
    """Views bucketed by (width, height): per size one batched camera and
    the float targets (uint8 views divided by 255)."""
    groups = defaultdict(list)
    for v in views:
        groups[(int(v.width), int(v.height))].append(v)
    out = {}
    for (w, h), vs in groups.items():
        targets = np.stack([v.image for v in vs])
        if targets.dtype == np.uint8:
            targets = targets.astype(np.float32) / 255.0
        cams = Camera(
            w2c=torch.from_numpy(np.stack([v.w2c for v in vs]).astype(np.float32)).to(device),
            K=torch.from_numpy(np.stack([v.K for v in vs]).astype(np.float32)).to(device),
            width=w, height=h)
        out[w, h] = (cams, torch.from_numpy(np.ascontiguousarray(targets)).to(device))
    return out


def run_inference(
    net: DeformationNet,
    initial_cloud: GaussianCloud,
    encoded_initial: torch.Tensor,
    config: Stage2Config,
    width: Optional[int] = None,
    height: Optional[int] = None,
    device="cuda",
    output_directory=None,
    views_by_timestep=None,
    fps: int = 30,
    renderer: Optional[str] = None,
    logger=None,
):
    """Roll out timesteps 1..T and render the orbit cameras.

    Returns ``(frames, stats)``: ``frames[name]`` is the list of T + 1 uint8
    (H, W, 3) frames of that camera (t = 0 first); ``stats`` holds the
    demand and budget, the pairs used, the growths, whether an overflow was
    left after growth, non-finite image values, per-timestep times (CUDA
    events on a card), ``mean_losses`` (per timestep, the mean image loss
    over ``views_by_timestep[t - 1]``; empty without views) and ``videos``
    (the video files written).  The JAX package returns ``(frames,
    mean_losses)``.  ``width`` and ``height`` default to ``RENDER_WIDTH``
    and ``RENDER_HEIGHT`` as they are at the call.  ``renderer`` overrides ``config.renderer``; ``logger``
    gets ``mean-image-loss`` at step ``total_iterations * T + t`` and each
    camera's frames as a video.
    """
    device = torch.device(device)
    width = RENDER_WIDTH if width is None else width
    height = RENDER_HEIGHT if height is None else height
    impl = renderer or config.renderer
    net = net.to(device)
    initial_cloud = initial_cloud.to(device)
    encoded_initial = encoded_initial.to(device)
    cameras = create_orbit_cameras(width, height, device=device)
    cam_names = list(cameras)
    cams = stack_cameras([cameras[n] for n in cam_names])
    out_dir = None if output_directory is None else Path(output_directory)

    binning = config.binning
    demand = (None, None)
    if binning is None:
        # At the padded path's fixed 16 px tile there, as ``render`` sizes
        # its default; the run's budget flags (a --tile, say) apply too.
        tile = 16 if resolve_impl(impl, device) in PADDED_IMPLS else DEFAULT_TILE
        margs = activate_cloud(initial_cloud)
        demand = measure_binning_demand(margs, cams, tile=tile)
        if views_by_timestep is not None:
            for group_cams, _ in group_by_resolution(views_by_timestep[0], device).values():
                dp, ds = measure_binning_demand(margs, group_cams, tile=tile)
                demand = (max(demand[0], dp), max(demand[1], ds))
        binning = demand_binning(*demand, tile=tile, overrides=config.binning_overrides)
    n_rows = initial_cloud.capacity
    state = {"binning": binning, "growths": 0, "residual_overflow": False,
             "pairs_used": 0, "renders": 0,
             "nonfinite": torch.zeros((), dtype=torch.int64, device=device)}

    def render_grown(args, views: Camera) -> torch.Tensor:
        while True:
            with record_function("render"):
                out = render(args, views, impl=impl, config=state["binning"])
            with record_function("flags"):
                flags = torch.stack(
                    [out.overflowed.any().long(), out.span_overflowed.any().long(),
                     out.total_pairs.max().long()]
                ).cpu()
            ovf, sovf, pairs = (int(x) for x in flags)
            state["renders"] += 1
            state["pairs_used"] = max(state["pairs_used"], pairs)
            if ovf and state["growths"] < MAX_BUDGET_GROWTHS:
                b = state["binning"]
                if sovf:
                    b = grow_for_span_overflow(b, n_rows)
                else:
                    b = dataclasses.replace(b, max_pairs=min(b.max_pairs * 2, 1 << 24))
                state["binning"] = b
                state["growths"] += 1
                continue
            if ovf and not state["residual_overflow"]:
                warnings.warn(
                    "inference: binning budget overflowed after all growths;"
                    " frames are dropping splats", stacklevel=2,
                )
                state["residual_overflow"] = True
            state["nonfinite"] += (~torch.isfinite(out.image)).sum()
            return out.image

    def mean_image_loss(cloud: GaussianCloud, views) -> float:
        """The mean over ``views`` of 0.8 L1 + 0.2 (1 - SSIM), one render
        per image size."""
        args = activate_cloud(cloud)
        total = torch.zeros((), dtype=torch.float32, device=device)
        for group_cams, targets in group_by_resolution(views, device).values():
            image = render_grown(args, group_cams)
            with record_function("eval"):
                l1 = (image - targets).abs().mean(dim=(1, 2, 3))
                ss = 1.0 - ssim(image, targets, size_average=False)
                total = total + (L1_WEIGHT * l1 + SSIM_WEIGHT * ss).sum()
        return float(total) / len(views)

    on_card = device.type == "cuda"
    marks = []

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    def export(imgs: np.ndarray, timestep: int, first: bool = False) -> None:
        for i, name in enumerate(cam_names):
            if out_dir is not None:
                write_frame(out_dir / "frames" / name / f"{timestep:06d}.png", imgs[i])
            if first:
                frames[name].insert(0, imgs[i])
            else:
                frames[name].append(imgs[i])

    frames = defaultdict(list)
    mean_losses = []
    t_count = config.timestep_count
    enc_prev = encoded_initial
    mark()
    for timestep in range(1, t_count + 1):
        with record_function("rollout"):
            cloud, enc_prev = rollout_step(
                net, initial_cloud, encoded_initial, enc_prev, timestep, config
            )
        export(to_uint8_frames(render_grown(activate_cloud(cloud), cams)), timestep)
        if views_by_timestep is not None:
            mean_losses.append(mean_image_loss(cloud, views_by_timestep[timestep - 1]))
            if logger is not None:
                logger.log({"mean-image-loss": mean_losses[-1]},
                           step=config.total_iterations * t_count + timestep)
        mark()
    export(to_uint8_frames(render_grown(activate_cloud(initial_cloud), cams)), 0, first=True)
    if on_card:
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]
    videos = {}
    for name in cam_names:
        if out_dir is not None:
            videos[name] = write_video(out_dir / f"{name}.mp4", frames[name], fps=fps)
        if logger is not None:
            logger.log_video(f"{name}-video", frames[name], fps=fps)
    if logger is not None:
        logger.flush()

    b = state["binning"]
    stats = {
        "binning": b,
        "demand_pairs": demand[0],
        "demand_span": demand[1],
        "max_pairs": b.max_pairs,
        "max_span": b.max_span,
        "initial_max_pairs": binning.max_pairs,
        "pairs_used": state["pairs_used"],
        "growths": state["growths"],
        "residual_overflow": state["residual_overflow"],
        "renders": state["renders"],
        "nonfinite_pixels": int(state["nonfinite"]),
        "timestep_ms": step_ms,
        "timer": "cuda_events" if on_card else "host_clock",
        "mean_losses": mean_losses,
        "videos": videos,
    }
    return dict(frames), stats
