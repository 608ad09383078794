"""Free-viewpoint inference: the deformation rollout rendered from the five
orbit cameras (port of ``splatpu/train/inference.py:28-325``).

Five virtual cameras (yaw 0/90/180/270 at distance 2.4 and height 1.3, and a
top view at 4.5) at 1280x720 with per-view focal factors 0.82/0.52/0.52/
0.52/0.35.  Each timestep 1..T deforms the initial cloud from the previous
step's encoding and renders all five views in one batched render; the t=0
frame comes last and is put first, as in the JAX package.  ``timestep_count``
is also the progress normaliser, so a shorter rollout is a different
computation, not a prefix.

The pair budget is sized from measured demand; an overflowed render is
rendered again under a doubled budget (pair and span growth apart), at most
``MAX_BUDGET_GROWTHS`` times.  Frames come back as uint8 (H, W, 3) arrays;
PNG / MP4 export and the real-view loss are not part of the port yet.

The stages of each timestep are ``torch.profiler`` ranges named ``rollout``,
``render``, ``flags`` (the overflow read) and ``frames`` (uint8 to the
host); ``splatpu_torch.tools.profile_serving`` reads them.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from collections import defaultdict

import numpy as np
import torch
from torch.profiler import record_function

from splatpu_torch.core.types import Camera, GaussianCloud, activate_cloud, stack_cameras
from splatpu_torch.dynamics.network import DeformationNet
from splatpu_torch.render.api import demand_binning, measure_binning_demand, render
from splatpu_torch.render.binning import grow_for_span_overflow
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


def run_inference(
    net: DeformationNet,
    initial_cloud: GaussianCloud,
    encoded_initial: torch.Tensor,
    config: Stage2Config,
    width: int = RENDER_WIDTH,
    height: int = RENDER_HEIGHT,
    device="cuda",
):
    """Roll out timesteps 1..T and render the orbit cameras.

    Returns ``(frames, stats)``: ``frames[name]`` is the list of T + 1 uint8
    (H, W, 3) frames of that camera (t = 0 first); ``stats`` holds the
    demand and budget, the pairs used, the growths, whether an overflow was
    left after growth, non-finite image values, and per-timestep times
    (CUDA events on a card).
    """
    device = torch.device(device)
    impl = config.renderer
    net = net.to(device)
    initial_cloud = initial_cloud.to(device)
    encoded_initial = encoded_initial.to(device)
    cameras = create_orbit_cameras(width, height, device=device)
    cam_names = list(cameras)
    cams = stack_cameras([cameras[n] for n in cam_names])

    binning = config.binning
    demand = (None, None)
    if binning is None:
        demand = measure_binning_demand(activate_cloud(initial_cloud), cams)
        binning = demand_binning(*demand)
    n_rows = initial_cloud.capacity
    state = {"binning": binning, "growths": 0, "residual_overflow": False,
             "pairs_used": 0, "renders": 0,
             "nonfinite": torch.zeros((), dtype=torch.int64, device=device)}

    def render_all(cloud: GaussianCloud) -> torch.Tensor:
        args = activate_cloud(cloud)
        while True:
            with record_function("render"):
                out = render(args, cams, impl=impl, config=state["binning"])
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

    on_card = device.type == "cuda"
    marks = []

    def mark():
        if on_card:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    frames = defaultdict(list)
    enc_prev = encoded_initial
    mark()
    for timestep in range(1, config.timestep_count + 1):
        with record_function("rollout"):
            cloud, enc_prev = rollout_step(
                net, initial_cloud, encoded_initial, enc_prev, timestep, config
            )
        imgs = to_uint8_frames(render_all(cloud))
        for i, name in enumerate(cam_names):
            frames[name].append(imgs[i])
        mark()
    imgs0 = to_uint8_frames(render_all(initial_cloud))
    for i, name in enumerate(cam_names):
        frames[name].insert(0, imgs0[i])
    if on_card:
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in zip(marks[:-1], marks[1:])]
    else:
        step_ms = [1e3 * (b - a) for a, b in zip(marks[:-1], marks[1:])]

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
    }
    return dict(frames), stats
