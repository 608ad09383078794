"""A config-3 training problem made from the repo's own files and a seed, for
driving ``train`` on the card (``chip_smoke.py``, ``profile_training``).

- The camera rig of ``scripts/acceptance_full.py:33-58``: 27 look-at
  cameras on a ring of radius 4 around the origin, heights
  0.4 + 0.6 N(0, 1) from ``np.random.default_rng(1)``, 1280x720, focal
  0.8 W.
- The motion of ``scripts/acceptance_full.py:393-407``: the foreground
  (segmentation channel 0 > 0.5) turns about the vertical axis through its
  centre by ``rot_rate * t`` and bobs by ``bob_amp * sin(2 pi t / 50)``;
  config 3 used rot_rate 0.003 and bob_amp 0.1.
- The targets: the cloud itself, moved to each timestep, rendered by the
  port's forward composite at the 27 cameras and quantised to uint8 as the
  acceptance harness stages them.  (The flagship run rendered a JAX-random
  truth cloud instead, which needs JAX to reproduce.)

Stage 1 at BASELINE config 2 (``scripts/acceptance_full.py:188-205``): the
truth cloud's image and segmentation rendered at the 27 rig cameras
(``render_stage1_targets``), and every third truth Gaussian as the initial
points (``stage1_points``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatpu_torch.core.types import Camera, GaussianCloud, activate_cloud
from splatpu_torch.data.dataset import ViewData
from splatpu_torch.data.synthetic import lookat_matrices
from splatpu_torch.render.api import (
    demand_binning,
    measure_binning_demand,
    render,
    render_dual,
)
from splatpu_torch.render.binning import grow_for_span_overflow

RIG_CAMERAS = 27
ROT_RATE = 0.003
BOB_AMP = 0.1


def rig_cameras(width: int = 1280, height: int = 720, count: int = RIG_CAMERAS):
    """[(w2c (4, 4), K (3, 3))] float32 numpy of the ring rig."""
    rng = np.random.default_rng(1)
    cams = []
    for i in range(count):
        a = 2 * np.pi * i / count
        eye = (4.0 * np.sin(a), 0.4 + 0.6 * rng.standard_normal(), -4.0 * np.cos(a))
        cams.append(lookat_matrices(eye=eye, width=width, height=height, focal=0.8 * width))
    return cams


def moved_means(means: np.ndarray, fg: np.ndarray, t: int, rot_rate: float = ROT_RATE,
                bob_amp: float = BOB_AMP) -> np.ndarray:
    center = means[fg].mean(0, keepdims=True)
    phase = 2 * np.pi * t / 50.0
    a = rot_rate * t
    rot = np.array(
        [[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]], np.float32
    )
    m = means.copy()
    m[fg] = (means[fg] - center) @ rot.T + center
    m[fg, 1] += bob_amp * np.sin(phase)
    return m


@torch.no_grad()
def render_targets(cloud: GaussianCloud, timesteps: int, width: int = 1280, height: int = 720,
                   impl: str = "auto", chunk: int = 9, device="cuda", start: int = 1):
    """``views_by_timestep`` for timesteps start..start + T - 1 (1..T by
    default; from 0 for a sequence's frames, frame 0 the cloud unmoved): the
    moved cloud rendered at the rig, uint8 (3, H, W) images on the host.
    The budget is sized from demand at t = 0 over all cameras, doubled on
    overflow."""
    device = torch.device(device)
    cloud = cloud.to(device)
    cams = rig_cameras(width, height)
    w2c = torch.from_numpy(np.stack([c[0] for c in cams])).to(device)
    K = torch.from_numpy(np.stack([c[1] for c in cams])).to(device)
    binning = demand_binning(*measure_binning_demand(
        activate_cloud(cloud), Camera(w2c=w2c, K=K, width=width, height=height)))
    means = cloud.means.cpu().numpy()
    fg = cloud.segmentation_masks[:, 0].cpu().numpy() > 0.5
    views = []
    for t in range(start, start + timesteps):
        moved = cloud.replace(means=torch.from_numpy(moved_means(means, fg, t)).to(device))
        args = activate_cloud(moved)
        imgs = []
        for c0 in range(0, len(cams), chunk):
            sl = slice(c0, c0 + chunk)
            cam = Camera(w2c=w2c[sl], K=K[sl], width=width, height=height)
            for _ in range(4):
                out = render(args, cam, impl=impl, config=binning)
                if not bool(out.overflowed.any()):
                    break
                if bool(out.span_overflowed.any()):
                    binning = grow_for_span_overflow(binning, cloud.capacity)
                else:
                    binning = dataclasses.replace(binning, max_pairs=binning.max_pairs * 2)
            else:
                raise RuntimeError("target render still overflows after budget growth")
            u8 = torch.round(torch.clamp(out.image, 0.0, 1.0) * 255.0).to(torch.uint8)
            imgs.append(u8.cpu().numpy())
        imgs = np.concatenate(imgs)
        views.append([
            ViewData(camera_index=i, w2c=cams[i][0], K=cams[i][1], width=width, height=height,
                     image=imgs[i], segmentation=np.zeros((3, 1, 1), np.float32))
            for i in range(len(cams))
        ])
    return views


def rig_scene_radius(width: int = 1280, height: int = 720) -> float:
    """``data.dataset.get_scene_radius`` of the rig: 1.1 times the largest
    distance of a camera centre from their mean."""
    centers = np.linalg.inv(np.stack([c[0] for c in rig_cameras(width, height)]))[:, :3, 3]
    return float(1.1 * np.max(np.linalg.norm(centers - centers.mean(0, keepdims=True), axis=-1)))


def stage1_points(cloud: GaussianCloud, seed: int = 0) -> np.ndarray:
    """(N // 3, 7) initial points from the alive rows of a truth cloud:
    means, colours clipped to [0, 1], segmentation channel 0 > 0.5, the
    rows ``np.random.default_rng(seed).choice(N, N // 3, replace=False)``."""
    alive = cloud.alive.cpu().numpy()
    pc = np.concatenate([
        cloud.means.cpu().numpy()[alive],
        np.clip(cloud.colors.cpu().numpy()[alive], 0.0, 1.0),
        (cloud.segmentation_masks.cpu().numpy()[alive][:, :1] > 0.5).astype(np.float32),
    ], axis=1)
    keep = np.random.default_rng(seed).choice(len(pc), size=len(pc) // 3, replace=False)
    return pc[keep]


@torch.no_grad()
def render_stage1_targets(cloud: GaussianCloud, width: int = 1280, height: int = 720,
                          impl: str = "auto", chunk: int = 9, device="cuda"):
    """Timestep 0 at the rig: ``ViewData`` whose image and segmentation are
    the cloud's renders (float32 (3, H, W) tensors on ``device``), through
    ``render_dual`` at a budget sized from demand, doubled on overflow."""
    device = torch.device(device)
    cloud = cloud.to(device)
    cams = rig_cameras(width, height)
    w2c = torch.from_numpy(np.stack([c[0] for c in cams])).to(device)
    K = torch.from_numpy(np.stack([c[1] for c in cams])).to(device)
    args = activate_cloud(cloud)
    binning = demand_binning(*measure_binning_demand(
        args, Camera(w2c=w2c, K=K, width=width, height=height)))
    images, segs = [], []
    for c0 in range(0, len(cams), chunk):
        cam = Camera(w2c=w2c[c0:c0 + chunk], K=K[c0:c0 + chunk], width=width, height=height)
        for _ in range(4):
            out, seg = render_dual(args, cloud.segmentation_masks, cam, impl=impl, config=binning)
            if not bool(out.overflowed.any()):
                break
            binning = (grow_for_span_overflow(binning, cloud.capacity)
                       if bool(out.span_overflowed.any())
                       else dataclasses.replace(binning, max_pairs=binning.max_pairs * 2))
        else:
            raise RuntimeError("target render still overflows after budget growth")
        images.append(out.image)
        segs.append(seg.image)
    images, segs = torch.cat(images), torch.cat(segs)
    return [ViewData(camera_index=i, w2c=cams[i][0], K=cams[i][1], width=width, height=height,
                     image=images[i], segmentation=segs[i]) for i in range(len(cams))]
