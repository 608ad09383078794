"""Stage 2: train the deformation network over the autoregressive timestep
rollout, on one device (port of ``splatpu/train/stage2.py:53-406, 409-776``).

Each step deforms the frozen cloud with the network, renders the V sampled
views of the timestep in ONE batched render (forward composite K1, backward
composite K2 and the routing kernel on the card; K4 under
``binning_overrides={"kernel": "manual"}``; K5 under
``renderer="cuda_padded"``, which needs a 16 px ``binning``, since the
budget sized here without one is at 32 px), takes 0.8 L1 + 0.2 SSIM
summed over the views plus 3 * V * rigidity, back-propagates into the
network only, applies Adam under the warmup-cosine schedule, and snapshots
the deformed cloud (detached) as the next step's "previous" state.  The
timestep loop stays a Python loop: step t consumes step t-1's output.

The whole step runs under ``no_tf32``: autograd runs the network's backward
matmuls after its forward has returned, so the forward's own scope would not
cover them.  The caller's TF32 settings are restored after each step.

Not ported yet: ``view_staging`` "host" and "device_rotate", checkpoint
writes and resume, the ``mesh_*`` distributed step, ``view_batching="map"``
and the bfloat16 ``compute_dtype`` (the port computes in float32).
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from splatpu_torch.core.ssim import ssim
from splatpu_torch.core.types import Camera, GaussianCloud, activate_cloud
from splatpu_torch.dynamics.deform import (
    normalize_and_encode_means_and_rotations,
    update_cloud_parameters,
)
from splatpu_torch.dynamics.network import (
    DeformationNet,
    DeformationNetConfig,
    init_deformation_net,
    no_tf32,
)
from splatpu_torch.dynamics.rigidity import (
    ForegroundInfo,
    NeighborInfo,
    build_neighbor_info,
    foreground_info,
    rigidity_loss,
)
from splatpu_torch.render.api import demand_binning, measure_binning_demand, render
from splatpu_torch.render.binning import BinningConfig, grow_for_span_overflow
from splatpu_torch.train.losses import L1_WEIGHT, RIGIDITY_WEIGHT, SSIM_WEIGHT
from splatpu_torch.train.optim import Stage2Adam, make_stage2_optimizer, stage2_lr_at

VIEW_STAGING = ("device", "device_u8")
TIMESTEP_ORDERS = ("sequential", "shuffled")


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    """The JAX ``Stage2Config`` fields the single-device trainer and serving
    read, at the JAX package's defaults."""

    total_iterations: int = 20
    warmup_iterations: int = 2
    learning_rate: float = 1e-3
    hidden_dim: int = 128
    residual_blocks: int = 3
    views_per_step: int = 5
    timestep_count: int = 10
    renderer: str = "auto"
    binning: Optional[BinningConfig] = None
    binning_overrides: Optional[dict] = None  # field overrides over the
                                              # demand-sized budget
    quirk_compat: bool = True
    view_staging: str = "device"       # "device" (float32) or "device_u8"
    steps_per_timestep: int = 1        # Adam steps per visited timestep
    timestep_order: str = "sequential"  # or "shuffled" per sequence iteration
    grow_budget_on_overflow: bool = True
    overflow_check_every: int = 50
    max_budget_growths: int = 4
    binning_headroom: float = 2.0
    seed: int = 0
    delta_scale: float = 0.01
    double_residual: bool = True
    zero_init_head: bool = False
    time_gate_head: bool = False

    def net_config(self) -> DeformationNetConfig:
        return DeformationNetConfig(
            hidden_dim=self.hidden_dim,
            residual_blocks=self.residual_blocks,
            delta_scale=self.delta_scale,
            double_residual=self.double_residual,
            zero_init_head=self.zero_init_head,
            time_gate_head=self.time_gate_head,
        )


def compact_cloud(cloud: GaussianCloud) -> GaussianCloud:
    """Exactly the alive rows, all alive.  Not rounded up: BatchNorm takes
    its statistics over every row the network sees, so padding rows would
    change every output."""
    idx = torch.nonzero(cloud.alive, as_tuple=True)[0]
    params = {k: v[idx] for k, v in cloud.param_dict().items()}
    return GaussianCloud(
        alive=torch.ones((idx.numel(),), dtype=torch.bool, device=cloud.alive.device), **params
    )


@dataclasses.dataclass
class Stage2Setup:
    """The static state of a run and its trainable parts."""

    cloud: GaussianCloud          # compacted, frozen
    fg_idx: torch.Tensor          # (F,) int64 foreground rows
    neighbor_info: NeighborInfo
    encoded_initial: torch.Tensor  # (N, 92)
    net: DeformationNet
    optimizer: Stage2Adam


def setup(initial_cloud: GaussianCloud, config: Stage2Config, initial_net=None,
          device="cuda") -> Stage2Setup:
    """Compaction, foreground indices, the neighbour graph, the initial
    encoding, the network (``initial_net``, moved to ``device`` and trained
    in place, or a fresh one seeded by ``config.seed``) and its optimizer."""
    cloud = compact_cloud(initial_cloud.to(device))
    fg_idx = torch.nonzero(cloud.segmentation_masks[:, 0] > 0.5, as_tuple=True)[0]
    neighbor_info = build_neighbor_info(cloud.means[fg_idx])
    encoded_initial = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat
    )
    if initial_net is None:
        gen = torch.Generator().manual_seed(config.seed)
        net = init_deformation_net(config.net_config(), gen, device=device)
    else:
        net = initial_net.to(device)
    # steps_per_timestep scales the schedule, so that a k-step run still
    # completes its warmup-cosine arc over the same sequence iterations.
    k = config.steps_per_timestep
    optimizer = make_stage2_optimizer(
        dict(net.named_parameters()), config.learning_rate,
        config.warmup_iterations * config.timestep_count * k,
        config.total_iterations * config.timestep_count * k,
    )
    return Stage2Setup(cloud, fg_idx, neighbor_info, encoded_initial, net, optimizer)


def snapshot_previous(cloud: GaussianCloud, fg_idx, neighbor_info: NeighborInfo,
                      quirk_compat: bool = True) -> tuple[torch.Tensor, ForegroundInfo]:
    """Encode the current state and snapshot the foreground, detached."""
    with torch.no_grad():
        enc = normalize_and_encode_means_and_rotations(
            cloud.means, cloud.rotation_quaternions, quirk_compat=quirk_compat
        )
    fg = foreground_info(
        cloud.means[fg_idx], cloud.rotation_quaternions[fg_idx], neighbor_info.indices
    )
    return enc, fg


def make_step(config: Stage2Config, state: Stage2Setup, width: int, height: int):
    """The one stage-2 step: ``step(encoded_previous, previous_fg, timestep,
    w2c (V, 4, 4), K (V, 3, 3), images (V, 3, H, W) float32 or uint8,
    binning)`` -> (encoded_previous, previous_fg, metrics).  It updates the
    network's parameters and the optimizer in place.  ``metrics`` holds
    device scalars: l1 and ssim (summed over the views), image, rigidity
    (times V), total, grad_norm, binning_overflow and span_overflow (max
    over the views, as 0/1), and pairs (the largest view's demanded pairs).
    Its stages are ``torch.profiler`` ranges: ``deform`` (network and
    rigidity), ``render``, ``loss``, ``backward``, ``adam`` and ``snapshot``;
    ``splatpu_torch.tools.profile_training`` reads them.
    """
    net, optimizer = state.net, state.optimizer
    params = dict(net.named_parameters())

    def step(encoded_previous, previous_fg, timestep, w2c, K, images, binning):
        with no_tf32():
            if images.dtype == torch.uint8:
                images = images.float() / 255.0
            net.zero_grad(set_to_none=True)
            with record_function("deform"):
                updated = update_cloud_parameters(
                    net, state.cloud, state.encoded_initial, encoded_previous, timestep,
                    config.timestep_count, config.quirk_compat,
                )
                rig = rigidity_loss(
                    updated.means[state.fg_idx], updated.rotation_quaternions[state.fg_idx],
                    state.neighbor_info, previous_fg,
                )
            with record_function("render"):
                cams = Camera(w2c=w2c, K=K, width=width, height=height)
                out = render(activate_cloud(updated), cams, impl=config.renderer, config=binning)
            with record_function("loss"):
                l1_sum = (out.image - images).abs().mean(dim=(1, 2, 3)).sum()
                ssim_sum = (1.0 - ssim(out.image, images, size_average=False)).sum()
                image_loss = L1_WEIGHT * l1_sum + SSIM_WEIGHT * ssim_sum
                # The reference sums one identical rigidity value per view.
                rigidity = float(w2c.shape[0]) * rig
                total = image_loss + RIGIDITY_WEIGHT * rigidity
            with record_function("backward"):
                total.backward()
            with record_function("adam"):
                grads = {k: p.grad for k, p in params.items()}
                grad_norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
                optimizer.step(params, grads)
        with record_function("snapshot"):
            enc_prev, prev_fg = snapshot_previous(
                updated, state.fg_idx, state.neighbor_info, config.quirk_compat
            )
        metrics = {
            "l1": l1_sum.detach(),
            "ssim": ssim_sum.detach(),
            "image": image_loss.detach(),
            "rigidity": rigidity.detach(),
            "total": total.detach(),
            "grad_norm": grad_norm,
            "binning_overflow": out.overflowed.any().float(),
            "span_overflow": out.span_overflowed.any().float(),
            "pairs": out.total_pairs.max(),
        }
        return enc_prev, prev_fg, metrics

    return step


def _stage(views, staging: str, device):
    """One timestep's views -> (w2c, K, images) on the device.  uint8 views
    are never re-scaled: "device" divides them by 255 once, "device_u8"
    keeps them as they are and quantises float views."""
    imgs = np.stack([v.image for v in views])
    if staging == "device":
        if imgs.dtype == np.uint8:
            imgs = imgs.astype(np.float32) / 255.0
    elif imgs.dtype != np.uint8:
        imgs = np.clip(np.rint(imgs * 255.0), 0, 255).astype(np.uint8)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (
        as_t(np.stack([v.w2c for v in views]).astype(np.float32)),
        as_t(np.stack([v.K for v in views]).astype(np.float32)),
        as_t(imgs),
    )


def train(
    initial_cloud: GaussianCloud,
    views_by_timestep,  # list[T] of list[ViewData] (timesteps 1..T)
    config: Stage2Config,
    logger=None,
    initial_net: Optional[DeformationNet] = None,
    device="cuda",
):
    """The stage-2 training loop on one device.

    Returns ``(net, cloud, encoded_initial, metrics)`` like the JAX
    package's ``(net_params, cloud, encoded_initial, metrics)``; ``metrics``
    are the last step's.  ``initial_net`` (default: a fresh network seeded
    by ``config.seed``) is trained in place and returned.  ``logger`` (an object with ``log(metrics, step)``
    and ``flush()``) gets every step's metrics plus ``learning_rate`` (the
    schedule at the update count the step used), ``max_pairs`` (the budget)
    and ``step_ms`` (CUDA events on a card, the host clock elsewhere; taking
    it synchronises).  Each visit's steps are a ``train_step`` profiler
    range, which ends after that synchronisation when a logger is given.  View picks and the visit order are drawn from
    ``np.random.default_rng(config.seed)`` exactly as the JAX loop draws
    them.
    """
    device = torch.device(device)
    if config.view_staging not in VIEW_STAGING:
        raise NotImplementedError(
            f"view_staging={config.view_staging!r}: the port stages {VIEW_STAGING}"
        )
    if config.timestep_order not in TIMESTEP_ORDERS:
        raise ValueError(f"unknown timestep_order {config.timestep_order!r}")
    initial_cloud = compact_cloud(initial_cloud.to(device))
    v0 = views_by_timestep[0][0]
    width, height = v0.width, v0.height
    if config.binning is None:
        # Size the pair budget from measured demand over the timestep-0
        # cameras; overflow growth backstops the drift.
        t0 = views_by_timestep[0]
        cams = Camera(
            w2c=torch.from_numpy(np.stack([v.w2c for v in t0]).astype(np.float32)).to(device),
            K=torch.from_numpy(np.stack([v.K for v in t0]).astype(np.float32)).to(device),
            width=width, height=height,
        )
        d_pairs, d_span = measure_binning_demand(activate_cloud(initial_cloud), cams)
        config = dataclasses.replace(config, binning=demand_binning(
            d_pairs, d_span, headroom=config.binning_headroom,
            overrides=config.binning_overrides,
        ))
    state = setup(initial_cloud, config, initial_net=initial_net, device=device)
    step_fn = make_step(config, state, width, height)
    staged = [_stage(views, config.view_staging, device) for views in views_by_timestep]

    rng = np.random.default_rng(config.seed)
    t_count = config.timestep_count
    k_rep = config.steps_per_timestep
    on_card = device.type == "cuda"
    growths = 0
    metrics = {}
    for seq_it in range(config.total_iterations):
        enc_prev, prev_fg = snapshot_previous(
            state.cloud, state.fg_idx, state.neighbor_info, config.quirk_compat
        )
        v = min(config.views_per_step, min(s[0].shape[0] for s in staged))
        picks = [
            rng.choice(staged[t][0].shape[0], size=v, replace=False).astype(np.int64)
            for t in range(t_count)
        ]
        if config.timestep_order == "shuffled":
            order = [int(x) + 1 for x in rng.permutation(t_count)]
        else:
            order = list(range(1, t_count + 1))
        for visit_i, timestep in enumerate(order):
            step_idx = seq_it * t_count + visit_i + 1
            all_w2c, all_K, all_images = staged[timestep - 1]
            pick = torch.from_numpy(picks[timestep - 1]).to(device)
            w2c, K, images = all_w2c[pick], all_K[pick], all_images[pick]
            with record_function("train_step"):
                if on_card:
                    marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                    marks[0].record()
                else:
                    t_host = time.perf_counter()
                # k steps on this timestep's views; the "previous" snapshot
                # advances only after the last of them.
                for _rep in range(k_rep):
                    enc_out, fg_out, metrics = step_fn(
                        enc_prev, prev_fg, float(timestep), w2c, K, images, config.binning
                    )
                enc_prev, prev_fg = enc_out, fg_out
                if logger is not None:
                    if on_card:
                        marks[1].record()
                        marks[1].synchronize()
                        step_ms = marks[0].elapsed_time(marks[1])
                    else:
                        step_ms = 1e3 * (time.perf_counter() - t_host)
            if logger is not None:
                metrics = dict(
                    metrics,
                    learning_rate=stage2_lr_at(
                        config.learning_rate, config.warmup_iterations * t_count * k_rep,
                        config.total_iterations * t_count * k_rep, step_idx * k_rep - 1,
                    ),
                    max_pairs=config.binning.max_pairs,
                    step_ms=step_ms,
                )
                logger.log(metrics, step=step_idx)
            if (
                config.grow_budget_on_overflow
                and config.overflow_check_every
                and step_idx % config.overflow_check_every == 0
                and float(metrics["binning_overflow"]) > 0.0
            ):
                if growths < config.max_budget_growths:
                    # Grow the budget that overflowed: doubling the pair
                    # budget cannot clear a span overflow.
                    if float(metrics["span_overflow"]) > 0.0:
                        grown = grow_for_span_overflow(config.binning, state.cloud.capacity)
                    else:
                        grown = dataclasses.replace(
                            config.binning, max_pairs=min(config.binning.max_pairs * 2, 1 << 24)
                        )
                    config = dataclasses.replace(config, binning=grown)
                    growths += 1
                    if logger is not None:
                        logger.log({"budget_growth": growths, "max_pairs": grown.max_pairs,
                                    "max_span": grown.max_span}, step=step_idx)
                else:
                    warnings.warn(
                        "stage 2: binning pair budget still overflowing at "
                        f"max_pairs={config.binning.max_pairs} after {growths} growths"
                        " — renders are dropping splats", stacklevel=2,
                    )
    if logger is not None:
        logger.flush()
    return state.net, state.cloud, state.encoded_initial, metrics


@torch.no_grad()
def rollout_step(
    net: DeformationNet,
    initial_cloud: GaussianCloud,
    encoded_initial,
    encoded_previous,
    timestep,
    config: Stage2Config,
):
    """One no-grad deformation step: (deformed cloud, its encoding)."""
    updated = update_cloud_parameters(
        net, initial_cloud, encoded_initial, encoded_previous, timestep,
        config.timestep_count, config.quirk_compat,
    )
    enc_prev = normalize_and_encode_means_and_rotations(
        updated.means, updated.rotation_quaternions, quirk_compat=config.quirk_compat
    )
    return updated, enc_prev
