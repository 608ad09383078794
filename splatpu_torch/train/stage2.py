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

View staging: "device" (float32 on the card), "device_u8" (uint8 there),
"host" (the views stay in host memory; each step's sampled views are
copied one step ahead through a pinned double buffer on a copy stream) and
"device_rotate" (``resident_cameras`` cameras' uint8 views of every
timestep on the card, the subset rotated every ``restage_every`` sequence
iterations).  ``view_batching="map"`` renders the sampled views one at a
time and takes the same sums.  Checkpoints (``checkpoint_every``,
``checkpoint_path``) hold the network, the Adam state, the sequence
iteration and the budget in the JAX package's layout, so a checkpoint of
either package resumes in the other.

``mesh_cameras > 0`` trains on a (mesh_cameras, mesh_tiles) grid of the
process group's ranks (``dist/``): the sampled views are padded to a
multiple of ``mesh_cameras`` (weight 0) and sharded over the camera ranks,
with ``mesh_tiles > 1`` each view's rows over the tile ranks too; the
network's gradients are summed over every rank, so every rank holds the
same network.  Every rank runs ``train`` with the same arguments; only
rank 0 logs and writes checkpoints.  Without ``mesh_cameras``,
``mesh_tiles`` is ignored and one process trains, as in the JAX package.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from splatpu_torch.core import prng
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
from splatpu_torch.io.checkpoint import (
    load_checkpoint,
    opt_state_from_tree,
    opt_state_to_tree,
    save_checkpoint,
)
from splatpu_torch.obs.profiling import BackwardPhases
from splatpu_torch.render.binning import (
    BinningConfig,
    adopt_checkpointed_budget,
    grow_for_span_overflow,
)
from splatpu_torch.train.losses import L1_WEIGHT, RIGIDITY_WEIGHT, SSIM_WEIGHT
from splatpu_torch.train.optim import Stage2Adam, make_stage2_optimizer, stage2_lr_at

VIEW_STAGING = ("device", "device_u8", "host", "device_rotate")
VIEW_BATCHING = ("vmap", "map")
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
    compute_dtype: str = "auto"        # the network's; "auto" = float32 off a TPU
    view_staging: str = "device"       # see VIEW_STAGING and the module docstring
    resident_cameras: int = 8          # device_rotate: cameras resident at once
    restage_every: int = 10            # device_rotate: sequence iterations per rotation
    view_batching: str = "vmap"        # "vmap": one batched render; "map": one per view
    mesh_cameras: int = 0              # > 0: the views sharded over this many camera ranks
    mesh_tiles: int = 1                # > 1 (with mesh_cameras): also each view's rows
                                       # over this many tile ranks, in the same step;
                                       # ignored without mesh_cameras
    steps_per_timestep: int = 1        # Adam steps per visited timestep
    timestep_order: str = "sequential"  # or "shuffled" per sequence iteration
    grow_budget_on_overflow: bool = True
    overflow_check_every: int = 50
    max_budget_growths: int = 4
    binning_headroom: float = 2.0
    seed: int = 0
    checkpoint_every: int = 0          # sequence iterations; 0 = no checkpoints
    checkpoint_path: Optional[str] = None
    delta_scale: float = 0.01
    double_residual: bool = True
    zero_init_head: bool = False
    time_gate_head: bool = False

    def net_config(self) -> DeformationNetConfig:
        return DeformationNetConfig(
            hidden_dim=self.hidden_dim,
            residual_blocks=self.residual_blocks,
            compute_dtype="float32" if self.compute_dtype == "auto" else self.compute_dtype,
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
    in place, or a fresh one drawn from ``prng.key(config.seed)`` as the
    JAX package draws it) and its optimizer."""
    cloud = compact_cloud(initial_cloud.to(device))
    fg_idx = torch.nonzero(cloud.segmentation_masks[:, 0] > 0.5, as_tuple=True)[0]
    neighbor_info = build_neighbor_info(cloud.means[fg_idx])
    encoded_initial = normalize_and_encode_means_and_rotations(
        cloud.means, cloud.rotation_quaternions, quirk_compat=config.quirk_compat
    )
    if initial_net is None:
        net = init_deformation_net(prng.key(config.seed), config.net_config(), device=device)
    else:
        # The weights are the caller's; the compute dtype is the run's.
        net = initial_net.to(device)
        net.config = dataclasses.replace(net.config,
                                         compute_dtype=config.net_config().compute_dtype)
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


def camera_template(width: int, height: int) -> Camera:
    """The static fields of the sampled views' cameras; the step fills in
    their ``w2c`` and ``K``."""
    return Camera(w2c=torch.empty(0), K=torch.empty(0), width=width, height=height)


def view_losses(args, camera: Camera, w2c, K, images, weights, renderer: str, binning,
                batching: str):
    """The views' image losses: ``(l1_sum, ssim_sum, overflow, span_overflow,
    pairs)``.  The sums run over the views, each view's terms times its
    weight where ``weights`` is given (0 for a padding view); the flags are
    the max over the views of weight > 0 (as 0/1), ``pairs`` the largest
    view's demanded pairs.  ``batching`` "vmap" renders every view in one
    batched render, "map" one view at a time.  The step's
    ``BackwardPhases``, while a profiler records, learn the rendered images
    and the cloud tensors they came from here."""
    groups = ([slice(None)] if batching == "vmap"
              else [slice(i, i + 1) for i in range(w2c.shape[0])])
    l1_sum = ssim_sum = 0.0
    outs = []
    for g in groups:
        with record_function("render"):
            cams = dataclasses.replace(camera, w2c=w2c[g], K=K[g])
            out = render(args, cams, impl=renderer, config=binning)
        with record_function("loss"):
            l1 = (out.image - images[g]).abs().mean(dim=(1, 2, 3))
            s = 1.0 - ssim(out.image, images[g], size_average=False)
            if weights is not None:
                l1, s = l1 * weights[g], s * weights[g]
            l1_sum = l1_sum + l1.sum()
            ssim_sum = ssim_sum + s.sum()
        outs.append(out)
    phases = BackwardPhases.current
    if phases is not None:
        phases.images([o.image for o in outs],
                      [getattr(args, f.name) for f in dataclasses.fields(args)])
    overflow = torch.cat([o.overflowed for o in outs])
    span = torch.cat([o.span_overflowed for o in outs])
    if weights is not None:
        overflow, span = overflow & (weights > 0), span & (weights > 0)
    return (l1_sum, ssim_sum, overflow.any().float(), span.any().float(),
            torch.cat([o.total_pairs for o in outs]).max())


def make_local_image_losses(config: Stage2Config, width: int, height: int):
    """The single-process image losses: ``image_losses(args, w2c, K, images,
    weights, binning)`` -> ``view_losses`` of every sampled view."""
    camera = camera_template(width, height)

    def image_losses(args, w2c, K, images, weights, binning):
        return view_losses(args, camera, w2c, K, images, weights, config.renderer, binning,
                           config.view_batching)

    return image_losses


def make_step(config: Stage2Config, state: Stage2Setup, width: int, height: int,
              image_losses=None, grad_sync=None):
    """The one stage-2 step, shared by the single-process and the sharded
    trainers: ``step(encoded_previous, previous_fg, timestep, w2c (V, 4, 4),
    K (V, 3, 3), images (V, 3, H, W) float32 or uint8, binning, weights=None)``
    -> (encoded_previous, previous_fg, metrics).  It updates the network's
    parameters and the optimizer in place.

    ``image_losses`` (default ``make_local_image_losses``) is the image-loss
    term, ``(args, w2c, K, images, weights, binning)`` -> ``(l1_sum,
    ssim_sum, overflow, span_overflow, pairs)``; ``weights`` (V,) marks real
    views 1 and padding views 0 (None: every view real).  ``grad_sync``
    (None on one process; ``dist.train_step.GradSync`` under a mesh) sums
    the network's gradients over the ranks before the norm and Adam, and
    says whether this rank adds the rigidity term to the loss it
    differentiates (one rank does: the term is replicated).

    ``metrics`` holds device scalars: l1 and ssim (summed over the views),
    image, rigidity (times the real view count), total, grad_norm,
    binning_overflow and span_overflow (max over the views, as 0/1), and
    pairs (the largest view's demanded pairs).  Its stages are
    ``torch.profiler`` ranges: ``deform`` (network and rigidity),
    ``render`` (inside it ``preprocess`` and ``binning`` per view and
    ``composite``, from ``render/exact.py``), ``loss``, ``backward``,
    ``adam`` and ``snapshot``; while a profiler records, the backward is
    split into ``loss_bwd``, ``render_bwd`` and ``deform_bwd`` on the
    thread that runs it (``obs.profiling.BackwardPhases``).
    ``splatpu_torch.tools.profile_training`` and the benchmark read them.
    """
    net, optimizer = state.net, state.optimizer
    params = dict(net.named_parameters())
    if image_losses is None:
        image_losses = make_local_image_losses(config, width, height)

    def step(encoded_previous, previous_fg, timestep, w2c, K, images, binning, weights=None):
        phases = BackwardPhases.begin()
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
            args = activate_cloud(updated)
            l1_sum, ssim_sum, overflow, span_overflow, pairs = image_losses(
                args, w2c, K, images, weights, binning)
            with record_function("loss"):
                image_loss = L1_WEIGHT * l1_sum + SSIM_WEIGHT * ssim_sum
                # The reference sums one identical rigidity value per view;
                # the multiplier is the real view count.
                rigidity = (float(w2c.shape[0]) if weights is None else weights.sum()) * rig
                total = image_loss + RIGIDITY_WEIGHT * rigidity
            loss = total if grad_sync is None or grad_sync.owns_rigidity else image_loss
            if phases is not None:
                phases.loss(loss)
                phases.params(params.values())
            with record_function("backward"):
                loss.backward()
                if phases is not None:
                    phases.end()
            with record_function("adam"):
                grads = {k: p.grad for k, p in params.items()}
                if grad_sync is not None:
                    grads = grad_sync(grads, params)
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
            "binning_overflow": overflow,
            "span_overflow": span_overflow,
            "pairs": pairs,
        }
        return enc_prev, prev_fg, metrics

    return step


def _to_u8(imgs: np.ndarray) -> np.ndarray:
    """Views as uint8: uint8 views as they are (never re-scaled), float
    views in [0, 1] rounded to the nearest level."""
    if imgs.dtype == np.uint8:
        return imgs
    return np.clip(np.rint(imgs * 255.0), 0, 255).astype(np.uint8)


def _stage(views, staging: str, device):
    """One timestep's views -> (w2c, K, images): the cameras on the device;
    the images there too for "device" (float32: uint8 views divided by 255
    once) and "device_u8" (uint8), or on the host for "host" (as they are:
    the step divides uint8 by 255) and "device_rotate" (uint8)."""
    # C order: "host" and "device_rotate" gather whole views from it.
    imgs = np.ascontiguousarray(np.stack([v.image for v in views]))
    if staging == "device" and imgs.dtype == np.uint8:
        imgs = imgs.astype(np.float32) / 255.0
    elif staging in ("device_u8", "device_rotate"):
        imgs = _to_u8(imgs)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (
        as_t(np.stack([v.w2c for v in views]).astype(np.float32)),
        as_t(np.stack([v.K for v in views]).astype(np.float32)),
        imgs if staging in ("host", "device_rotate") else as_t(imgs),
    )


class HostPrefetch:
    """"host" staging: each step's sampled views copied to the device one
    step ahead.  On a card the views are gathered into one of two pinned
    host buffers (the whole view set is never pinned) and copied with
    ``non_blocking`` on a copy stream; the step's stream waits on the copy's
    event.  A buffer is refilled only after its previous copy finished."""

    def __init__(self, device):
        self.device = device
        self.on_card = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.on_card else None
        self.buffers = [None, None]
        self.done = [None, None]
        self.slot = 0

    def put(self, host_images: np.ndarray, pick: np.ndarray):
        """Start the copy of ``host_images[pick]``; returns a handle for
        ``take``."""
        if not self.on_card:
            return torch.from_numpy(np.ascontiguousarray(host_images[pick])), None
        slot, self.slot = self.slot, self.slot ^ 1
        shape = (len(pick),) + host_images.shape[1:]
        dtype = torch.from_numpy(host_images[:0]).dtype
        buf = self.buffers[slot]
        if buf is None or tuple(buf.shape) != shape or buf.dtype != dtype:
            buf = self.buffers[slot] = torch.empty(shape, dtype=dtype, pin_memory=True)
        elif self.done[slot] is not None:
            self.done[slot].synchronize()
        # mode="clip": the picks are in range, and under the default "raise"
        # numpy gathers into a temporary buffer and copies that into ``out``.
        np.take(host_images, pick, axis=0, out=buf.numpy(), mode="clip")
        with torch.cuda.stream(self.stream):
            images = buf.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        self.done[slot] = event
        return images, event

    def take(self, handle) -> torch.Tensor:
        """The images of ``put``, ready for the current stream."""
        images, event = handle
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            images.record_stream(stream)
        return images


class Rotation:
    """"device_rotate" staging: the uint8 views of ``resident_cameras``
    cameras at every timestep on the device, one copy per rotation.  The
    camera order is ``default_rng(seed + 7).permutation(n_cams)``; rotation
    ``i`` holds positions ``pos * k .. (pos + 1) * k`` of it (wrapping), pos
    = i mod (n_cams // k), cameras sorted."""

    def __init__(self, staged, config: Stage2Config, device):
        self.staged = staged
        self.device = device
        self.n_cams = min(s[0].shape[0] for s in staged)
        self.k = min(config.resident_cameras, self.n_cams)
        self.order = np.random.default_rng(config.seed + 7).permutation(self.n_cams)
        self.pos = -1
        self.w2c = self.K = self.images = None

    def restage(self, rot_i: int) -> None:
        pos = rot_i % max(1, self.n_cams // self.k)
        if pos == self.pos:
            return
        idx = np.sort(np.take(self.order, np.arange(pos * self.k, (pos + 1) * self.k),
                              mode="wrap"))
        self.images = None  # free the old subset before the new one lands
        self.images = torch.from_numpy(np.stack([s[2][idx] for s in self.staged])).to(self.device)
        sel = torch.from_numpy(idx).to(self.device)
        self.w2c = torch.stack([s[0][sel] for s in self.staged])
        self.K = torch.stack([s[1][sel] for s in self.staged])
        self.pos = pos


class VisitLog:
    """A logger's rows of the visits, in step order, each with its
    ``step_ms``: on a card from CUDA events around the visit's steps, read
    when the next visit has been enqueued (by then the visit has nearly
    always completed: ``Event.query``, no wait) and at ``flush``, which waits
    once for the last visit; elsewhere from the host clock.  Rows logged
    with ``note`` keep their place behind the visits before them."""

    def __init__(self, logger, on_card: bool):
        self.logger = logger
        self.on_card = on_card
        # (step, metrics, the visit's (start, end) events or None, is a visit)
        self.pending = collections.deque()
        self.last_end = None
        self.last = None  # the last visit's row as logged

    def start(self):
        """A mark before the visit's steps are enqueued."""
        if not self.on_card:
            return time.perf_counter()
        mark = torch.cuda.Event(enable_timing=True)
        mark.record()
        return mark

    def visit(self, step: int, metrics: dict, start) -> None:
        """The visit's row, once its steps are enqueued; ``start`` from ``start``."""
        if self.on_card:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            self.last_end = end
            self.pending.append((step, metrics, (start, end), True))
        else:
            ms = 1e3 * (time.perf_counter() - start)
            self.pending.append((step, dict(metrics, step_ms=ms), None, True))
        self.log_ready()

    def note(self, step: int, metrics: dict) -> None:
        self.pending.append((step, metrics, None, False))

    def log_ready(self) -> None:
        """Log the rows in order up to the first visit still running."""
        while self.pending:
            step, metrics, marks, is_visit = self.pending[0]
            if marks is not None:
                if not marks[1].query():
                    return
                metrics = dict(metrics, step_ms=marks[0].elapsed_time(marks[1]))
            self.pending.popleft()
            self.logger.log(metrics, step=step)
            if is_visit:
                self.last = metrics

    def flush(self) -> None:
        """Log every row, after one wait for the last visit's end."""
        if self.last_end is not None:
            self.last_end.synchronize()
            self.last_end = None
        self.log_ready()


def checkpoint_payload(state: Stage2Setup, config: Stage2Config, seq_it: int,
                       growths: int) -> dict:
    """A stage-2 checkpoint in the JAX package's layout: ``net_params``,
    ``opt_state``, ``seq_it``, ``max_pairs``, ``max_span`` and ``growths``
    (int32, 0-d), in that order."""
    from splatpu_torch.dynamics.network import net_params_to_jax_tree

    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    opt = state.optimizer
    return {
        "net_params": net_params_to_jax_tree(state.net),
        "opt_state": opt_state_to_tree(opt.count, opt.mu, opt.nu),
        "seq_it": i32(seq_it),
        "max_pairs": i32(config.binning.max_pairs),
        "max_span": i32(config.binning.max_span),
        "growths": i32(growths),
    }


def restore_checkpoint(path, state: Stage2Setup, config: Stage2Config):
    """Load a stage-2 checkpoint into ``state`` (network and Adam state):
    ``(the sequence iteration it ended, the budget growths, its max_pairs,
    its max_span)``.  A checkpoint of the format before budget growth (no
    budget fields) restores with the config's budget and 0 growths."""
    from splatpu_torch.dynamics.network import state_dict_from_jax

    template = checkpoint_payload(state, config, 0, 0)
    try:
        restored = load_checkpoint(path, template)
    except (KeyError, ValueError):
        old = {k: template[k] for k in ("net_params", "opt_state", "seq_it")}
        restored = dict(template, **load_checkpoint(path, old))
    state.net.load_state_dict(state_dict_from_jax(restored["net_params"]))
    state.optimizer.load_state(**opt_state_from_tree(restored["opt_state"]))
    return (int(restored["seq_it"]), int(restored["growths"]), int(restored["max_pairs"]),
            int(restored["max_span"]))


def train(
    initial_cloud: GaussianCloud,
    views_by_timestep,  # list[T] of list[ViewData] (timesteps 1..T)
    config: Stage2Config,
    logger=None,
    initial_net: Optional[DeformationNet] = None,
    device="cuda",
    progress: bool = False,
    resume_from=None,
    on_iteration=None,
):
    """The stage-2 training loop on one device.

    Returns ``(net, cloud, encoded_initial, metrics)`` like the JAX
    package's ``(net_params, cloud, encoded_initial, metrics)``; ``metrics``
    are the last step's.  ``initial_net`` (default: the JAX package's
    fresh network from ``key(config.seed)``) is trained in place and returned.  ``logger`` (an
    object with ``log(metrics, step)`` and ``flush()``) gets every step's
    metrics plus ``learning_rate`` (the schedule at the update count the
    step used), ``max_pairs`` (the budget) and ``step_ms`` (CUDA events on a
    card, the host clock elsewhere; it covers the visit's steps, not the
    staging of its views before them, so compare view stagings by the wall
    time between ``on_iteration`` calls), in step order, every row of a
    sequence iteration before its checkpoint and ``on_iteration``
    (``VisitLog``: the card is waited on once per sequence iteration, not
    once per visit).  Each visit's steps are a ``train_step`` profiler
    range, which ends when they are enqueued.  View picks and the visit
    order are drawn from ``np.random.default_rng(config.seed)`` exactly as
    the JAX loop draws them.

    ``resume_from``: a stage-2 checkpoint (either package's) to continue
    from: the network and Adam state are loaded, the loop starts at the
    sequence iteration after the checkpoint's, the generator restarts at
    ``default_rng(seed + start)``, and a budget the run had grown is
    adopted.  ``on_iteration(seq_it, net, config, metrics)`` is called
    after every sequence iteration (and its checkpoint); a truthy return
    stops the loop.  ``progress`` shows a tqdm bar where tqdm is installed.
    """
    device = torch.device(device)
    if config.view_staging not in VIEW_STAGING:
        raise ValueError(f"unknown view_staging {config.view_staging!r}: one of {VIEW_STAGING}")
    if config.view_batching not in VIEW_BATCHING:
        raise ValueError(f"unknown view_batching {config.view_batching!r}")
    if config.timestep_order not in TIMESTEP_ORDERS:
        raise ValueError(f"unknown timestep_order {config.timestep_order!r}")
    mesh = None
    if config.mesh_cameras > 0:
        from splatpu_torch.dist.mesh import get_mesh

        mesh = get_mesh(config.mesh_cameras, config.mesh_tiles)
        if mesh.rank != 0:
            logger = None
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
    if mesh is None:
        step_fn = make_step(config, state, width, height)
    else:
        from splatpu_torch.dist.sharding import pad_picks
        from splatpu_torch.dist.train_step import make_sharded_train_step

        step_fn = make_sharded_train_step(config, state, mesh, width, height)
    staged = [_stage(views, config.view_staging, device) for views in views_by_timestep]
    host = config.view_staging == "host"
    prefetch = HostPrefetch(device) if host else None
    rotation = Rotation(staged, config, device) if config.view_staging == "device_rotate" else None

    rng = np.random.default_rng(config.seed)
    t_count = config.timestep_count
    k_rep = config.steps_per_timestep
    on_card = device.type == "cuda"
    start_it, growths = 0, 0
    if resume_from is not None:
        seq_it, growths, ckpt_pairs, ckpt_span = restore_checkpoint(resume_from, state, config)
        start_it = seq_it + 1
        rng = np.random.default_rng(config.seed + start_it)
        adopted, changed = adopt_checkpointed_budget(config.binning, ckpt_pairs, ckpt_span,
                                                     state.cloud.capacity)
        if changed:
            config = dataclasses.replace(config, binning=adopted)
    outer = range(start_it, config.total_iterations)
    if progress:
        try:
            import tqdm

            # total= explicitly, so a resumed run does not show as done.
            outer = tqdm.tqdm(outer, desc="stage2", initial=start_it,
                              total=config.total_iterations)
        except ImportError:
            pass
    metrics = {}
    visits = VisitLog(logger, on_card) if logger is not None else None
    for seq_it in outer:
        enc_prev, prev_fg = snapshot_previous(
            state.cloud, state.fg_idx, state.neighbor_info, config.quirk_compat
        )
        if rotation is not None:
            rotation.restage(seq_it // max(1, config.restage_every))
            v = min(config.views_per_step, rotation.k)
            picks = [rng.choice(rotation.k, size=v, replace=False).astype(np.int64)
                     for _t in range(t_count)]
        else:
            v = min(config.views_per_step, min(s[0].shape[0] for s in staged))
            picks = [
                rng.choice(staged[t][0].shape[0], size=v, replace=False).astype(np.int64)
                for t in range(t_count)
            ]
        if config.timestep_order == "shuffled":
            order = [int(x) + 1 for x in rng.permutation(t_count)]
        else:
            order = list(range(1, t_count + 1))
        weights = None
        if mesh is not None:
            # The view sample rarely divides the camera ranks: the picks
            # are padded with index 0 (every staging gathers the same
            # views), and the padding weighs 0.
            padded = [pad_picks(torch.from_numpy(p), config.mesh_cameras) for p in picks]
            picks = [p.numpy() for p, _ in padded]
            weights = padded[0][1].to(device)
        if host:
            ahead = prefetch.put(staged[order[0] - 1][2], picks[order[0] - 1])
        for visit_i, timestep in enumerate(order):
            step_idx = seq_it * t_count + visit_i + 1
            if rotation is not None:
                all_w2c, all_K, all_images = (rotation.w2c[timestep - 1],
                                              rotation.K[timestep - 1],
                                              rotation.images[timestep - 1])
            else:
                all_w2c, all_K, all_images = staged[timestep - 1]
            pick = torch.from_numpy(picks[timestep - 1]).to(device)
            w2c, K = all_w2c[pick], all_K[pick]
            if host:
                images = prefetch.take(ahead)
                if visit_i + 1 < t_count:
                    nxt = order[visit_i + 1]
                    ahead = prefetch.put(staged[nxt - 1][2], picks[nxt - 1])
            else:
                images = all_images[pick]
            with record_function("train_step"):
                if visits is not None:
                    start = visits.start()
                # k steps on this timestep's views; the "previous" snapshot
                # advances only after the last of them.
                for _rep in range(k_rep):
                    enc_out, fg_out, metrics = step_fn(
                        enc_prev, prev_fg, float(timestep), w2c, K, images, config.binning,
                        weights)
                enc_prev, prev_fg = enc_out, fg_out
                if visits is not None:
                    visits.visit(step_idx, dict(
                        metrics,
                        learning_rate=stage2_lr_at(
                            config.learning_rate, config.warmup_iterations * t_count * k_rep,
                            config.total_iterations * t_count * k_rep, step_idx * k_rep - 1,
                        ),
                        max_pairs=config.binning.max_pairs,
                    ), start)
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
                    if visits is not None:
                        visits.note(step_idx, {"budget_growth": growths,
                                               "max_pairs": grown.max_pairs,
                                               "max_span": grown.max_span})
                else:
                    warnings.warn(
                        "stage 2: binning pair budget still overflowing at "
                        f"max_pairs={config.binning.max_pairs} after {growths} growths"
                        " — renders are dropping splats", stacklevel=2,
                    )
        if visits is not None:
            visits.flush()
            metrics = visits.last
        if (config.checkpoint_every and config.checkpoint_path
                and (seq_it + 1) % config.checkpoint_every == 0
                and (mesh is None or mesh.rank == 0)):
            save_checkpoint(config.checkpoint_path,
                            checkpoint_payload(state, config, seq_it, growths))
        if on_iteration is not None:
            stop = bool(on_iteration(seq_it, state.net, config, metrics))
            if mesh is not None:
                # Every rank stops where any asks to, or the next collective hangs.
                stop = bool(mesh.all_reduce(torch.tensor([float(stop)], device=device), "max"))
            if stop:
                break
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
