"""Stage 1: fit a static Gaussian cloud to timestep 0, with densification
(port of ``splatpu/train/stage1.py``).

Each iteration renders the sampled views of timestep 0 through
``render_dual`` (one preprocess and binning per view, an image and a
segmentation composite: on the card one projection launch each way for
both tables, K1/K2 and the routing kernel twice per view; K4 under ``binning_overrides={"kernel": "manual"}``; K5 under
``renderer="cuda_padded"`` with a 16 px tile), takes image_loss + 3 x the
segmentation's image_loss (the mean over the views when
``views_per_step > 1``), and back-propagates into the cloud's parameters
and the ``means2d_offset`` collector.  A non-mutation iteration applies
Adam (eps 1e-15, the reference's per-group learning rates), holds the dead
slots' parameters, and accumulates the densification statistics while
``i <= window_end``.  A mutation iteration accumulates them, then clones,
splits and prunes (and resets the opacities on schedule) with no Adam
update and no count increment, as the reference does.  With V views per
step each view's screen gradients are scaled back by V before they are
accumulated, so one V-view step advances the statistics as V reference
iterations would.

The view order is the JAX package's: ``numpy.random.default_rng(seed)``
permutation buffers, reseeded at ``seed + start`` on resume.  So is the
split noise: the run starts from ``prng.key(seed)``, each mutation takes
``key, sub = prng.split(key)``, and ``split_normals(sub)`` draws the two
(CAP, 3) normals from ``sub`` on the run's device, as the JAX package's
``jax.random`` does (``core/prng.py``).  The checkpoint carries the key, so
a resumed run of either package splits with the key the uninterrupted run
had.

Each iteration is a ``torch.profiler`` range ``stage1_iteration`` with the
ranges ``render``, ``loss``, ``backward`` and ``adam`` (or ``densify``, with
``mutation`` inside it around ``densify_and_prune`` and the opacity reset)
inside (``tools/profile_stage1.py`` reads them); a budget growth is a range
``budget_growth``.  While a profiler records, each mutation's integers
(cloned, split, pruned, dropped for capacity, alive after) are kept for
``obs.profiling.take_counts``, as exact binning's pairs are.

The render is exact at any span budget: exact binning emits every covered
tile of every Gaussian, however wide (``render/exact.py``), so a fit at the
published ``max_span`` 32 renders what an uncapped binning would from its
first iteration.  Overflow flags are read on the host every
``overflow_check_every`` iterations only; the budget that overflowed grows
(the span, which with the big class sizes binning's pool of lanes, before
the pairs).  An iteration that overflows the pair budget or the pool
renders without the pairs past it until that check.  Checkpoints hold the JAX
package's tree
(``io.checkpoint.stage1_checkpoint_tree``), so a checkpoint of either
package resumes in the other.

``mesh_tiles > 0`` renders each view as that many row strips, one per rank
of the process group (``dist/tile_sharding.py``): the strips are gathered
into the whole image on every rank, the loss is taken there, and the
cloud's and the collector's gradients are summed over the ranks, so every
rank reads the same statistics and mutates its cloud identically.  Every
rank runs ``fit`` with the same arguments; only rank 0 logs and writes
checkpoints.  One view per step only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from splatpu_torch.core import prng
from splatpu_torch.core.types import Camera, GaussianCloud, activate_cloud, cloud_from_arrays
from splatpu_torch.growth.densify import (
    DensifyConfig,
    DensifyStats,
    accumulate_stats_batch,
    densify_and_prune,
    init_stats,
    reset_opacity,
)
from splatpu_torch.io.checkpoint import (
    load_checkpoint,
    save_checkpoint,
    stage1_checkpoint_tree,
    stage1_state_from_tree,
)
from splatpu_torch.neighbors.knn import knn
from splatpu_torch.obs import profiling
from splatpu_torch.render.api import render_dual, resolve_binning
from splatpu_torch.render.binning import (
    BinningConfig,
    adopt_checkpointed_budget,
    grow_for_span_overflow,
)
from splatpu_torch.render.types import RenderOutput
from splatpu_torch.train.losses import SEGMENTATION_WEIGHT, image_losses
from splatpu_torch.train.optim import Stage1Adam, apply_stage1_updates, stage1_learning_rates

@dataclasses.dataclass(frozen=True)
class Stage1Config:
    """The JAX package's ``Stage1Config``, at its defaults."""

    iterations: int = 30_000
    capacity_factor: float = 4.0              # cloud capacity / initial points
    densify: DensifyConfig = DensifyConfig()
    renderer: str = "auto"
    binning: Optional[BinningConfig] = None
    binning_overrides: Optional[dict] = None  # field overrides over the sized default
    mesh_tiles: int = 0                       # > 0: each render's rows over this many ranks
    views_per_step: int = 1
    grow_budget_on_overflow: bool = True
    overflow_check_every: int = 100
    max_budget_growths: int = 4
    seed: int = 0
    checkpoint_every: int = 0                 # iterations; 0 = no checkpoints
    checkpoint_path: Optional[str] = None


def initialize_cloud(point_cloud: np.ndarray, capacity: int, device="cuda") -> GaussianCloud:
    """(N, 7) points (xyz, rgb, seg) -> the initial cloud
    (``splatpu/train/stage1.py:95-113``): segmentation (seg, 0, 1 - seg),
    identity quaternions, opacity logits 0, isotropic log scales
    log(sqrt(mean squared distance to the 3 nearest neighbours)), the mean
    clipped at 1e-7; padded with dead rows up to ``capacity``."""
    xyz = torch.from_numpy(np.ascontiguousarray(point_cloud[:, :3], np.float32)).to(device)
    _, d2 = knn(xyz, 3)
    mean_d2 = torch.clamp(d2.mean(-1), min=1e-7)
    log_scales = torch.log(torch.sqrt(mean_d2))[:, None].repeat(1, 3)
    seg = point_cloud[:, 6]
    n = point_cloud.shape[0]
    return cloud_from_arrays(
        means=point_cloud[:, :3],
        colors=point_cloud[:, 3:6],
        segmentation_masks=np.stack([seg, np.zeros_like(seg), 1.0 - seg], -1),
        rotation_quaternions=np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)),
        opacity_logits=np.zeros((n, 1), np.float32),
        log_scales=log_scales,
        capacity=capacity,
        device=device,
    )


def split_normals(sub, capacity: int, device):
    """The split jitter's two (CAP, 3) standard-normal draws from a
    mutation's subkey ``sub``: ``k1, k2 = split(sub)``, then
    ``normal(k1)`` and ``normal(k2)``, as ``densify_and_prune`` in the JAX
    package draws them."""
    k1, k2 = prng.split(sub)
    return prng.normal(k1, (capacity, 3), device), prng.normal(k2, (capacity, 3), device)


@dataclasses.dataclass
class StepResult:
    """One iteration's renders, losses and gradients."""

    image: RenderOutput            # the image composite (V views)
    segmentation: RenderOutput     # the segmentation composite
    image_loss: torch.Tensor       # (V,)
    segmentation_loss: torch.Tensor  # (V,)
    total: torch.Tensor            # () the mean over the views of image + 3 x segmentation
    grads: Optional[dict]          # per-parameter gradients, or None
    offset_grad: torch.Tensor      # (V, CAP, 2) the means2d_offset collector's


class Stage1Steps:
    """The two step functions over one run's staged views.  Both take the
    cloud, the statistics, this step's picks (a (V,) index tensor on the
    device), the binning and ``i``; ``adam`` is updated in place."""

    def __init__(self, config: Stage1Config, scene_radius: float, staged, width: int,
                 height: int, adam: Stage1Adam, mesh=None):
        self.config = config
        self.scene_radius = scene_radius
        self.lrs = stage1_learning_rates(scene_radius)
        self.staged = staged
        self.width, self.height = width, height
        self.adam = adam
        self.dual_strips = None
        if mesh is not None:
            from splatpu_torch.dist.tile_sharding import make_tile_sharded_render_dual
            from splatpu_torch.train.stage2 import camera_template

            self.dual_strips = make_tile_sharded_render_dual(
                mesh, camera_template(width, height), renderer=config.renderer,
                binning=config.binning)

    def forward_backward(self, cloud: GaussianCloud, pick, binning,
                         param_grads: bool = True) -> StepResult:
        """The dual render of the picked views, the losses, and the
        gradients of their mean (to the parameters only if ``param_grads``)."""
        w2c, K, images, segs = (x[pick] for x in self.staged)
        v = w2c.shape[0]
        params = {k: p.detach().requires_grad_(param_grads)
                  for k, p in cloud.param_dict().items()}
        offsets = torch.zeros((v, cloud.capacity, 2), device=w2c.device, requires_grad=True)
        c = GaussianCloud(alive=cloud.alive, **params)
        with record_function("render"):
            args = dataclasses.replace(activate_cloud(c), means2d_offset=offsets)
            if self.dual_strips is not None:
                from splatpu_torch.dist.tile_sharding import whole_outputs

                out, seg_out = whole_outputs(
                    *self.dual_strips(args, c.segmentation_masks, w2c, K, binning=binning),
                    height=self.height)
            else:
                cams = Camera(w2c=w2c, K=K, width=self.width, height=self.height)
                out, seg_out = render_dual(args, c.segmentation_masks, cams,
                                           impl=self.config.renderer, config=binning)
        with record_function("loss"):
            img_l = image_losses(out.image, images)
            seg_l = image_losses(seg_out.image, segs)
            total = (img_l + SEGMENTATION_WEIGHT * seg_l).mean()
        with record_function("backward"):
            leaves = [*params.values(), offsets] if param_grads else [offsets]
            grads = torch.autograd.grad(total, leaves)
        return StepResult(out, seg_out, img_l.detach(), seg_l.detach(), total.detach(),
                          dict(zip(params, grads[:-1])) if param_grads else None, grads[-1])

    def _compute(self, cloud: GaussianCloud, stats: DensifyStats, pick, binning,
                 param_grads: bool):
        """(parameter gradients or None, the statistics with this step's
        views accumulated, loss metrics)."""
        r = self.forward_backward(cloud, pick, binning, param_grads)
        # The mean over the views scales every gradient by 1/V; the
        # densification thresholds are per view, so the collector's is undone.
        v = r.offset_grad.shape[0]
        stats = accumulate_stats_batch(stats, r.offset_grad * v, r.image.radii.detach())
        metrics = {
            "image_loss": r.image_loss.mean(),
            "segmentation_loss": r.segmentation_loss.mean(),
            "total_loss": r.total,
            "binning_overflow": (r.image.overflowed | r.segmentation.overflowed).any().float(),
            "span_overflow": (r.image.span_overflowed
                              | r.segmentation.span_overflowed).any().float(),
        }
        return r.grads, stats, metrics

    def train_step(self, cloud, stats, pick, binning, i: int):
        """A non-mutation iteration: gradients, Adam, the dead slots held,
        the statistics accumulated while ``i <= window_end``."""
        grads, new_stats, metrics = self._compute(cloud, stats, pick, binning, True)
        if i <= self.config.densify.window_end:
            stats = new_stats
        with torch.no_grad(), record_function("adam"):
            updated = apply_stage1_updates(cloud.param_dict(), self.adam.update(grads), self.lrs)
            alive = cloud.alive
            cloud = cloud.replace(**{
                k: torch.where(alive.reshape((-1,) + (1,) * (p.dim() - 1)), p, getattr(cloud, k))
                for k, p in updated.items()
            })
        metrics["n_alive"] = cloud.n_alive()
        return cloud, stats, metrics

    def mutate_step(self, cloud, stats, pick, binning, i: int, sub):
        """A mutation iteration: the statistics accumulated, then clone,
        split (its noise drawn from the subkey ``sub``) and prune (and the
        opacity reset on its schedule); no Adam update."""
        _, stats, metrics = self._compute(cloud, stats, pick, binning, False)
        dcfg = self.config.densify
        with torch.no_grad(), record_function("densify"):
            normals = split_normals(sub, cloud.capacity, cloud.alive.device)
            with record_function("mutation"):
                cloud, _, stats, info = densify_and_prune(
                    cloud, self.adam, stats, normals, i, self.scene_radius, dcfg)
                if dcfg.is_opacity_reset_iter(i):
                    cloud, _ = reset_opacity(cloud, self.adam, dcfg)
            if torch.autograd._profiler_enabled():
                profiling.count_mutation(info)
        metrics.update(info)
        return cloud, stats, metrics


def stage_views(views, device):
    """Every view of timestep 0 on the device: w2c, K, images, segmentations."""
    def stack(field):
        arrs = [getattr(v, field) for v in views]
        if isinstance(arrs[0], torch.Tensor):
            return torch.stack(arrs).to(device, torch.float32)
        return torch.from_numpy(np.ascontiguousarray(np.stack(arrs), np.float32)).to(device)

    return tuple(stack(f) for f in ("w2c", "K", "image", "segmentation"))


def fit(
    point_cloud: np.ndarray,
    views: list,
    scene_radius: float,
    config: Stage1Config = Stage1Config(),
    logger=None,
    progress: bool = False,
    resume_from=None,
    on_iteration=None,
    on_iteration_every: int = 1000,
    device="cuda",
):
    """The stage-1 fit.  ``views``: objects with ``w2c``, ``K``, ``width``,
    ``height``, ``image`` (3, H, W) and ``segmentation`` (3, H, W), numpy
    arrays or tensors (``data.dataset.ViewData``).  Returns (cloud, the last
    iteration's metrics).

    ``logger`` (``log(metrics, step)``, ``flush()``) gets every iteration's
    metrics as device tensors: ``image_loss``, ``segmentation_loss``,
    ``total_loss``, ``binning_overflow``, ``span_overflow``, and
    ``n_alive`` (non-mutation) or ``cloned``, ``split``, ``pruned``,
    ``dropped_for_capacity``, ``n_alive`` (mutation); and a row per budget
    growth.  ``on_iteration(i, cloud, metrics)`` fires every
    ``on_iteration_every`` iterations; a truthy return stops the fit after
    iteration ``i`` (on every rank where any asks to): with a
    ``checkpoint_path`` the checkpoint of that iteration is written first,
    whatever ``checkpoint_every`` says, so the caller has the cloud (which
    ``fit`` returns), the Adam state, the statistics and the key as a
    checkpoint holds them, and a resume continues at ``i + 1``.
    ``resume_from``: a stage-1
    checkpoint of either package; the loop continues after its iteration
    with its cloud, Adam state, statistics, key and budget.
    """
    mesh = None
    if config.mesh_tiles > 0:
        if config.views_per_step > 1:
            raise ValueError("views_per_step > 1 cannot be combined with mesh_tiles (batch the"
                             " views OR shard one view's tiles)")
        from splatpu_torch.dist.mesh import get_mesh

        mesh = get_mesh(camera_axis=1, tile_axis=config.mesh_tiles)
        if mesh.rank != 0:
            logger = None
    device = torch.device(device)
    capacity = int(point_cloud.shape[0] * config.capacity_factor)
    capacity = -(-capacity // 256) * 256
    binning = resolve_binning(capacity, config.binning, config.binning_overrides)
    config = dataclasses.replace(config, binning=binning)
    cloud = initialize_cloud(point_cloud, capacity, device=device)
    adam = Stage1Adam(cloud.param_dict())
    stats = init_stats(capacity, device)
    staged = stage_views(views, device)
    steps = Stage1Steps(config, scene_radius, staged, views[0].width, views[0].height, adam,
                        mesh)

    rng = np.random.default_rng(config.seed)
    key = prng.key(config.seed)
    start_iter = 0
    growths = 0
    if resume_from is not None:
        template = stage1_checkpoint_tree(cloud, adam, stats, key, 0, binning.max_pairs,
                                          binning.max_span, 0)
        try:
            restored = load_checkpoint(resume_from, template)
        except (KeyError, ValueError):
            # A checkpoint from before the budget fields: the config's budget.
            old = {k: template[k] for k in ("cloud", "opt_state", "stats", "key", "i")}
            restored = dict(template, **load_checkpoint(resume_from, old))
        state = stage1_state_from_tree(restored, device)
        cloud = state["cloud"]
        adam.load_state(**state["opt_state"])
        stats = DensifyStats(**state["stats"])
        key = state["key"]
        start_iter = state["i"] + 1
        rng = np.random.default_rng(config.seed + start_iter)
        growths = state["growths"]
        adopted, changed = adopt_checkpointed_budget(binning, state["max_pairs"],
                                                     state["max_span"], capacity)
        if changed:
            binning = adopted
            config = dataclasses.replace(config, binning=binning)

    dcfg = config.densify
    n_views = len(views)
    buffer: list[int] = []
    iterator = range(start_iter, config.iterations)
    if progress:
        try:
            import tqdm

            iterator = tqdm.tqdm(iterator, desc="stage1", initial=start_iter,
                                 total=config.iterations)
        except ImportError:
            pass
    metrics = {}
    for i in iterator:
        # V views from the without-replacement buffer, refilled as it drains.
        sel = []
        while len(sel) < config.views_per_step:
            if not buffer:
                buffer = list(rng.permutation(n_views))
            sel.append(int(buffer.pop()))
        pick = torch.tensor(sel, device=device)
        if (
            config.grow_budget_on_overflow
            and growths < config.max_budget_growths
            and i > start_iter
            and i % config.overflow_check_every == 0
            and float(metrics.get("binning_overflow", 0.0)) > 0.0
        ):
            # Grow the budget that overflowed: doubling the pairs cannot
            # clear a span overflow.  If both did, the next check grows the other.
            with record_function("budget_growth"):
                if float(metrics.get("span_overflow", 0.0)) > 0.0:
                    binning = grow_for_span_overflow(binning, capacity)
                else:
                    binning = dataclasses.replace(binning,
                                                  max_pairs=min(binning.max_pairs * 2, 1 << 24))
            config = dataclasses.replace(config, binning=binning)
            growths += 1
            if logger is not None:
                logger.log({"budget_growth": growths, "max_pairs": binning.max_pairs,
                            "max_span": binning.max_span}, step=i)
        with record_function("stage1_iteration"):
            if dcfg.is_mutation_iter(i):
                key, sub = prng.split(key)
                cloud, stats, metrics = steps.mutate_step(cloud, stats, pick, binning, i, sub)
            else:
                cloud, stats, metrics = steps.train_step(cloud, stats, pick, binning, i)
        if logger is not None:
            logger.log(metrics, step=i)
        stop = False
        if on_iteration is not None and (i + 1) % on_iteration_every == 0:
            stop = bool(on_iteration(i, cloud, metrics))
            if mesh is not None:
                # Every rank stops where any asks to, or the next collective hangs.
                stop = bool(mesh.all_reduce(torch.tensor([float(stop)], device=device), "max"))
        if (config.checkpoint_path and (mesh is None or mesh.rank == 0)
                and (stop or (config.checkpoint_every
                              and (i + 1) % config.checkpoint_every == 0))):
            save_checkpoint(config.checkpoint_path, stage1_checkpoint_tree(
                cloud, adam, stats, key, i, binning.max_pairs, binning.max_span, growths))
        if stop:
            break
    if logger is not None:
        logger.flush()
    return cloud, metrics
