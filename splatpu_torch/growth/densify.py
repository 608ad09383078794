"""Fixed-capacity densification: clone, split, prune and opacity reset, with
the Adam moments edited to match (port of ``splatpu/growth/densify.py``).

The cloud keeps its capacity and ``alive`` mask.  Clones and split children
take dead slots in index order (a stable argsort of ``alive``): clones
first, ranked by their cumulative count, then the split children; requests
past the free slots are dropped and counted.  A split writes its first
child over the original slot and its second into a free slot.  Every slot
where a new Gaussian lands gets zero moments.  Pruning clears ``alive`` on
the post-split parameters: opacity below 0.005 (0.25 on the last window
iteration), and from iteration 3000 a world-space scale above 0.1 x the
scene radius.  The statistics are reset to zero after each mutation.

The split noise is an argument: ``densify_and_prune`` takes the two
(CAP, 3) standard-normal draws that the JAX package draws from its key;
``train/stage1.py``'s ``split_normals`` draws the same numbers from the
same key through ``core/prng.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from splatpu_torch.core.quaternion import build_rotation
from splatpu_torch.core.types import GaussianCloud


@dataclasses.dataclass(frozen=True)
class DensifyConfig:
    """The reference's densification constants (``splatpu/growth/densify.py:43-69``)."""

    window_end: int = 5000          # stats accumulate and mutations run while i <= this
    mutate_start: int = 500         # first mutation iteration
    mutate_every: int = 100
    grad_threshold: float = 2e-4
    clone_scale_factor: float = 0.01     # * scene_radius
    split_children: int = 2
    split_scale_shrink: float = 0.8      # children's scales /= shrink * children
    prune_opacity: float = 0.005
    prune_opacity_final: float = 0.25
    prune_big_start: int = 3000
    prune_big_scale: float = 0.1         # * scene_radius
    opacity_reset_every: int = 3000
    opacity_reset_value: float = 0.01

    def is_mutation_iter(self, i: int) -> bool:
        return self.mutate_start <= i <= self.window_end and i % self.mutate_every == 0

    def is_opacity_reset_iter(self, i: int) -> bool:
        return i > 0 and i % self.opacity_reset_every == 0


@dataclasses.dataclass
class DensifyStats:
    """Per-slot screen-space statistics."""

    grad_accum: torch.Tensor  # (CAP,) accumulated |d(means2d_ndc)|
    vis_count: torch.Tensor   # (CAP,) views that saw the slot
    max_radii: torch.Tensor   # (CAP,) largest screen radius seen


def init_stats(capacity: int, device="cuda") -> DensifyStats:
    z = lambda: torch.zeros((capacity,), dtype=torch.float32, device=device)  # noqa: E731
    return DensifyStats(grad_accum=z(), vis_count=z(), max_radii=z())


def _gnorm(grads: torch.Tensor) -> torch.Tensor:
    """|g[..., :2]|, as ``jnp.linalg.norm`` sums: sqrt(x0 x0 + x1 x1)."""
    xy = grads[..., :2]
    return torch.sqrt((xy * xy).sum(-1))


def accumulate_stats(stats: DensifyStats, means2d_grad: torch.Tensor,
                     radii: torch.Tensor) -> DensifyStats:
    """One view: where radii > 0, add the screen-gradient norm, count the
    view and raise the max radius."""
    visible = radii > 0
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, _gnorm(means2d_grad), 0.0),
        vis_count=stats.vis_count + visible.float(),
        max_radii=torch.where(visible, torch.maximum(stats.max_radii, radii), stats.max_radii),
    )


def accumulate_stats_batch(stats: DensifyStats, means2d_grads: torch.Tensor,
                           radii: torch.Tensor) -> DensifyStats:
    """V views at once, (V, CAP, 2) gradients and (V, CAP) radii: the same
    as V ``accumulate_stats`` calls (independent sums and a max)."""
    visible = radii > 0
    rmax = torch.where(visible, radii, 0.0).amax(0)
    return DensifyStats(
        grad_accum=stats.grad_accum + torch.where(visible, _gnorm(means2d_grads), 0.0).sum(0),
        vis_count=stats.vis_count + visible.float().sum(0),
        # max with 0 changes nothing where no view saw the slot (max_radii >= 0).
        max_radii=torch.maximum(stats.max_radii, rmax),
    )


def _zero_moments_at(adam, mask: torch.Tensor) -> None:
    """Zero the mu and nu rows of every parameter where ``mask`` holds."""
    for moments in (adam.mu, adam.nu):
        for k, m in moments.items():
            moments[k] = torch.where(mask.reshape((-1,) + (1,) * (m.dim() - 1)), 0.0, m)


def _scatter_rows(params: dict, rank: torch.Tensor, dest_of_rank: torch.Tensor,
                  src: dict | None = None) -> torch.Tensor:
    """For each row g with ``rank[g] >= 0``, write ``src``'s row g (default
    ``params``') over row ``dest_of_rank[rank[g]]`` of every parameter, in
    place.  Returns the destination mask."""
    src = params if src is None else src
    sel = torch.nonzero(rank >= 0, as_tuple=True)[0]
    dests = dest_of_rank[rank[sel]]
    for k in params:
        params[k][dests] = src[k][sel]
    mask = torch.zeros_like(rank, dtype=torch.bool)
    mask[dests] = True
    return mask


def densify_and_prune(cloud: GaussianCloud, adam, stats: DensifyStats, normals, i: int,
                      scene_radius: float, config: DensifyConfig = DensifyConfig()):
    """One mutation (``splatpu/growth/densify.py:149-272``), on schedule
    iterations only (``DensifyConfig.is_mutation_iter``).  ``adam`` is the
    ``Stage1Adam`` whose moments are edited in place; ``normals`` the two
    (CAP, 3) standard-normal draws of the split jitter.  Returns (cloud,
    adam, fresh statistics, info), info holding the counts ``cloned``,
    ``split``, ``pruned``, ``dropped_for_capacity`` and ``n_alive`` as
    int tensors."""
    cap = cloud.capacity
    alive = cloud.alive
    dev = alive.device

    avg_grad = stats.grad_accum / stats.vis_count
    avg_grad = torch.where(torch.isnan(avg_grad), 0.0, avg_grad)
    max_scale = torch.exp(cloud.log_scales).amax(1)
    scale_threshold = config.clone_scale_factor * scene_radius
    grad_hot = avg_grad >= config.grad_threshold
    to_clone = alive & grad_hot & (max_scale <= scale_threshold)
    to_split = alive & grad_hot & (max_scale > scale_threshold)

    # Free slots in index order; clones take the first, split children the next.
    dead_order = torch.argsort(alive.to(torch.int32), stable=True)
    num_dead = cap - alive.sum()
    clone_rank = torch.where(to_clone, torch.cumsum(to_clone, 0) - 1, -1)
    num_clone = to_clone.sum()
    split_rank = torch.where(to_split, torch.cumsum(to_split, 0) - 1, -1)
    num_split = to_split.sum()
    # Requests past the free slots are dropped.
    clone_rank = torch.where(clone_rank < num_dead, clone_rank, -1)
    child_rank = torch.where(split_rank + num_clone < num_dead, split_rank, -1)
    dropped = (num_clone + num_split) - ((clone_rank >= 0).sum() + (child_rank >= 0).sum())

    params = {k: v.clone() for k, v in cloud.param_dict().items()}
    clone_dest = _scatter_rows(params, clone_rank, dead_order)

    n1, n2 = normals
    std = torch.exp(cloud.log_scales)
    rot = build_rotation(cloud.rotation_quaternions, eps=1e-12)
    # R @ (n * std) per row, as sums of products (no matmul, so no TF32).
    jitter1 = (rot * (n1 * std)[:, None, :]).sum(-1)
    jitter2 = (rot * (n2 * std)[:, None, :]).sum(-1)
    shrink = torch.log(torch.tensor(config.split_scale_shrink * config.split_children,
                                    dtype=torch.float32, device=dev))
    child_log_scales = cloud.log_scales - shrink
    # Child 1 overwrites the original slot.
    split_rows = to_split[:, None]
    params["means"] = torch.where(split_rows, cloud.means + jitter1, params["means"])
    params["log_scales"] = torch.where(split_rows, child_log_scales, params["log_scales"])
    # Child 2 takes a free slot after the clones, from the cloud before the clones.
    child2_src = dict(cloud.param_dict(), means=cloud.means + jitter2,
                      log_scales=child_log_scales)
    child2_rank = torch.where(child_rank >= 0, child_rank + num_clone, -1)
    child2_dest = _scatter_rows(params, child2_rank, dead_order, src=child2_src)

    alive = alive | clone_dest | child2_dest
    _zero_moments_at(adam, clone_dest | child2_dest | to_split)

    opacity = torch.sigmoid(params["opacity_logits"][:, 0])
    threshold = config.prune_opacity_final if i == config.window_end else config.prune_opacity
    to_remove = opacity < threshold
    if i >= config.prune_big_start:
        to_remove = to_remove | (torch.exp(params["log_scales"]).amax(1)
                                 > config.prune_big_scale * scene_radius)
    pruned = (cloud.alive & to_remove).sum()
    alive = alive & ~to_remove

    info = {
        "cloned": clone_dest.sum(),
        "split": num_split,
        "pruned": pruned,
        "dropped_for_capacity": dropped,
        "n_alive": alive.sum(),
    }
    return cloud.replace(alive=alive, **params), adam, init_stats(cap, dev), info


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def reset_opacity(cloud: GaussianCloud, adam, config: DensifyConfig = DensifyConfig()):
    """Every slot's opacity logit := inverse_sigmoid(0.01), and the opacity
    moments zeroed entirely (``splatpu/growth/densify.py:283-295``).
    Returns (cloud, adam), the moments edited in place."""
    value = inverse_sigmoid(torch.tensor(np.float32(config.opacity_reset_value),
                                         device=cloud.alive.device))
    adam.mu["opacity_logits"] = torch.zeros_like(adam.mu["opacity_logits"])
    adam.nu["opacity_logits"] = torch.zeros_like(adam.nu["opacity_logits"])
    return cloud.replace(opacity_logits=value.expand_as(cloud.opacity_logits).clone()), adam
