"""Rank entry points for ``dist.launch``: each runs one distributed path on
this rank from plain host inputs (numpy arrays, dicts, dataclass configs)
and returns plain host outputs, with the kernel launches this rank made on
the path and the names of any modules of the JAX package it has imported
(none should be).  The CPU tests and ``chip_smoke.py`` drive the sharded
paths through them.

Views are dicts of ``data.dataset.ViewData``'s fields, or the path of an
npz written by ``save_views``; clouds are dicts of ``GaussianCloud``'s
fields, or the path of a cloud npz (``io.checkpoint``).
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
import time

import numpy as np
import torch

from splatpu_torch.dist.mesh import get_mesh, rank_device, world
from splatpu_torch.obs.profiling import launch_counts, zero_counts

def _report(out: dict) -> dict:
    rank, size = world()
    return dict(out, rank=rank, world=size,
                jax_modules=sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "splatpu")))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def save_views(path, views_by_timestep) -> None:
    """``views_by_timestep`` ([T][C] views, numpy fields, one size) as one npz."""
    stack = lambda f: np.stack([np.stack([np.asarray(getattr(v, f) if not isinstance(v, dict)  # noqa: E731
                                                     else v[f]) for v in per_t])
                                for per_t in views_by_timestep])
    v0 = views_by_timestep[0][0]
    get = (lambda k: v0[k]) if isinstance(v0, dict) else (lambda k: getattr(v0, k))  # noqa: E731
    np.savez(path, w2c=stack("w2c"), K=stack("K"), image=stack("image"),
             segmentation=stack("segmentation"), width=get("width"), height=get("height"))


def _views(spec) -> list:
    """[T][C] ``ViewData`` from a list of lists of dicts or a ``save_views`` npz."""
    from splatpu_torch.data.dataset import ViewData

    if isinstance(spec, (str, bytes)) or hasattr(spec, "__fspath__"):
        z = np.load(spec)
        w, h = int(z["width"]), int(z["height"])
        return [[ViewData(camera_index=c, w2c=z["w2c"][t, c], K=z["K"][t, c], width=w, height=h,
                          image=z["image"][t, c], segmentation=z["segmentation"][t, c])
                 for c in range(z["w2c"].shape[1])] for t in range(z["w2c"].shape[0])]
    return [[ViewData(**v) for v in per_t] for per_t in spec]


def _cloud(spec, device):
    from splatpu_torch.core.types import GaussianCloud
    from splatpu_torch.io.checkpoint import load_cloud

    if isinstance(spec, dict):
        return GaussianCloud(**{k: torch.from_numpy(np.array(v)) for k, v in spec.items()}).to(device)
    return load_cloud(spec, device=device)


def _np(x):
    return x.detach().cpu().numpy()


class _Rows:
    """A logger keeping every row's scalars as floats."""

    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    def flush(self):
        pass


def train_on_rank(cloud, views, config, device="cuda", net_state=None, runs: int = 1) -> dict:
    """``stage2.train`` on this rank, ``runs`` times from the same start
    (``net_state``, a network state dict with the config's head settings,
    or the config's seeded network): per run the network's parameters,
    rank 0's logged rows (every rank's are dropped but rank 0's), the run's
    wall seconds and the launches."""
    from splatpu_torch.dynamics.network import DeformationNet, net_config_for
    from splatpu_torch.io.checkpoint import HEAD_KNOBS
    from splatpu_torch.train.stage2 import Stage2Config, train

    dev = rank_device(device)
    cfg = config if isinstance(config, Stage2Config) else Stage2Config(**config)
    c0, vs = _cloud(cloud, dev), _views(views)
    out = []
    for _ in range(runs):
        net = None
        if net_state is not None:
            sd = {k: torch.from_numpy(np.array(v)) for k, v in net_state.items()}
            net = DeformationNet(net_config_for(sd, **{k: getattr(cfg, k) for k in HEAD_KNOBS}))
            net.load_state_dict(sd)
        log = _Rows()
        _sync(dev)
        zero_counts()
        t0 = time.perf_counter()
        net, *_ = train(c0, vs, cfg, logger=log, initial_net=net, device=dev)
        _sync(dev)
        out.append(dict(params={k: _np(v) for k, v in net.state_dict().items()}, rows=log.rows,
                        seconds=time.perf_counter() - t0, counts=launch_counts()))
    return _report(dict(runs=out))


def steps_on_rank(cloud, w2c, K, images, picks, timesteps, config, net_state,
                  device="cuda") -> dict:
    """``dist.train_step.make_sharded_train_step`` on a (mesh_cameras,
    mesh_tiles) grid from ``net_state``: one step per (pick, timestep),
    each pick padded to the camera ranks, the previous state carried from
    step to step; the network's parameters and every step's metrics."""
    from splatpu_torch.dist.sharding import pad_picks
    from splatpu_torch.dist.train_step import make_sharded_train_step
    from splatpu_torch.dynamics.network import DeformationNet, net_config_for
    from splatpu_torch.train.stage2 import Stage2Config, setup, snapshot_previous

    dev = rank_device(device)
    cfg = config if isinstance(config, Stage2Config) else Stage2Config(**config)
    sd = {k: torch.from_numpy(np.array(v)) for k, v in net_state.items()}
    net = DeformationNet(net_config_for(sd))
    net.load_state_dict(sd)
    state = setup(_cloud(cloud, dev), cfg, initial_net=net, device=dev)
    mesh = get_mesh(cfg.mesh_cameras, cfg.mesh_tiles)
    as_t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    w2c, K, images = as_t(w2c), as_t(K), as_t(images)
    step = make_sharded_train_step(cfg, state, mesh, images.shape[-1], images.shape[-2])
    enc, fg = snapshot_previous(state.cloud, state.fg_idx, state.neighbor_info, cfg.quirk_compat)
    rows = []
    zero_counts()
    for pick, t in zip(picks, timesteps):
        pick, weights = pad_picks(torch.as_tensor(np.asarray(pick), device=dev), cfg.mesh_cameras)
        enc, fg, m = step(enc, fg, float(t), w2c[pick], K[pick], images[pick], cfg.binning,
                          weights)
        rows.append({k: float(v) for k, v in m.items()})
    return _report(dict(params={k: _np(v) for k, v in state.net.state_dict().items()}, rows=rows,
                        counts=launch_counts()))


def fit_on_rank(points, views, radius: float, config, device="cuda") -> dict:
    """``stage1.fit`` on this rank: the cloud's fields, rank 0's logged rows,
    the alive mask after each mutation, the wall seconds and the launches."""
    from splatpu_torch.train.stage1 import Stage1Config, fit

    dev = rank_device(device)
    cfg = config if isinstance(config, Stage1Config) else Stage1Config(**config)
    # One timestep's views: a list of dicts, or a ``save_views`` npz's first.
    vs = _views([views] if isinstance(views, list) else views)[0]
    alive = {}

    def watch(i, cloud, metrics):
        if cfg.densify.is_mutation_iter(i):
            alive[i] = _np(cloud.alive)

    log = _Rows()
    _sync(dev)
    zero_counts()
    t0 = time.perf_counter()
    cloud, _ = fit(np.asarray(points), vs, radius, cfg, logger=log, on_iteration=watch,
                   on_iteration_every=1, device=dev)
    _sync(dev)
    seconds = time.perf_counter() - t0
    fields = {k: _np(v) for k, v in dataclasses.asdict(cloud).items()}
    return _report(dict(cloud=fields, rows=log.rows, alive=alive, seconds=seconds,
                        counts=launch_counts()))


def _render_args(args: dict, device, grad: bool = False):
    from splatpu_torch.core.types import RenderArgs

    t = {k: (None if v is None else torch.from_numpy(np.array(v)).to(device).requires_grad_(grad))
         for k, v in args.items()}
    return RenderArgs(**t), t


def strips_on_rank(args: dict, camera: dict, tiles: int, renderer: str, binning,
                   device="cuda") -> dict:
    """``make_tile_sharded_render`` over ``tiles`` ranks: the whole image
    (V, C, H_pad, W) from the strips and the launches; then this rank's
    strip rendered again alone, its image, its ``last`` as the Gaussian id
    of each pixel's last contributor (-1: none) and its first image row."""
    from splatpu_torch.core.types import Camera
    from splatpu_torch.dist.tile_sharding import make_tile_sharded_render, strip_camera, strip_height
    from splatpu_torch.render.api import render
    from splatpu_torch.render.exact import composite_inputs

    dev = rank_device(device)
    mesh = get_mesh(1, tiles)
    cam = Camera(**{k: (torch.from_numpy(np.array(v)).to(dev) if k in ("w2c", "K") else v)
                    for k, v in camera.items()})
    ra, _ = _render_args(args, dev)
    _sync(dev)
    zero_counts()
    with torch.no_grad():
        image = make_tile_sharded_render(mesh, cam, renderer, binning)(ra, cam.w2c, cam.K)
    _sync(dev)
    counts = launch_counts()
    sh = strip_height(cam.height, tiles, binning.tile)
    row0 = mesh.tile_index * sh
    strip = strip_camera(cam, sh, row0)
    with torch.no_grad():
        out = render(ra, strip, impl=renderer, config=binning)
        last = out.last_contributor
        _, k = composite_inputs(ra, strip, binning)
        gid = k["gid"].long()
        last_gid = torch.where(last >= 0, torch.gather(gid, 1, last.clamp(min=0).reshape(
            gid.shape[0], -1)).reshape(last.shape), -1)
    return _report(dict(image=_np(image), strip=_np(out.image), last_gid=_np(last_gid), row0=row0,
                        counts=counts))


def dual_grads_on_rank(args: dict, colors_b, camera: dict, targets, seg_targets, tiles: int,
                       renderer: str, binning, device="cuda") -> dict:
    """Stage 1's loss over ``make_tile_sharded_render_dual`` on ``tiles``
    ranks (one view, whole-image targets): the loss, the images and the
    gradients of every render input (``means2d_offset`` and ``colors_b``
    included)."""
    from splatpu_torch.core.types import Camera
    from splatpu_torch.dist.tile_sharding import make_tile_sharded_render_dual
    from splatpu_torch.train.losses import SEGMENTATION_WEIGHT, image_losses

    dev = rank_device(device)
    mesh = get_mesh(1, tiles)
    cam = Camera(**{k: (torch.from_numpy(np.array(v)).to(dev) if k in ("w2c", "K") else v)
                    for k, v in camera.items()})
    ra, leaves = _render_args(args, dev, grad=True)
    cb = torch.from_numpy(np.array(colors_b)).to(dev).requires_grad_(True)
    zero_counts()
    img, seg, radii, overflow, span = make_tile_sharded_render_dual(
        mesh, cam, renderer, binning)(ra, cb, cam.w2c, cam.K)
    img, seg = img[..., :cam.height, :], seg[..., :cam.height, :]
    t = torch.from_numpy(np.array(targets)).to(dev)
    s = torch.from_numpy(np.array(seg_targets)).to(dev)
    loss = (image_losses(img, t) + SEGMENTATION_WEIGHT * image_losses(seg, s)).mean()
    names = [k for k, v in leaves.items() if v is not None]
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [cb])
    return _report(dict(loss=float(loss), image=_np(img), seg=_np(seg), radii=_np(radii),
                        overflow=_np(overflow), grads={**dict(zip(names, map(_np, grads))),
                                                       "colors_b": _np(grads[-1])},
                        counts=launch_counts()))


def losses_on_rank(args: dict, camera: dict, w2c, K, images, weights, cameras: int, tiles: int,
                   renderer: str, binning, device="cuda", view_batching: str = "map") -> dict:
    """The camera-sharded (``tiles`` 1) or 2D image losses on a cameras x
    tiles grid: the sums, the flags, and the gradients of
    0.8 l1 + 0.2 ssim summed over every rank (the whole loss's)."""
    from splatpu_torch.core.types import Camera
    from splatpu_torch.dist.sharding import (
        make_2d_sharded_image_losses,
        make_camera_sharded_image_losses,
    )

    dev = rank_device(device)
    mesh = get_mesh(cameras, tiles)
    cam = Camera(w2c=torch.empty(0), K=torch.empty(0), **camera)
    make = make_2d_sharded_image_losses if tiles > 1 else make_camera_sharded_image_losses
    fn = make(mesh, cam, renderer, binning, view_batching)
    ra, leaves = _render_args(args, dev, grad=True)
    as_t = lambda a: torch.from_numpy(np.array(a)).to(dev)  # noqa: E731
    zero_counts()
    l1, s, overflow, span, pairs = fn(ra, as_t(w2c), as_t(K), as_t(images), as_t(weights))
    names = [k for k, v in leaves.items() if v is not None]
    grads = torch.autograd.grad(0.8 * l1 + 0.2 * s, [leaves[k] for k in names])
    grads = [mesh.all_reduce(g.clone(), "sum") for g in grads]
    return _report(dict(l1=l1.item(), ssim=s.item(), overflow=float(overflow), span=float(span),
                        grads=dict(zip(names, map(_np, grads))), counts=launch_counts()))


def sequences_on_rank(jobs: list, out_dir, device="cuda") -> dict:
    """``multiseq.train_sequences`` of this process's share of ``jobs``
    (dicts of ``name``, ``cloud``, ``views`` and ``config``, as
    ``train_on_rank`` takes them): each local sequence's network."""
    from splatpu_torch.dist.multiseq import SequenceJob, train_sequences
    from splatpu_torch.train.stage2 import Stage2Config

    dev = rank_device(device)
    seq = [SequenceJob(name=j["name"], initial_cloud=lambda c=j["cloud"]: _cloud(c, dev),
                       views_by_timestep=lambda v=j["views"]: _views(v),
                       config=Stage2Config(**j["config"])) for j in jobs]
    out = train_sequences(seq, out_dir=out_dir, device=dev)
    return _report(dict(nets={name: {k: _np(v) for k, v in r[0].state_dict().items()}
                              for name, r in out.items()}))


def cli_on_rank(module: str, argv: list) -> dict:
    """A command line's ``main(argv)`` on this rank (``module`` names it):
    the launches it made."""
    zero_counts()
    importlib.import_module(module).main(list(argv))
    return _report(dict(counts=launch_counts()))


def grid_on_rank(cameras: int, tiles: int) -> dict:
    """This rank's cell of a cameras x tiles grid, the ranks of its tiles
    and cameras groups, and the error of a grid of the wrong size."""
    import torch.distributed as dist

    m = get_mesh(cameras, tiles)
    try:
        get_mesh(cameras + 1, tiles)
        refused = None
    except ValueError as e:
        refused = str(e)
    return _report(dict(cell=(m.camera_index, m.tile_index), refused=refused,
                        tiles=dist.get_process_group_ranks(m.groups["tiles"]),
                        cameras=dist.get_process_group_ranks(m.groups["cameras"])))


def build_on_rank() -> int:
    """Load (building where this rank must) the kernel library; this
    process's id."""
    import os

    from splatpu_torch import _build

    _build.load_library()
    return os.getpid()


def library_on_rank() -> dict:
    """Load the kernel library as ``build_on_rank`` does; this process's id,
    the path it loaded and whether it came from the persistent cache."""
    import os

    from splatpu_torch import _build

    _build.load_library()
    return dict(pid=os.getpid(), path=str(_build.library_path()), cached=_build.build_cached)
