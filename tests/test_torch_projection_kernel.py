"""The projection of every view in one autograd node (``render/project.py``)
on the CPU, through its plain version:

- the plain forward is ``preprocess`` + the exact path's table pack of each
  view, bit for bit (table, radius, visibility), and the exact path's
  binning integers from slices of its outputs are those of ``bin_views``;
- the plain analytic backward (the backward kernel's formulas) matches
  autograd through ``preprocess`` + ``pack_table`` + the opacity mask, in
  float64 and float32: per-view and shared ``means2d_offset``, a strip with
  a FOV size other than the image's, the frustum clamp active and exactly
  at its bounds, det <= 0, tz at 0 and at the 0.2 near cull, culled and
  zero-opacity splats, and gradients asked of a subset of the inputs;
- the CUDA wrappers take CUDA tensors or raise: nothing falls back;
- the views the kernel projects are counted while a profiler records, and
  the benchmark's ``projection_kernel_share`` reads them.

The kernel itself runs on a card only: tests/test_torch_kernel_gpu.py.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import splatpu_torch.core.types as tt
from splatpu_torch.obs import profiling
from splatpu_torch.render import exact, project
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.tools.measure import row_scaled_err
from _np_scenes import np_cloud, np_lookat

ROOT = Path(__file__).resolve().parents[1]

W, H = 96, 64
BINNING = BinningConfig(tile=16, max_span=256, max_pairs=1 << 16)
CASES = ["plain", "offset_shared", "offset_per_view", "strip", "edges"]
# Largest column-scaled gap of the analytic backward to autograd: float32
# sums in another order (the 3D covariance's gradient summed over the views
# before it goes back through R(q) and s); float64 for the formulas.
BWD_TOL = {torch.float64: 1e-10, torch.float32: 2e-5}


def axis_camera(width, height, focal=80.0):
    """w2c = I: a mean's view coordinates are its own, exactly."""
    K = np.array([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]])
    return np.eye(4, dtype=np.float32), K.astype(np.float32)


def edge_rows(limx: float, limy: float, rng, dtype) -> dict:
    """Gaussians on the branches of the projection (seen by the axis camera,
    view 0): the frustum clamp at its bounds and past them, tz exactly 0
    and exactly the 0.2 near cull, behind the camera, zero opacity, and
    needles whose 2D covariance rounds to det <= 0."""
    near = torch.tensor(0.2, dtype=dtype).item()
    means = [[limx, 0.1, 1.0], [-limx, 0.1, 1.0], [0.2, limy, 1.0], [0.2, -limy, 1.0],
             [2.0 * limx, 0.1, 1.0], [0.1, -3.0 * limy, 1.0], [0.1, 0.1, 0.0], [0.1, 0.1, near],
             [0.1, 0.2, -2.0], [0.05, -0.05, 2.0]]
    n_edge = len(means)
    big = 1e3 if dtype == torch.float32 else 1e8
    n_needle = 40
    means += np.stack([rng.uniform(-0.5, 0.5, n_needle), rng.uniform(-0.5, 0.5, n_needle),
                       rng.uniform(1.0, 4.0, n_needle)], 1).tolist()
    n = n_edge + n_needle
    scales = rng.uniform(0.02, 0.1, (n, 3))
    scales[n_edge:] = [big, 1e-3, 1e-3]
    opac = rng.uniform(0.2, 1.0, (n, 1))
    opac[n_edge - 1] = 0.0
    q = rng.normal(size=(n, 4))
    q[0] = 0.0  # a zero quaternion: the norm's floor
    return dict(means3d=np.array(means), scales=scales, rotations=q, opacities=opac,
                colors=rng.uniform(0, 1, (n, 3)))


def case(name: str, dtype=torch.float32, seed: int = 3):
    """(RenderArgs of ``dtype`` leaves, batched camera in float32)."""
    rng = np.random.default_rng(seed)
    c = np_cloud(seed, 400, extent=2.5, n_dead=20)
    w, h = W, H
    eyes = [(3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)) for a in (0.0, 1.1, 2.6)]
    cams = [np_lookat(e, W, H) for e in eyes]
    fov = row_offset = None
    if name == "strip":
        h, fov, row_offset = 32, (W, 96), 32
        cams = [np_lookat(e, W, 96) for e in eyes[:2]]
    if name == "edges":
        cams = [axis_camera(W, H)] + cams[1:]
    cam = tt.Camera(w2c=torch.from_numpy(np.stack([x[0] for x in cams])),
                    K=torch.from_numpy(np.stack([x[1] for x in cams])), width=w, height=h,
                    fov_width=fov and fov[0], fov_height=fov and fov[1],
                    row_offset=row_offset or 0)
    cloud = tt.GaussianCloud(**{k: torch.from_numpy(np.array(v)) for k, v in c.items()})
    a = tt.activate_cloud(cloud)
    fields = {f: getattr(a, f).double().numpy() for f in
              ("means3d", "scales", "rotations", "opacities", "colors")}
    if name == "edges":
        tan = cam.view(0).tan_fovx, cam.view(0).tan_fovy
        lim = [float((1.3 * t).to(dtype)) for t in tan]
        extra = edge_rows(*lim, rng, dtype)
        fields = {k: np.concatenate([extra[k], v]) for k, v in fields.items()}
    n = len(fields["means3d"])
    if name == "offset_shared":
        fields["means2d_offset"] = rng.normal(size=(n, 2)) * 1e-3
    if name == "offset_per_view":
        fields["means2d_offset"] = rng.normal(size=(cam.num_views, n, 2)) * 1e-3
    args = tt.RenderArgs(**{k: torch.tensor(v, dtype=dtype) for k, v in fields.items()})
    return args, cam


@pytest.mark.parametrize("name", CASES)
def test_plain_forward_is_preprocess_and_table_pack_bitwise(name):
    args, cam = case(name)
    table, radius, visible = project.project_views_plain(args, cam)
    streams, k = exact.composite_inputs(args, cam, BINNING)
    assert torch.equal(table, k["table"])
    assert torch.equal(radius, torch.stack([s.splats.radius for s in streams]))
    assert torch.equal(visible, torch.stack([s.splats.visible for s in streams]))
    assert bool(visible.any()) and not bool(visible.all())
    # The exact path's binning from slices of the outputs: the same integers.
    for s, r in zip(exact.bin_projected(args, cam, BINNING, table, radius, visible), streams):
        for f in ("gid", "start", "end", "lane", "offsets", "counts", "total_pairs"):
            assert torch.equal(getattr(s, f), getattr(r, f)), f
        assert torch.equal(s.g_opacity, r.g_opacity)


def test_edge_case_branches_are_taken():
    """The edge rows reach every branch the backward must follow."""
    args, cam = case("edges")
    _, radius, visible = project.project_views_plain(args, cam)
    from splatpu_torch.core.projection import projection_terms

    t = projection_terms(args.for_view(0), cam.view(0))
    u = t["p_view"][:, 0] / t["tz_safe"]
    w = t["p_view"][:, 1] / t["tz_safe"]
    assert bool((u == t["limx"]).any()) and bool((u == -t["limx"]).any())
    assert bool((w == t["limy"]).any()) and bool((w == -t["limy"]).any())
    assert bool((u.abs() > t["limx"]).any()) and bool((w.abs() > t["limy"]).any())
    assert bool((t["tz"] == 0).any()) and bool((t["tz"] == 0.2).any())
    assert not bool(visible[0, 6:8].any())  # tz 0 and tz 0.2: culled
    assert bool((~t["det_valid"]).any()) and bool(t["det_valid"].any())
    assert not bool(visible[0, 9])  # zero opacity
    assert float(radius[0, 9]) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", CASES)
def test_plain_backward_matches_autograd(name, dtype):
    args, cam = case(name, dtype)
    names = [f for f in project.GRAD_NAMES if getattr(args, f) is not None]
    leaves = {f: getattr(args, f).clone().requires_grad_(True) for f in names}
    largs = dataclasses.replace(args, **leaves)
    table, _, visible = project.project_views_plain(largs, cam)
    d_table = torch.tensor(np.random.default_rng(11).normal(size=table.shape), dtype=dtype)
    ref = torch.autograd.grad((table * d_table).sum(), list(leaves.values()))
    needs = [f in leaves for f in project.GRAD_NAMES]
    got = project.project_views_bwd_plain(d_table, args, cam, visible, needs)
    got = dict(zip(project.GRAD_NAMES, got))
    for f, r in zip(leaves, ref):
        assert got[f].dtype == dtype and got[f].shape == r.shape, f
        assert torch.isfinite(got[f]).all(), f
        assert float(r.abs().max()) > 0, f
        assert row_scaled_err(got[f], r) <= BWD_TOL[dtype], f


@pytest.mark.parametrize("wanted", [("means3d",), ("scales", "rotations"), ("opacities", "colors"),
                                    ("means2d_offset",)])
def test_node_computes_only_the_gradients_asked_for(wanted):
    """Through ``ProjectViews`` (plain): the gradients asked for equal the
    full backward's, the others are not computed."""
    args, cam = case("offset_per_view")
    full = project.project_views_bwd_plain(
        torch.ones(cam.num_views, args.n, 10), args, cam,
        project.project_views_plain(args, cam)[2], [True] * 6)
    leaves = {f: getattr(args, f).clone().requires_grad_(f in wanted) for f in project.GRAD_NAMES}
    seen = []
    real = project.KERNELS["plain"]

    def bwd(*a):
        seen.append(list(a[-1]))
        return real[1](*a)

    project.KERNELS["plain"] = (real[0], bwd)
    try:
        table, radius, visible = project.project_views(tt.RenderArgs(**leaves), cam, impl="plain")
        assert not radius.requires_grad and not visible.requires_grad
        table.sum().backward()
    finally:
        project.KERNELS["plain"] = real
    assert seen == [[f in wanted for f in project.GRAD_NAMES]]
    for f, g in zip(project.GRAD_NAMES, full):
        if f in wanted:
            assert torch.equal(leaves[f].grad, g), f
        else:
            assert leaves[f].grad is None, f


def test_cuda_path_raises_on_cpu_tensors():
    """No fallback: the kernels' wrappers and ``render(impl="cuda")`` refuse
    CPU tensors."""
    from splatpu_torch.render.api import render

    args, cam = case("plain")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        project.project_views_cuda(args, cam)
    table, _, visible = project.project_views_plain(args, cam)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        project.project_views_bwd_cuda(table, args, cam, visible, [True] * 6)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        render(args, cam, impl="cuda", config=BINNING)
    cam_grad = dataclasses.replace(cam, w2c=cam.w2c.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="no gradient of the camera"):
        project.project_views(args, cam_grad, impl="plain")


def test_render_cuda_projects_once_and_bins_its_slices(monkeypatch):
    """``render_exact(impl="cuda")`` projects every view through one
    ``ProjectViews`` call (the kernels swapped here for counting plain
    versions), bins slices of its outputs and composites its table: the
    plain render's image bitwise, its gradients within the float32
    tolerance of the analytic backward."""
    from splatpu_torch.render.api import render

    calls = []

    def fwd(args, camera):
        calls.append(camera.num_views)
        return project.project_views_plain(args, camera)

    monkeypatch.setitem(project.KERNELS, "cuda", (fwd, project.project_views_bwd_plain))
    monkeypatch.setitem(exact.KERNELS, ("cuda", "grid"), exact.KERNELS[("plain", "grid")])
    args, cam = case("plain")
    outs = {}
    for impl in ("cuda", "plain"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True)
                  for f in ("means3d", "scales", "rotations", "opacities", "colors")}
        out = render(tt.RenderArgs(**leaves), cam, impl=impl, config=BINNING)
        (out.image.square().sum() + out.depth.mean()).backward()
        outs[impl] = out, {f: x.grad for f, x in leaves.items()}
    assert calls == [cam.num_views]
    (a, ga), (b, gb) = outs["cuda"], outs["plain"]
    assert torch.equal(a.image, b.image) and torch.equal(a.radii, b.radii)
    for f in ga:
        assert row_scaled_err(ga[f], gb[f]) <= BWD_TOL[torch.float32], f


def test_take_counts_reports_the_views_projected():
    profiling.take_counts()
    profiling.count_projection(5)
    assert profiling.take_counts() == {}  # no view binned: nothing to report
    args, cam = case("plain")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        exact.bin_views(args, cam, BINNING)
        profiling.count_projection(2)
    got = profiling.take_counts()
    assert got["views"] == cam.num_views and got["views_projected"] == 2
    assert profiling.take_counts() == {}


@pytest.mark.parametrize("counts,share", [
    ({"views": 10, "views_projected": 10, "pairs_kept": 1, "lane_slots": 2}, 100.0),
    ({"views": 10, "views_projected": 0, "pairs_kept": 1, "lane_slots": 2}, 0.0),
    ({"views": 10, "pairs_kept": 1, "lane_slots": 2}, None),
    ({}, None),
])
def test_projection_kernel_share_reads_the_counts(counts, share, monkeypatch):
    """The benchmark's reader: views projected by the kernel over the views
    binned, from the counts ``lane_fill`` cached; None where the program
    keeps no such count (the parent of this change) or nothing was binned."""
    sys.path.insert(0, str(ROOT))
    from splatbench import harness

    mod = harness.load_module(ROOT / "splatbench" / "metrics" / "projection_kernel_share.py",
                              "splatbench_metric_projection_kernel_share")
    monkeypatch.setattr(mod, "traced", lambda reading, part: True)
    assert mod.read({"binning_counts": counts}, "train") == share
    monkeypatch.setattr(profiling, "take_counts", lambda: dict(counts))
    reading = {}
    assert mod.read(reading, "train") == share
    assert reading["binning_counts"] == counts
