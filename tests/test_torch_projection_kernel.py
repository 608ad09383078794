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
- with a second colour set (``render_dual``'s two tables) the plain forward
  packs both tables of one preprocess, and the plain backward matches
  autograd through ``preprocess``, both table packs and the offset's
  lineage cut: ``means2d_offset`` takes the first table's cotangent alone,
  ``colors_b`` the second's colour columns; the whole dual route in plain
  form (one projection, ``bin_projected``, two composites of the given
  tables) is ``render_dual(impl="plain")``'s images, radii, flags and
  gradients;
- the CUDA wrappers take CUDA tensors or raise: nothing falls back;
- the views the kernel projects are counted while a profiler records, and
  the benchmark's ``projection_kernel_share`` and ``fit_projection_share``
  read them.

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
from splatpu_torch.core.projection import offset_pixel_scale, preprocess
from splatpu_torch.obs import profiling
from splatpu_torch.render import exact, project
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.composite import pack_table
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


def seg_colors(n: int, dtype=torch.float32, seed: int = 17) -> torch.Tensor:
    """A second colour set (N, 3), as stage 1's segmentation colours."""
    return torch.tensor(np.random.default_rng(seed).uniform(0, 1, (n, 3)), dtype=dtype)


def dual_tables(args: tt.RenderArgs, cam: tt.Camera, colors_b):
    """``render_dual``'s two tables as its plain path builds them: one
    ``preprocess`` per view, the first table packed with ``args.colors``,
    the second with ``colors_b`` and the pixel positions of the offset's
    lineage cut, ``mean2d + (off.detach() - off) * wh``."""
    wh = offset_pixel_scale(cam)
    off = args.means2d_offset
    op = args.opacities[:, 0]
    tables, tables_b = [], []
    for i in range(cam.num_views):
        sp = preprocess(args.for_view(i), cam.view(i))
        g_opacity = torch.where(sp.visible, op, torch.zeros_like(op))
        mean2d_b = sp.mean2d
        if off is not None:
            o = off if off.dim() == 2 else off[i]
            mean2d_b = sp.mean2d + (o.detach() - o) * wh
        tables.append(pack_table(sp.mean2d, sp.conic, g_opacity, sp.depth, args.colors))
        tables_b.append(pack_table(mean2d_b, sp.conic, g_opacity, sp.depth, colors_b))
    return torch.stack(tables), torch.stack(tables_b)


@pytest.mark.parametrize("name", CASES)
def test_plain_dual_forward_packs_both_tables_of_one_preprocess(name):
    """With ``colors_b`` the plain forward's first three outputs are the
    single table's bit for bit, and the second table is the dual render's
    (the lineage cut moves no value)."""
    args, cam = case(name)
    colors_b = seg_colors(args.n)
    table, radius, visible, table_b = project.project_views_plain(args, cam, colors_b)
    single = project.project_views_plain(args, cam)
    assert all(torch.equal(a, b) for a, b in zip((table, radius, visible), single))
    ref, ref_b = dual_tables(args, cam, colors_b)
    assert torch.equal(table, ref) and torch.equal(table_b, ref_b)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", CASES)
def test_plain_dual_backward_matches_autograd(name, dtype):
    """The plain backward of both tables against autograd through
    ``preprocess``, both table packs and the lineage cut: every leaf within
    the tolerance of the single table's backward; ``means2d_offset``'s
    gradient the first table's alone (bitwise the single backward's of
    d(table)), ``colors_b``'s the second table's colour columns summed over
    the views."""
    args, cam = case(name, dtype)
    colors_b = seg_colors(args.n, dtype)
    names = [f for f in project.GRAD_NAMES if getattr(args, f) is not None]
    leaves = {f: getattr(args, f).clone().requires_grad_(True) for f in names}
    leaves_b = colors_b.clone().requires_grad_(True)
    table, table_b = dual_tables(tt.RenderArgs(**leaves), cam, leaves_b)
    rng = np.random.default_rng(11)
    d_table = torch.tensor(rng.normal(size=table.shape), dtype=dtype)
    d_table_b = torch.tensor(rng.normal(size=table_b.shape), dtype=dtype)
    ref = torch.autograd.grad((table * d_table).sum() + (table_b * d_table_b).sum(),
                              [*leaves.values(), leaves_b])
    visible = project.project_views_plain(args, cam)[2]
    needs = [f in leaves for f in project.GRAD_NAMES] + [True]
    got = project.project_views_bwd_plain(d_table, args, cam, visible, needs, d_table_b)
    got = dict(zip((*project.GRAD_NAMES, "colors_b"), got))
    for f, r in zip([*leaves, "colors_b"], ref):
        assert got[f].dtype == dtype and got[f].shape == r.shape, f
        assert torch.isfinite(got[f]).all(), f
        assert float(r.abs().max()) > 0, f
        assert row_scaled_err(got[f], r) <= BWD_TOL[dtype], f
    assert torch.equal(got["colors_b"], d_table_b[..., 7:].sum(0))
    single = dict(zip(project.GRAD_NAMES, project.project_views_bwd_plain(
        d_table, args, cam, visible, needs[:6])))
    if args.means2d_offset is not None:
        assert torch.equal(got["means2d_offset"], single["means2d_offset"])
    assert not torch.equal(got["means3d"], single["means3d"])


@pytest.mark.parametrize("name", ["plain", "offset_per_view", "strip"])
def test_plain_dual_backward_moves_no_isotropic_rotation(name):
    """Stage 1 starts from isotropic Gaussians with identity quaternions,
    whose rotation changes no render: autograd's rotation gradient is
    exactly zero there, and so is the dual backward's (its d(cov3d) summed
    symmetrically), so Adam takes no step on round-off."""
    args, cam = case(name)
    iso = dataclasses.replace(
        args, rotations=torch.tensor([[1.0, 0.0, 0.0, 0.0]]).expand(args.n, 4).contiguous(),
        scales=args.scales[:, :1].expand(args.n, 3).contiguous())
    leaves = {f: getattr(iso, f).clone().requires_grad_(True) for f in ("scales", "rotations")}
    table, table_b = dual_tables(dataclasses.replace(iso, **leaves), cam, seg_colors(args.n))
    rng = np.random.default_rng(13)
    d_table, d_table_b = (torch.tensor(rng.normal(size=x.shape), dtype=torch.float32)
                          for x in (table, table_b))
    ref = torch.autograd.grad((table * d_table).sum() + (table_b * d_table_b).sum(),
                              leaves["rotations"])[0]
    visible = project.project_views_plain(iso, cam)[2]
    needs = [False, True, True, False, False, False, False]
    got = project.project_views_bwd_plain(d_table, iso, cam, visible, needs, d_table_b)
    assert not bool(ref.any()) and not bool(got[2].any())
    assert float(got[1].abs().max()) > 0


# The whole dual route; the edge rows' needles (det <= 0 in float32) make
# the two float32 composites' gradient sums disagree at any ordering, the
# single render's too, so their branches are held at the table above.
ROUTE_CASES = [c for c in CASES if c != "edges"]


@pytest.mark.parametrize("name", ROUTE_CASES)
def test_dual_route_in_plain_form_is_render_dual(name):
    """One ``project_views(impl="plain")`` with ``colors_b``, ``bin_projected``
    and two ``composite_streams`` of the given tables (what
    ``render_dual(impl="cuda")`` runs, with the kernels' plain versions)
    against ``render_dual(impl="plain")``: both images, radii and overflow
    flags identical; every leaf's gradient, ``means2d_offset``'s and
    ``colors_b``'s included, within the float32 tolerance of the analytic
    backward."""
    from splatpu_torch.render.api import render_dual

    args, cam = case(name)
    colors_b = seg_colors(args.n)
    names = [f for f in project.GRAD_NAMES if getattr(args, f) is not None]
    bg = exact.background(None, 3, "cpu")
    runs = {}
    for route in ("projected", "render_dual"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True) for f in names}
        leaves_b = colors_b.clone().requires_grad_(True)
        largs = tt.RenderArgs(**leaves)
        if route == "projected":
            table, radius, visible, table_b = project.project_views(largs, cam, impl="plain",
                                                                    colors_b=leaves_b)
            streams = exact.bin_projected(largs, cam, BINNING, table, radius, visible)
            outs = (exact.composite_streams(streams, cam, BINNING, bg, largs.colors, "plain",
                                            table=table),
                    exact.composite_streams(streams, cam, BINNING, bg, leaves_b, "plain",
                                            table=table_b))
        else:
            outs = render_dual(largs, leaves_b, cam, impl="plain", config=BINNING)
        a, b = outs
        loss = (a.image.square().sum() + 0.5 * b.image.abs().sum() + a.depth.mean()
                + 0.3 * b.depth.mean())
        grads = torch.autograd.grad(loss, [*leaves.values(), leaves_b])
        runs[route] = outs, dict(zip([*names, "colors_b"], grads))
    (got, g_got), (ref, g_ref) = runs["projected"], runs["render_dual"]
    for x, y in zip(got, ref):
        for f in ("image", "depth", "radii", "overflowed", "span_overflowed", "total_pairs"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f
    for f in g_ref:
        assert float(g_ref[f].abs().max()) > 0, f
        assert row_scaled_err(g_got[f], g_ref[f]) <= BWD_TOL[torch.float32], f


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
    """No fallback: the kernels' wrappers (with and without a second colour
    set), ``render(impl="cuda")`` and ``render_dual(impl="cuda")`` refuse
    CPU tensors."""
    from splatpu_torch.render.api import render, render_dual

    args, cam = case("plain")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        project.project_views_cuda(args, cam)
    table, _, visible = project.project_views_plain(args, cam)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        project.project_views_bwd_cuda(table, args, cam, visible, [True] * 6)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        render(args, cam, impl="cuda", config=BINNING)
    colors_b = seg_colors(args.n)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        project.project_views_cuda(args, cam, colors_b)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        project.project_views_bwd_cuda(table, args, cam, visible, [True] * 7, table)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        render_dual(args, colors_b, cam, impl="cuda", config=BINNING)
    cam_grad = dataclasses.replace(cam, w2c=cam.w2c.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="no gradient of the camera"):
        project.project_views(args, cam_grad, impl="plain")


def test_render_cuda_projects_once_and_bins_its_slices(monkeypatch):
    """``render_exact(impl="cuda")`` projects every view through one
    ``ProjectViews`` call (the kernels swapped here for counting plain
    versions), bins slices of its outputs and composites its table: the
    plain render's image bitwise, its gradients within the float32
    tolerance of the analytic backward.  ``render_dual(impl="cuda")`` makes
    one projection forward (both tables) and one backward per call, and
    matches ``render_dual(impl="plain")`` the same way."""
    from splatpu_torch.render.api import render, render_dual

    calls, bwd_calls = [], []

    def fwd(args, camera, *colors_b):
        calls.append(camera.num_views)
        return project.project_views_plain(args, camera, *colors_b)

    def bwd(*a):
        bwd_calls.append(len(a))
        return project.project_views_bwd_plain(*a)

    monkeypatch.setitem(project.KERNELS, "cuda", (fwd, bwd))
    monkeypatch.setitem(exact.KERNELS, ("cuda", "grid"), exact.KERNELS[("plain", "grid")])
    args, cam = case("plain")
    outs = {}
    for impl in ("cuda", "plain"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True)
                  for f in ("means3d", "scales", "rotations", "opacities", "colors")}
        out = render(tt.RenderArgs(**leaves), cam, impl=impl, config=BINNING)
        (out.image.square().sum() + out.depth.mean()).backward()
        outs[impl] = out, {f: x.grad for f, x in leaves.items()}
    assert calls == [cam.num_views] and bwd_calls == [5]
    (a, ga), (b, gb) = outs["cuda"], outs["plain"]
    assert torch.equal(a.image, b.image) and torch.equal(a.radii, b.radii)
    for f in ga:
        assert row_scaled_err(ga[f], gb[f]) <= BWD_TOL[torch.float32], f

    args, cam = case("offset_per_view")
    colors_b = seg_colors(args.n)
    calls.clear()
    bwd_calls.clear()
    for impl in ("cuda", "plain"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True) for f in project.GRAD_NAMES}
        leaves["colors_b"] = colors_b.clone().requires_grad_(True)
        largs = tt.RenderArgs(**{f: leaves[f] for f in project.GRAD_NAMES})
        out, seg = render_dual(largs, leaves["colors_b"], cam, impl=impl, config=BINNING)
        (out.image.square().sum() + seg.image.abs().sum() + out.depth.mean()).backward()
        outs[impl] = (out, seg), {f: x.grad for f, x in leaves.items()}
    assert calls == [cam.num_views] and bwd_calls == [6]
    (a, ga), (b, gb) = outs["cuda"], outs["plain"]
    for x, y in zip(a, b):
        assert torch.equal(x.image, y.image) and torch.equal(x.radii, y.radii)
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


@pytest.mark.parametrize("counts,share", [
    ({"views": 12, "views_projected": 12, "pairs": 3, "wide_pairs": 0}, 100.0),
    ({"views": 12, "views_projected": 0, "pairs": 3, "wide_pairs": 0}, 0.0),
    ({"views": 12, "pairs": 3, "wide_pairs": 0}, None),
    ({}, None),
])
def test_fit_projection_share_reads_the_counts(counts, share):
    """The fit's reader: views projected by the kernel over the views
    binned, from the counts the fit driver took once (``take_counts``, in
    the reading's ``work``); None where the program keeps no such count,
    nothing was binned, or the run was not traced."""
    sys.path.insert(0, str(ROOT))
    from splatbench import harness

    mod = harness.load_module(ROOT / "splatbench" / "metrics" / "fit_projection_share.py",
                              "splatbench_metric_fit_projection_share")
    reading = {"trace": {}, "units": 20, "e2e": {"train_step_ms": 40.0},
               "work": {"counts": dict(counts)}}
    assert mod.read(reading, "fit") == share
    assert mod.read(dict(reading, work={"counts": {}}), "fit") is None
    assert mod.read({k: v for k, v in reading.items() if k != "trace"}, "fit") is None
