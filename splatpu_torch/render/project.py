"""One projection of every view of a render: preprocess and the composite's
table pack for all V views in one CUDA launch forward and one backward
(``csrc/project.cu``).

``ProjectViews`` is one autograd node, differentiable in ``means3d``,
``scales``, ``rotations``, ``opacities``, ``colors``, ``means2d_offset``
and ``colors_b`` (nothing reaches the camera).  Its outputs: the table
(V, N, 7 + C) that ``render/composite.py::pack_table`` packs per view
(mean2d, conic, opacity masked by visibility, depth, colours), ``radius``
(V, N) and ``visible`` (V, N), the last two not differentiable; and where
a second colour set ``colors_b`` (N, C_b) is given (``render_dual``), a
second table (V, N, 7 + C_b) with the same first seven columns and
``colors_b``'s.  The second table's cotangent reaches every input as the
first's does, but ``means2d_offset``, which takes the first table's only:
``render_dual``'s lineage cut.

``KERNELS`` maps an impl to its (forward, backward):

- ``"cuda"``: the kernels, for CUDA tensors only (they raise on others);
- ``"plain"``: the plain PyTorch version, on any device.  Its forward is
  ``core/projection.py::preprocess`` per view with the table packed as the
  exact path packs it, stacked: the spec the kernel's rounding follows on a
  card.  Its backward is the analytic derivative that the backward kernel
  computes, formula for formula, so that the CPU tests hold the kernel's
  mathematics to autograd through ``preprocess``.

``render_exact`` and ``render_dual`` under ``impl="cuda"`` project through
``"cuda"``; every other caller of ``preprocess`` keeps it.
"""

from __future__ import annotations

import numpy as np
import torch

from splatpu_torch import _build
from splatpu_torch.core.projection import preprocess, projection_size, projection_terms
from splatpu_torch.core.quaternion import rotation_entries
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.obs import profiling
from splatpu_torch.render.composite import pack_table

LAUNCHES = 0      # kernel launches made by project_views_cuda
BWD_LAUNCHES = 0  # by project_views_bwd_cuda
# The inputs of the backward, in ProjectViews.apply's order.
GRAD_NAMES = ("means3d", "scales", "rotations", "opacities", "colors", "means2d_offset")


def project_views_plain(args: RenderArgs, camera: Camera, colors_b=None):
    """(table (V, N, 7 + C), radius (V, N), visible (V, N)), and table_b
    (V, N, 7 + C_b) after them where ``colors_b`` is given: ``preprocess``
    of each view, its table packed with the visibility-masked opacity (and
    again with ``colors_b``)."""
    tables, tables_b, radii, visible = [], [], [], []
    op = args.opacities[:, 0]
    for i in range(camera.num_views):
        sp = preprocess(args.for_view(i), camera.view(i))
        g_opacity = torch.where(sp.visible, op, torch.zeros_like(op))
        tables.append(pack_table(sp.mean2d, sp.conic, g_opacity, sp.depth, args.colors))
        if colors_b is not None:
            tables_b.append(pack_table(sp.mean2d, sp.conic, g_opacity, sp.depth, colors_b))
        radii.append(sp.radius)
        visible.append(sp.visible)
    out = torch.stack(tables), torch.stack(radii), torch.stack(visible)
    return out if colors_b is None else (*out, torch.stack(tables_b))


@torch.no_grad()
def project_views_bwd_plain(d_table, args: RenderArgs, camera: Camera, visible, needs,
                            d_table_b=None):
    """The gradients of ``GRAD_NAMES`` (None where ``needs`` is False) from
    d(table), and with ``d_table_b`` (the second table's) that of
    ``colors_b`` after them (``needs[6]``): autograd's derivative of each
    operation of ``project_views_plain``, as ``csrc/project.cu``'s backward
    computes it, the views summed in order.  The second table's first seven
    columns are added to the first's before the geometry's chain; the
    offset takes the first's only."""
    means, scales, rotations = args.means3d, args.scales, args.rotations
    v_count, c = d_table.shape[0], d_table.shape[2] - 7
    names = GRAD_NAMES if d_table_b is None else (*GRAD_NAMES, "colors_b")
    out = dict.fromkeys(names)
    geom = d_table[..., :7] if d_table_b is None else d_table[..., :7] + d_table_b[..., :7]
    if needs[3]:
        out["opacities"] = torch.where(visible, geom[..., 5], 0.0).sum(0)[:, None]
    if needs[4]:
        out["colors"] = d_table[..., 7:7 + c].sum(0)
    if d_table_b is not None and needs[6]:
        out["colors_b"] = d_table_b[..., 7:].sum(0)
    off = args.means2d_offset
    if needs[5]:
        scale = torch.tensor([float(s) * 0.5 for s in projection_size(camera)],
                             dtype=d_table.dtype, device=d_table.device)
        d_off = d_table[..., :2] * scale
        out["means2d_offset"] = d_off if off.dim() == 3 else d_off.sum(0)
    if not any(needs[:3]):
        return tuple(out[k] for k in names)
    d_means = torch.zeros_like(means)
    d_cov = [[0.0] * 3 for _ in range(3)]  # d(cov3d) + its transpose, over the views
    for v in range(v_count):
        t = projection_terms(args.for_view(v), camera.view(v))
        g = geom[v]
        # mean2d <- ndc <- p_hom rows 0, 1 and (through p_w) 3.
        d_ndc = (g[:, :2] * 0.5) * t["wh"]
        d_ph = d_ndc * t["p_w"][:, None]
        d_pw = (d_ndc * t["p_hom"][:, :2]).sum(-1)
        d_ph3 = -d_pw * (t["p_w"] * t["p_w"])
        M = t["P"]
        d_means = d_means + d_ph[:, :1] * M[0, :3] + d_ph[:, 1:] * M[1, :3] + d_ph3[:, None] * M[3, :3]
        # conic <- a, b, c and det.
        a, b, cc, ds = t["a"], t["b"], t["c"], t["det_safe"]
        ca, cb, cc_ = t["conic"].unbind(-1)
        gca, gcb, gcc = g[:, 2], g[:, 3], g[:, 4]
        dc, db, da = gca / ds, -(gcb / ds), gcc / ds
        dds = -gca * (ca / ds) - gcb * (cb / ds) - gcc * (cc_ / ds)
        ddet = torch.where(t["det_valid"], dds, 0.0)
        da, dc, db = da + ddet * cc, dc + ddet * a, db - 2.0 * ddet * b
        # cov2d = JW cov3d JW^T: H = G + G^T with G = [[da, db], [0, dc]].
        # With two tables each entry k <= l is summed once and mirrored, as
        # the kernel's dual instance does: d(cov3d) exactly symmetric.
        JW = t["JW"]
        h00, h01, h11 = 2.0 * da, db, 2.0 * dc
        for k in range(3):
            for l in range(3):
                if d_table_b is not None and l < k:
                    continue
                d = (h00 * JW[0][k] * JW[0][l] + h01 * (JW[0][k] * JW[1][l] + JW[1][k] * JW[0][l])
                     + h11 * JW[1][k] * JW[1][l])
                d_cov[k][l] = d_cov[k][l] + d
                if d_table_b is not None and l > k:
                    d_cov[l][k] = d_cov[l][k] + d
        cov = t["cov3d"]
        tmp = [[cov[k][0] * JW[r][0] + cov[k][1] * JW[r][1] + cov[k][2] * JW[r][2]
                for k in range(3)] for r in range(2)]
        dJW = [[h00 * tmp[0][q] + h01 * tmp[1][q] for q in range(3)],
               [h01 * tmp[0][q] + h11 * tmp[1][q] for q in range(3)]]
        # JW = J Rw, J's entries (0, 0), (0, 2), (1, 1), (1, 2).
        Rw, fx, fy = t["Rw"], t["fx"], t["fy"]
        dJ00 = sum(dJW[0][q] * Rw[0, q] for q in range(3))
        dJ02 = sum(dJW[0][q] * Rw[2, q] for q in range(3))
        dJ11 = sum(dJW[1][q] * Rw[1, q] for q in range(3))
        dJ12 = sum(dJW[1][q] * Rw[2, q] for q in range(3))
        iz, iz2, tzs = t["inv_z"], t["inv_z2"], t["tz_safe"]
        diz = dJ00 * fx + dJ11 * fy
        dtx, dty = dJ02 * iz2 * -fx, dJ12 * iz2 * -fy
        diz2 = dJ02 * (-fx * t["tx"]) + dJ12 * (-fy * t["ty"])
        diz = diz + 2.0 * diz2 * iz
        dtzs = -diz * (iz * iz) + dtx * t["txtz"] + dty * t["tytz"]
        # The frustum clamp passes the gradient on [-lim, lim], bounds included.
        px, py = t["p_view"][:, 0], t["p_view"][:, 1]
        u, w = px / tzs, py / tzs
        du = torch.where((u >= -t["limx"]) & (u <= t["limx"]), dtx * tzs, 0.0)
        dw = torch.where((w >= -t["limy"]) & (w <= t["limy"]), dty * tzs, 0.0)
        dtzs = dtzs - du * (u / tzs) - dw * (w / tzs)
        dtz = g[:, 6] + torch.where(t["tz"] != 0.0, dtzs, 0.0)
        d_pv = torch.stack([du / tzs, dw / tzs, dtz], -1)
        d_means = d_means + d_pv @ Rw.to(d_pv.dtype)
    if needs[0]:
        out["means3d"] = d_means
    # cov3d = RS RS^T, RS = R diag(s); R of q / max(|q|, 1e-12).
    R = rotation_entries(rotations, eps=1e-12)
    s = scales.unbind(-1)
    dRS = [[sum(d_cov[i][j] * R[j][k] * s[k] for j in range(3)) for k in range(3)]
           for i in range(3)]
    if needs[1]:
        out["scales"] = torch.stack([sum(dRS[i][k] * R[i][k] for i in range(3))
                                     for k in range(3)], -1)
    if needs[2]:
        dR = [[dRS[i][k] * s[k] for k in range(3)] for i in range(3)]
        nrm = torch.linalg.vector_norm(rotations, dim=-1)
        nc = torch.clamp(nrm, min=1e-12)
        r, x, y, z = (rotations / nc[:, None]).unbind(-1)
        dq = torch.stack([
            2.0 * (-z * dR[0][1] + y * dR[0][2] + z * dR[1][0] - x * dR[1][2] - y * dR[2][0]
                   + x * dR[2][1]),
            2.0 * (y * dR[0][1] + z * dR[0][2] + y * dR[1][0] - 2.0 * x * dR[1][1] - r * dR[1][2]
                   + z * dR[2][0] + r * dR[2][1] - 2.0 * x * dR[2][2]),
            2.0 * (-2.0 * y * dR[0][0] + x * dR[0][1] + r * dR[0][2] + x * dR[1][0] + z * dR[1][2]
                   - r * dR[2][0] + z * dR[2][1] - 2.0 * y * dR[2][2]),
            2.0 * (-2.0 * z * dR[0][0] - r * dR[0][1] + x * dR[0][2] + r * dR[1][0]
                   - 2.0 * z * dR[1][1] + y * dR[1][2] + x * dR[2][0] + y * dR[2][1]),
        ], -1)
        qn = torch.stack([r, x, y, z], -1)
        dnc = -(dq * (qn / nc[:, None])).sum(-1)
        dnorm = torch.where(nrm >= 1e-12, dnc / nrm, 0.0)
        out["rotations"] = dq / nc[:, None] + rotations * dnorm[:, None]
    return tuple(out[k] for k in names)


def _offset_mode(args: RenderArgs, v: int) -> int:
    off = args.means2d_offset
    if off is None:
        return 0
    if off.shape == (args.n, 2):
        return 1
    if off.shape == (v, args.n, 2):
        return 2
    raise ValueError(f"means2d_offset must be ({args.n}, 2) or ({v}, {args.n}, 2), "
                     f"got {tuple(off.shape)}")


def _camera_args(camera: Camera) -> tuple[list, list]:
    """The launchers' camera arguments: (ints: FOV width, height; floats:
    1/W, 1/H as float32 divisions, the projection's near/far entries
    rounded to float32 from Python's doubles, as ``opengl_projection_matrix``
    stores them)."""
    w, h = projection_size(camera)
    n, f = camera.near, camera.far
    f32 = np.float32
    floats = [f32(1.0) / f32(w), f32(1.0) / f32(h), f32(f / (f - n)), f32(-(f * n) / (f - n))]
    return [w, h], [float(x) for x in floats]


def _check(args: RenderArgs, camera: Camera, colors_b=None):
    """(V, N, C, C_b (0 without ``colors_b``), w2c (V, 4, 4), K (V, 3, 3));
    raise on what the kernels do not take."""
    n = args.n
    c = args.colors.shape[1] if args.colors.dim() == 2 else 0
    cb = 0 if colors_b is None else colors_b.shape[1] if colors_b.dim() == 2 else -1
    v = camera.num_views
    w2c = camera.w2c.reshape(-1, 4, 4).contiguous()
    K = camera.K.reshape(-1, 3, 3).contiguous()
    shapes = dict(means3d=(n, 3), scales=(n, 3), rotations=(n, 4), opacities=(n, 1),
                  colors=(n, c), w2c=(v, 4, 4), K=(v, 3, 3))
    tensors = dict(means3d=args.means3d, scales=args.scales, rotations=args.rotations,
                   opacities=args.opacities, colors=args.colors, w2c=w2c, K=K)
    if colors_b is not None:
        shapes["colors_b"], tensors["colors_b"] = (n, cb), colors_b
    for name, x in tensors.items():
        if tuple(x.shape) != shapes[name] or c < 1 or (colors_b is not None and cb < 1):
            raise ValueError(f"{name} must have shape {shapes[name]} (C >= 1), got {tuple(x.shape)}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {x.dtype}")
    if args.means2d_offset is not None and args.means2d_offset.dtype != torch.float32:
        raise TypeError(f"means2d_offset must be torch.float32, got {args.means2d_offset.dtype}")
    return v, n, c, max(cb, 0), w2c, K


def _ptr(x):
    return None if x is None else x.data_ptr()


def project_views_cuda(args: RenderArgs, camera: Camera, colors_b=None):
    """Launch the forward kernel (one launch, with or without ``colors_b``);
    every tensor must be a contiguous float32 CUDA tensor.  While a profiler
    records, the views are counted (``obs.profiling.count_projection``)."""
    global LAUNCHES
    v, n, c, cb, w2c, K = _check(args, camera, colors_b)
    mode = _offset_mode(args, v)
    off = args.means2d_offset if mode else None
    ins = (args.means3d, args.scales, args.rotations, args.opacities, args.colors, w2c, K)
    _build.require_cuda("project_views_cuda",
                        ins + tuple(x for x in (off, colors_b) if x is not None))
    dev = args.means3d.device
    table = torch.empty((v, n, 7 + c), dtype=torch.float32, device=dev)
    table_b = torch.empty((v, n, 7 + cb), dtype=torch.float32, device=dev) if cb else None
    radius = torch.empty((v, n), dtype=torch.float32, device=dev)
    visible = torch.empty((v, n), dtype=torch.bool, device=dev)
    ints, floats = _camera_args(camera)
    lib = _build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.splatpu_project_fwd(
            *(x.data_ptr() for x in ins[:5]), _ptr(colors_b), _ptr(off), w2c.data_ptr(),
            K.data_ptr(), table.data_ptr(), _ptr(table_b), radius.data_ptr(),
            visible.data_ptr(), v, n, c, cb, mode, *ints, camera.row_offset, *floats, stream)
    _build.check_status(lib, code, "project_fwd launch")
    LAUNCHES += 1
    if torch.autograd._profiler_enabled():
        profiling.count_projection(v)
    out = table, radius, visible
    return out if table_b is None else (*out, table_b)


def project_views_bwd_cuda(d_table, args: RenderArgs, camera: Camera, visible, needs,
                           d_table_b=None):
    """Launch the backward kernel: the gradients of ``GRAD_NAMES`` (None
    where ``needs`` is False) from d(table), and with ``d_table_b`` that of
    ``colors_b`` after them (``needs[6]``), in one launch."""
    global BWD_LAUNCHES
    v, n, c, _, w2c, K = _check(args, camera)
    cb = 0 if d_table_b is None else d_table_b.shape[-1] - 7
    mode = _offset_mode(args, v)
    ins = (d_table, args.means3d, args.scales, args.rotations, visible, w2c, K)
    _build.require_cuda("project_views_bwd_cuda",
                        ins + (() if d_table_b is None else (d_table_b,)))
    for name, x, cols in (("d_table", d_table, c), ("d_table_b", d_table_b, cb)):
        if x is not None and (x.shape != (v, n, 7 + cols) or x.dtype != torch.float32
                              or cols < 1):
            raise ValueError(f"{name} must be float32 ({v}, {n}, 7 + C) with C >= 1, got "
                             f"{x.dtype} {tuple(x.shape)}")
    like = (args.means3d, args.scales, args.rotations, args.opacities, args.colors,
            args.means2d_offset)
    grads = [torch.empty_like(x) if need and x is not None else None
             for x, need in zip(like, needs)]
    colors_b_grad = None
    if d_table_b is not None:
        colors_b_grad = torch.empty((n, cb), device=d_table.device) if needs[6] else None
        grads.append(colors_b_grad)
    ints, floats = _camera_args(camera)
    lib = _build.load_library()
    with torch.cuda.device(d_table.device):
        stream = torch.cuda.current_stream(d_table.device).cuda_stream
        code = lib.splatpu_project_bwd(
            d_table.data_ptr(), _ptr(d_table_b), *(x.data_ptr() for x in ins[1:]),
            *(_ptr(x) for x in grads[:5]), _ptr(colors_b_grad), _ptr(grads[5]),
            v, n, c, cb, mode, *ints, *floats, stream)
    _build.check_status(lib, code, "project_bwd launch")
    BWD_LAUNCHES += 1
    return tuple(grads)


KERNELS = {
    "cuda": (project_views_cuda, project_views_bwd_cuda),
    "plain": (project_views_plain, project_views_bwd_plain),
}


class ProjectViews(torch.autograd.Function):
    """Every view of ``camera`` projected and packed at once, with a second
    table where ``colors_b`` is given; ``impl`` is a key of ``KERNELS``."""

    @staticmethod
    def forward(ctx, means3d, scales, rotations, opacities, colors, means2d_offset, colors_b,
                camera, impl):
        args = RenderArgs(means3d=means3d, scales=scales, rotations=rotations,
                          opacities=opacities, colors=colors, means2d_offset=means2d_offset)
        fwd = KERNELS[impl][0]
        out = fwd(args, camera) if colors_b is None else fwd(args, camera, colors_b)
        ctx.save_for_backward(means3d, scales, rotations, opacities, colors, means2d_offset,
                              camera.w2c, camera.K, out[2])
        ctx.camera, ctx.impl, ctx.dual = camera, impl, colors_b is not None
        ctx.mark_non_differentiable(out[1], out[2])
        return out

    @staticmethod
    def backward(ctx, d_table, _d_radius, _d_visible, d_table_b=None):
        means3d, scales, rotations, opacities, colors, off, _, _, visible = ctx.saved_tensors
        args = RenderArgs(means3d=means3d, scales=scales, rotations=rotations,
                          opacities=opacities, colors=colors, means2d_offset=off)
        bwd = KERNELS[ctx.impl][1]
        if ctx.dual:
            grads = bwd(d_table.contiguous(), args, ctx.camera, visible,
                        ctx.needs_input_grad[:7], d_table_b.contiguous())
        else:
            grads = (*bwd(d_table.contiguous(), args, ctx.camera, visible,
                          ctx.needs_input_grad[:6]), None)
        return (*grads, None, None)


def project_views(args: RenderArgs, camera: Camera, impl: str = "cuda", colors_b=None):
    """(table (V, N, 7 + C), radius (V, N), visible (V, N)) of every view of
    ``camera`` (one autograd node), and table_b (V, N, 7 + C_b) after them
    where a second colour set ``colors_b`` (N, C_b) is given.  The camera
    takes no gradient."""
    if camera.w2c.requires_grad or camera.K.requires_grad:
        raise ValueError("project_views takes no gradient of the camera")
    ins = [x if x is None else x.contiguous()
           for x in (args.means3d, args.scales, args.rotations, args.opacities, args.colors,
                     args.means2d_offset, colors_b)]
    return ProjectViews.apply(*ins, camera, impl)
