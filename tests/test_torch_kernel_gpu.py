"""The CUDA composite kernels (K1/K2, K4 under kernel="manual", K5 of the
padded path; forward and backward) and the routing kernel against their
plain PyTorch versions, on the card: the forward body at every multiple
of 8 from 8 to 64 px with ``last`` identical, the backward body at the same
tiles, 1 to 9 channels and image sizes that cut the last tiles (100x70,
scaled with the tile above 32 px); the routing in
both slot modes, 8 to 16 rows, slot runs up to 512, dropped and clipped
slots; each bitwise identical across two launches.  At the training
shapes (config 3's fitted cloud under 5 rig views at 1280x720, ``CLOUD100K``):
K1, K2, the routing in both slot modes and the ``CompositeTable`` backward;
K4 on a gid of 2^24 + 2^20 slots; the projection kernel at both training
cells' clouds and at the fit's shape.

Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernel_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import splatpu_torch.core.types as tt
import splatpu_torch.render.composite as composite
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.exact import composite_inputs
from splatpu_torch.tools.measure import row_scaled_err

pytestmark = pytest.mark.gpu

ROOT = Path(__file__).resolve().parents[1]
CLOUD100K = "cloud100k"  # config 3's fitted cloud at the training shapes (``training_scene``)
TOL = (2e-5, 2e-4, 2e-5)  # image, depth, final T of every forward against its plain version


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def scene(seed, n, views, width, height, channels, device):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    args = tt.RenderArgs(
        means3d=t(rng.uniform(-1, 1, (n, 3))),
        colors=t(rng.uniform(0, 1, (n, channels))),
        rotations=t(q),
        opacities=t(1 / (1 + np.exp(-rng.uniform(-1, 4, (n, 1))))),
        scales=t(rng.uniform(0.02, 0.15, (n, 3))),
    )
    cams = []
    for v in range(views):
        a = 2 * np.pi * v / max(views, 1)
        eye = np.array([3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross([0.0, 1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        w2c = np.eye(4)
        w2c[:3, :3], w2c[:3, 3] = R, -R @ eye
        f = 0.8 * max(width, height)
        K = [[f, 0, width / 2], [0, f, height / 2], [0, 0, 1]]
        cams.append(tt.Camera(w2c=t(w2c), K=t(K), width=width, height=height))
    return args, tt.stack_cameras(cams)


def rig_camera(views, device):
    """The first ``views`` rig cameras at 1280x720, as one camera."""
    from splatpu_torch.tools.train_scene import rig_cameras

    cams = rig_cameras(1280, 720)[:views]
    return tt.Camera(w2c=torch.from_numpy(np.stack([c[0] for c in cams])).to(device),
                     K=torch.from_numpy(np.stack([c[1] for c in cams])).to(device), width=1280,
                     height=720)


def training_scene(device):
    """Config 3's fitted cloud (``runs/s1_ceiling_r4b``, its 100,585 alive
    Gaussians) under the first 5 rig cameras at 1280x720, as stage 2
    trains it: (RenderArgs, camera)."""
    from splatpu_torch.io.checkpoint import load_cloud
    from splatpu_torch.train.stage2 import compact_cloud

    cloud = compact_cloud(load_cloud(ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz",
                                     device=device))
    assert cloud.capacity == 100_585
    return tt.activate_cloud(cloud), rig_camera(5, device)


def seeded_colors(args, channels, rng):
    """``args`` with ``channels`` colours drawn uniformly from ``rng``."""
    colors = torch.tensor(np.asarray(rng.uniform(0, 1, (args.n, channels)), np.float32),
                          device=args.colors.device)
    return tt.RenderArgs(args.means3d, colors, args.rotations, args.opacities, args.scales)


def loss_cotangents(image, depth, tfin):
    """The cotangents of 0.8 L1 + 0.2 (1 - SSIM) against the image shifted
    by (3, 5) px, + 0.1 mean depth + 0.05 mean T."""
    from splatpu_torch.core.ssim import ssim

    leaves = [x.detach().clone().requires_grad_(True) for x in (image, depth, tfin)]
    target = torch.roll(image, shifts=(3, 5), dims=(2, 3))
    loss = (0.8 * (leaves[0] - target).abs().mean() + 0.2 * (1.0 - ssim(leaves[0], target))
            + 0.1 * leaves[1].mean() + 0.05 * leaves[2].mean())
    return tuple(g.contiguous() for g in torch.autograd.grad(loss, leaves))


def table_scene(seed, n, views, width, height, tile, channels, device):
    """(RenderArgs, camera, binning): ``scene`` at a fixed budget, or for
    ``n == CLOUD100K`` ``training_scene`` at its demand budget."""
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    if n == CLOUD100K:
        args, cams = training_scene(device)
        return args, cams, demand_binning(*measure_binning_demand(args, cams, tile=tile), tile=tile)
    args, cams = scene(seed, n, views, width, height, channels, device)
    return args, cams, BinningConfig(tile=tile, max_span=256, max_pairs=1 << 18, chunk_pairs=256)


def check_forward(got, ref):
    """Image, depth and final T within ``TOL``, ``last`` identical."""
    for a, b, tol in zip(got[:3], ref[:3], TOL):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    assert torch.equal(got[3], ref[3])


def check_table_backward(kin, geo, streams, cot, kernel):
    """The ``CompositeTable`` backward (forward, backward composite,
    routing) under ``("cuda", kernel)`` against ``("plain", kernel)`` on
    d(table), 1e-4 scaled per row."""
    from splatpu_torch.render.exact import CompositeTable

    stack = lambda f: torch.stack([getattr(s, f) for s in streams])  # noqa: E731
    d_table = {}
    for impl in ("cuda", "plain"):
        table = kin[0].detach().clone().requires_grad_(True)
        outs = CompositeTable.apply(table, kin[4], *kin[1:4], stack("offsets"), stack("counts"),
                                    stack("lane"), geo, (impl, kernel))
        torch.autograd.backward(outs[:3], cot)
        d_table[impl] = table.grad
    assert torch.isfinite(d_table["cuda"]).all() and bool((d_table["cuda"] != 0).any())
    assert row_scaled_err(d_table["cuda"], d_table["plain"]) <= 1e-4


@pytest.mark.parametrize(
    "n,views,width,height,tile,channels",
    [(300, 1, 48, 32, 16, 3), (3000, 3, 100, 70, 32, 3), (1500, 2, 64, 64, 32, 1),
     pytest.param(CLOUD100K, 5, 1280, 720, 32, 3, id=CLOUD100K)],
)
def test_kernel_matches_plain(cuda, n, views, width, height, tile, channels):
    args, cams, cfg = table_scene(n, n, views, width, height, tile, channels, cuda)
    _, k = composite_inputs(args, cams, cfg)
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    before = composite.LAUNCHES
    got = composite.composite_fwd_cuda(k["table"], k["gid"], k["start"], k["end"], bg, **k["geometry"])
    torch.cuda.synchronize()
    assert composite.LAUNCHES == before + 1
    ref = composite.composite_fwd_plain(k["table"], k["gid"], k["start"], k["end"], bg, **k["geometry"])
    assert got[0].shape == (views, channels, height, width)
    check_forward(got, ref)
    assert bool((got[3] >= 0).any())


def scaled_err(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


@pytest.mark.parametrize(
    "n,views,width,height,tile,channels",
    [(300, 1, 48, 32, 16, 3), (3000, 3, 100, 70, 32, 3), (1500, 2, 64, 64, 32, 1),
     (1500, 2, 64, 48, 8, 3), (3000, 3, 100, 70, 24, 3),
     pytest.param(CLOUD100K, 5, 1280, 720, 32, 3, id=CLOUD100K)],
)
def test_backward_kernels_match_plain(cuda, n, views, width, height, tile, channels):
    """K2 and the routing against their plain versions on the same rows
    (rows 1e-4 scaled by the largest row value and per row, the routing
    1e-5 scaled by the largest value and 1e-4 per row), each bitwise
    identical across two launches; the ``CompositeTable`` backward on
    d(table).  Random cotangents, or at ``CLOUD100K`` those of an L1 + SSIM
    loss."""
    import splatpu_torch.render.route as route

    seed = None if n == CLOUD100K else n + 1
    args, cams, cfg = table_scene(seed, n, views, width, height, tile, channels, cuda)
    streams, k = composite_inputs(args, cams, cfg)
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    kin = (k["table"], k["gid"], k["start"], k["end"], bg)
    image, depth, tfin, last = composite.composite_fwd_cuda(*kin, **k["geometry"])
    if n == CLOUD100K:
        cot = loss_cotangents(image, depth, tfin)
    else:
        rng = np.random.default_rng(n)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
        cot = (t(rng.normal(size=(views, channels, height, width))),
               t(rng.normal(size=(views, height, width))), t(rng.normal(size=(views, height, width))))
    before = (composite.BWD_LAUNCHES, route.LAUNCHES)
    rows = composite.composite_bwd_cuda(*kin, tfin, last, *cot, **k["geometry"])
    rows_again = composite.composite_bwd_cuda(*kin, tfin, last, *cot, **k["geometry"])
    torch.cuda.synchronize()
    ref = composite.composite_bwd_plain(*kin, tfin, last, *cot, **k["geometry"])
    assert rows.shape == (views, k["gid"].shape[1], 7 + channels)
    assert torch.isfinite(rows).all() and rows.abs().max() > 0
    assert scaled_err(rows, ref) <= 1e-4
    assert row_scaled_err(rows, ref) <= 1e-4
    assert torch.equal(rows, rows_again)
    del ref

    offsets = torch.stack([s.offsets for s in streams])
    counts = torch.stack([s.counts for s in streams])
    lane = torch.stack([s.lane for s in streams])
    pos = route.pos_of_slot_of(offsets, k["gid"], lane)
    d_table = route.route_pairs_cuda(rows, pos, offsets, counts)
    d_again = route.route_pairs_cuda(rows, pos, offsets, counts)
    torch.cuda.synchronize()
    assert (composite.BWD_LAUNCHES, route.LAUNCHES) == (before[0] + 2, before[1] + 2)
    ref_table = route.route_pairs_plain(rows, pos, offsets, counts)
    assert d_table.shape == k["table"].shape
    assert scaled_err(d_table, ref_table) <= 1e-5
    assert row_scaled_err(d_table, ref_table) <= 1e-4
    assert torch.equal(d_table, d_again)
    del rows, rows_again, d_table, d_again, ref_table
    check_table_backward(kin, k["geometry"], streams, cot, "grid")


@pytest.mark.parametrize("bench", [False, True], ids=["small", "bench"])
def test_render_gradients_cuda_match_plain(cuda, bench):
    """``render`` through the kernels against the plain versions: the loss
    1e-5 relative, the forward as ``check_forward``, every gradient 1e-4
    scaled by its largest value and per column.  ``bench``:
    ``bench_torch.py``'s scene, 100,000 random Gaussians from ``key(0)``
    under one look-at view at 1280x720, ``default_config``'s budget."""
    from splatpu_torch.render.api import default_config, render

    if bench:
        from splatpu_torch.core import prng
        from splatpu_torch.data.synthetic import make_lookat_camera, make_random_cloud

        args = tt.activate_cloud(make_random_cloud(prng.key(0), 100_000, extent=1.2,
                                                   scale_range=(0.005, 0.02), device=cuda))
        cams = tt.stack_cameras([make_lookat_camera(eye=(0, 0, -4.0), width=1280, height=720,
                                                    focal=0.8 * 1280, device=cuda)])
        cfg = default_config(100_000)
    else:
        args, cams = scene(7, 2000, 2, 96, 64, 3, cuda)
        cfg = BinningConfig(tile=32, max_span=256, max_pairs=1 << 17, chunk_pairs=256)
    target = torch.full((cams.num_views, 3, cams.height, cams.width), 0.4, device=cuda)
    runs = {}
    for impl in ("cuda", "plain"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True)
                  for f in ("means3d", "colors", "rotations", "opacities", "scales")}
        out = render(tt.RenderArgs(**leaves), cams, bg=torch.full((3,), 0.2, device=cuda),
                     impl=impl, config=cfg)
        loss = (out.image - target).abs().mean() + 0.1 * out.depth.mean()
        loss.backward()
        assert not bool(out.overflowed.any())
        runs[impl] = (float(loss.detach()), [x.detach() for x in (
            out.image, out.depth, out.final_transmittance, out.last_contributor)],
            {f: x.grad for f, x in leaves.items()})
    (loss, got, grads), (ref_loss, ref, ref_grads) = runs["cuda"], runs["plain"]
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    check_forward(got, ref)
    for f, g in grads.items():
        assert torch.isfinite(g).all(), f
        assert scaled_err(g, ref_grads[f]) <= 1e-4, f
        assert row_scaled_err(g, ref_grads[f]) <= 1e-4, f


def manual_case(inputs, channels, seed, cuda):
    """K4's inputs under kernel="manual" with ``channels`` seeded colours:
    the random scene's stream at 16 px tiles and a fixed budget, with
    random cotangents; or at ``CLOUD100K`` ``training_scene``'s at its
    demand budget (32 px; config 3's own colours at 3 channels), with no
    cotangents (the test takes those of an L1 + SSIM loss).  (streams,
    inputs, geometry, cotangents, camera)."""
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    if inputs == CLOUD100K:
        args, cams = training_scene(cuda)
        cfg = demand_binning(*measure_binning_demand(args, cams), overrides={"kernel": "manual"})
    else:
        args, cams = scene(11, 2500, 2, 96, 64, 3, cuda)
        cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 18, chunk_pairs=256,
                            kernel="manual")
    if not (inputs == CLOUD100K and channels == 3):
        args = seeded_colors(args, channels, rng)
    streams, k = composite_inputs(args, cams, cfg)
    v, h, w = cams.num_views, cams.height, cams.width
    cot = None if inputs == CLOUD100K else (
        t(rng.normal(size=(v, channels, h, w))), t(rng.normal(size=(v, h, w))),
        t(rng.normal(size=(v, h, w))))
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    return streams, (k["table"], k["gid"], k["start"], k["end"], bg), k["geometry"], cot, cams


BIG_P = (1 << 24) + (1 << 20)  # gid slots of K4's large-budget call
BIG_BASE = 1 << 24             # where its segments start


def big_budget(kin, tiles=4):
    """View 0 of ``kin`` with its ``tiles`` longest segments moved above
    pair position ``BIG_BASE`` in a gid of ``BIG_P`` slots and every other
    tile empty, and the same segments packed into a gid of their own: (the
    large inputs, the packed inputs, the pairs they hold)."""
    table, gid, start, end, bg = (x[:1] if x.dim() > 1 else x for x in kin)
    lengths = (end - start)[0]
    longest = torch.argsort(lengths, descending=True)[:tiles]
    window = torch.cat([gid[0, int(start[0, t]):int(end[0, t])] for t in longest.tolist()])
    lens = lengths[longest]
    offs = torch.cumsum(lens, 0) - lens
    start_w, end_w = torch.zeros_like(start), torch.zeros_like(end)
    start_w[0, longest] = offs.int()
    end_w[0, longest] = (offs + lens).int()
    gid_big = torch.zeros((1, BIG_P), dtype=torch.int32, device=gid.device)
    gid_big[0, BIG_BASE:BIG_BASE + window.numel()] = window
    start_b = torch.where(end_w > start_w, start_w + BIG_BASE, start_w)
    end_b = torch.where(end_w > start_w, end_w + BIG_BASE, end_w)
    return ((table, gid_big, start_b, end_b, bg), (table, window[None].contiguous(), start_w, end_w, bg),
            window.numel())


@pytest.mark.parametrize("channels,gid_slots,inputs", [
    (3, None, "random"), (9, None, "random"), (9, BIG_P, "random"), (3, None, CLOUD100K),
    (9, None, CLOUD100K)], ids=["3", "9", "9-2^24+2^20", f"3-{CLOUD100K}", f"9-{CLOUD100K}"])
def test_manual_kernels_match_plain(cuda, channels, gid_slots, inputs):
    """K4's forward (``check_forward``) and backward (rows 1e-4 scaled by
    the largest value and per row, bitwise identical across two launches)
    against their plain versions, the routing of its rows and the
    ``CompositeTable`` backward under kernel="manual" (1e-4 per row); on
    the random scene, or on config 3's cloud at 5 x 1280x720 at its demand
    budget (``CLOUD100K``).  With ``gid_slots``: one view on a gid of
    2^24 + 2^20 slots whose segments lie above 2^24 (``big_budget``),
    against the plain versions on the packed segments; the rows outside
    them zero."""
    import splatpu_torch.render.route as route

    streams, kin, geo, cot, cams = manual_case(inputs, channels, channels, cuda)
    kin_plain, shift = kin, 0
    if gid_slots:
        kin, kin_plain, n_win = big_budget(kin)
        cot, shift = tuple(x[:1] for x in cot), BIG_BASE
    views = kin[0].shape[0]
    before = (composite.MANUAL_LAUNCHES, composite.MANUAL_BWD_LAUNCHES)
    got = composite.composite_manual_fwd_cuda(*kin, **geo)
    torch.cuda.synchronize()
    ref = composite.composite_manual_fwd_plain(*kin_plain, **geo)
    moved = lambda last, by: torch.where(last >= 0, last + by, last)  # noqa: E731
    assert got[0].shape == (views, channels, cams.height, cams.width)
    check_forward(got, (*ref[:3], moved(ref[3], shift)))
    assert bool((got[3] >= shift).any())
    del ref
    if cot is None:
        cot = loss_cotangents(*got[:3])
    rows = composite.composite_manual_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    again = composite.composite_manual_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    torch.cuda.synchronize()
    assert (composite.MANUAL_LAUNCHES, composite.MANUAL_BWD_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 2)
    ref_rows = composite.composite_manual_bwd_plain(*kin_plain, got[2], moved(got[3], -shift),
                                                    *cot, **geo)
    assert rows.shape == (views, kin[1].shape[1], 7 + channels)
    assert torch.isfinite(rows).all() and rows.abs().max() > 0
    assert torch.equal(rows, again)
    if gid_slots:
        assert not bool(rows[0, :BIG_BASE].any()) and not bool(rows[0, BIG_BASE + n_win:].any())
        rows = rows[:, BIG_BASE:BIG_BASE + n_win]
        assert float(rows.abs().max()) > 0
    assert scaled_err(rows, ref_rows) <= 1e-4
    assert row_scaled_err(rows, ref_rows) <= 1e-4
    if gid_slots:
        return
    offsets, counts, lane = (torch.stack([getattr(s, f) for s in streams])
                             for f in ("offsets", "counts", "lane"))
    pos = route.pos_of_slot_of(offsets, kin[1], lane)
    routed = route.route_pairs_cuda(rows, pos, offsets, counts)
    assert row_scaled_err(routed, route.route_pairs_plain(rows, pos, offsets, counts)) <= 1e-4
    check_table_backward(kin, geo, streams, cot, "manual")


def padded_inputs(args, cams, cfg, bg):
    """The padded stream of every view under ``cfg`` (16 px tiles): K5's
    inputs (records gathered by gid), its geometry, and the per-Gaussian
    table, gid and slot map that ``CompositeG`` and the routing take."""
    from splatpu_torch.render.binning import build_pair_stream
    from splatpu_torch.render.composite import pack_table

    streams = [build_pair_stream(args, cams.view(i), cfg) for i in range(cams.num_views)]
    stack = lambda f: torch.stack([getattr(s, f) for s in streams])  # noqa: E731
    table = torch.stack([pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth,
                                    s.g_colors) for s in streams])
    gid = stack("gid")
    records = table[torch.arange(len(streams), device=gid.device)[:, None], gid.long()]
    w, h = cams.width, cams.height
    geo = dict(tiles_x=-(-w // 16), tiles_y=-(-h // 16), width=w, height=h)
    return ((records.contiguous(), stack("start"), stack("end"), bg), geo,
            dict(table=table, gid=gid, pos=stack("q_of_slot"), offsets=stack("emit_offsets"),
                 counts=stack("emit_counts")))


def padded_case(inputs, channels, seed, cuda):
    """``padded_inputs`` at 16 px tiles with ``channels`` seeded colours: of
    the random scene at a fixed budget, with random cotangents; or at
    ``CLOUD100K`` of ``training_scene`` at its 16 px demand budget (the
    padded path's training shapes; config 3's own colours at 3 channels),
    with no cotangents (the caller takes those of an L1 + SSIM loss)."""
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    if inputs == CLOUD100K:
        args, cams = training_scene(cuda)
        cfg = demand_binning(*measure_binning_demand(args, cams, tile=16), tile=16)
    else:
        args, cams = scene(12, 2500, 2, 100, 70, 3, cuda)
        cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 17, chunk_pairs=128)
    if not (inputs == CLOUD100K and channels == 3):
        args = seeded_colors(args, channels, rng)
    kin, geo, parts = padded_inputs(args, cams, cfg, torch.linspace(0.1, 0.3, channels, device=cuda))
    v, h, w = cams.num_views, cams.height, cams.width
    cot = None if inputs == CLOUD100K else (
        t(rng.normal(size=(v, channels, h, w))), t(rng.normal(size=(v, h, w))),
        t(rng.normal(size=(v, h, w))))
    return kin, geo, cot, parts


@pytest.mark.parametrize("channels,inputs", [(3, "random"), (9, "random"), (3, CLOUD100K),
                                            (9, CLOUD100K)],
                         ids=["3", "9", f"3-{CLOUD100K}", f"9-{CLOUD100K}"])
def test_padded_kernels_match_plain(cuda, channels, inputs):
    """K5's forward (``check_forward``) and backward (rows 1e-4 scaled by
    the largest value and per row, bitwise identical across two launches)
    against their plain versions, the routing of its rows in the padded
    slot mode and the ``CompositeG`` backward on d(table) (1e-4 per row);
    on the random scene, or on config 3's cloud at 5 x 1280x720 at its
    16 px demand budget (``CLOUD100K``)."""
    import splatpu_torch.render.padded as padded
    import splatpu_torch.render.route as route

    kin, geo, cot, parts = padded_case(inputs, channels, channels + 1, cuda)
    before = (padded.LAUNCHES, padded.BWD_LAUNCHES)
    got = padded.padded_fwd_cuda(*kin, **geo)
    torch.cuda.synchronize()
    ref = padded.padded_fwd_plain(*kin, **geo)
    check_forward(got, ref)
    assert bool((got[3] >= 0).any())
    del ref
    if cot is None:
        cot = loss_cotangents(*got[:3])
    rows = padded.padded_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    again = padded.padded_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    torch.cuda.synchronize()
    assert (padded.LAUNCHES, padded.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    ref_rows = padded.padded_bwd_plain(*kin, got[2], got[3], *cot, **geo)
    assert torch.isfinite(rows).all() and rows.abs().max() > 0
    assert scaled_err(rows, ref_rows) <= 1e-4
    assert row_scaled_err(rows, ref_rows) <= 1e-4
    assert torch.equal(rows, again)
    routing = (parts["pos"], parts["offsets"], parts["counts"])
    routed = route.route_pairs_cuda(rows, *routing, padded=True)
    assert row_scaled_err(routed, route.route_pairs_plain(rows, *routing, padded=True)) <= 1e-4
    d_table = {}
    for impl in ("cuda", "plain"):
        table = parts["table"].clone().requires_grad_(True)
        outs = padded.CompositeG.apply(table, kin[3], parts["gid"], kin[1], kin[2], *routing, geo,
                                       impl)
        torch.autograd.backward(outs[:3], cot)
        d_table[impl] = table.grad
    assert torch.isfinite(d_table["cuda"]).all() and bool((d_table["cuda"] != 0).any())
    assert row_scaled_err(d_table["cuda"], d_table["plain"]) <= 1e-4


@pytest.mark.parametrize("impls,kernel", [(("cuda", "plain"), "manual"),
                                          (("cuda_padded", "plain_padded"), "grid")])
def test_new_path_gradients_cuda_match_plain(cuda, impls, kernel):
    from splatpu_torch.render.api import render

    args, cams = scene(13, 2000, 2, 96, 64, 3, cuda)
    cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 17, chunk_pairs=128, kernel=kernel)
    target = torch.full((2, 3, 64, 96), 0.4, device=cuda)
    grads = {}
    for impl in impls:
        leaves = {f: getattr(args, f).clone().requires_grad_(True)
                  for f in ("means3d", "colors", "rotations", "opacities", "scales")}
        out = render(tt.RenderArgs(**leaves), cams, bg=torch.full((3,), 0.2, device=cuda),
                     impl=impl, config=cfg)
        loss = (out.image - target).abs().mean() + 0.1 * out.depth.mean()
        loss.backward()
        grads[impl] = {f: x.grad for f, x in leaves.items()}
    for f, g in grads[impls[0]].items():
        assert torch.isfinite(g).all(), f
        assert scaled_err(g, grads[impls[1]][f]) <= 1e-4, f


def routing_case(padded, r, seed, device):
    """Two views of 3,000 Gaussians with contiguous slot ranges, mostly 0-8
    slots, a few runs of 100-512; rows (V, P, R) and the slot map.  Exact:
    P = 90% of the slots, so the last ranges run past P, and one slot in
    ten maps to P (dropped by the sort).  Padded: S = 80% of the slots, so
    the last ranges are clipped to slot S - 1, and P = 1.5 S positions."""
    rng = np.random.default_rng(seed)
    v, n = 2, 3000
    counts = rng.integers(0, 9, size=(v, n))
    long = rng.choice(n, size=(v, 6), replace=False)
    for i in range(v):
        counts[i, long[i]] = [512, 511, 300, 200, 129, 100]
    offsets = np.cumsum(counts, axis=1) - counts
    total = int(counts.sum(axis=1).min())
    if padded:
        s_len = int(0.8 * total)
        p = int(1.5 * s_len)
        slot_map = rng.integers(0, p, size=(v, s_len))
    else:
        p = s_len = int(0.9 * total)
        slot_map = np.stack([rng.permutation(p) for _ in range(v)])
        slot_map[rng.random((v, p)) < 0.1] = p
    t = lambda a, dt: torch.tensor(np.asarray(a), dtype=dt, device=device)  # noqa: E731
    return (t(rng.normal(size=(v, p, r)), torch.float32), t(slot_map, torch.int32),
            t(offsets, torch.int32), t(counts, torch.int32))


def padded_training_routing(device):
    """The padded path's routing inputs at its training shapes: K5's
    backward rows over ``padded_case(CLOUD100K)`` on the cotangents of an
    L1 + SSIM loss; the streams' slot map, offsets and counts."""
    import splatpu_torch.render.padded as padded

    kin, geo, _, parts = padded_case(CLOUD100K, 3, 4, device)
    out = padded.padded_fwd_cuda(*kin, **geo)
    rows = padded.padded_bwd_cuda(*kin, *out[2:], *loss_cotangents(*out[:3]), **geo)
    return rows, parts["pos"], parts["offsets"], parts["counts"]


# (padded slot mode, rows, inputs): random slot maps, and the padded
# stream at the padded path's training shapes.
ROUTING_CASES = [pytest.param(padded, r, "random", id=f"{r}-{'padded' if padded else 'exact'}")
                 for padded in (False, True) for r in (8, 10, 16)] + [
    pytest.param(True, 10, CLOUD100K, id=f"10-padded-{CLOUD100K}")]


@pytest.mark.parametrize("padded,r,inputs", ROUTING_CASES)
def test_routing_modes_match_plain(cuda, padded, r, inputs):
    """The routing kernel against its plain version, 1e-5 scaled per row
    on random slot maps (1e-4 on the training shapes' stream), bitwise
    identical across two launches."""
    import splatpu_torch.render.route as route

    if inputs == CLOUD100K:
        rows, slot_map, offsets, counts = padded_training_routing(cuda)
    else:
        rows, slot_map, offsets, counts = routing_case(padded, r, r + 100 * padded, cuda)
    before = route.LAUNCHES
    got = route.route_pairs_cuda(rows, slot_map, offsets, counts, padded=padded)
    again = route.route_pairs_cuda(rows, slot_map, offsets, counts, padded=padded)
    torch.cuda.synchronize()
    assert route.LAUNCHES == before + 2
    ref = route.route_pairs_plain(rows, slot_map, offsets, counts, padded=padded)
    assert got.shape == (rows.shape[0], offsets.shape[1], r) and torch.isfinite(got).all()
    assert row_scaled_err(got, ref) <= (1e-5 if inputs == "random" else 1e-4)
    assert torch.equal(got, again)
    if inputs == CLOUD100K:
        assert bool((got != 0).any())
        return
    # Long runs inside the slot map were summed, and slots run past it.
    ends = offsets.long() + counts.long()
    long_inside = (counts >= 100) & (ends <= slot_map.shape[1])
    assert bool(long_inside.any()) and bool((got[long_inside] != 0).all())
    assert bool((ends > slot_map.shape[1]).any())


LARGE_TILES = (40, 48, 56, 64)
BWD_CASES = [("composite_bwd", 16, c) for c in (1, 3, 5)] + [
    ("composite_bwd", 32, c) for c in (1, 3, 5)] + [
    ("composite_manual_bwd", t, c) for t in (16, 32) for c in (1, 3, 5, 9)] + [
    ("padded_bwd", 16, c) for c in (1, 3, 5, 9)] + [
    ("composite_bwd", t, c) for t in (8, 24) for c in (1, 3, 5)] + [
    ("composite_manual_bwd", t, c) for t in (8, 24) for c in (3, 9)] + [
    ("composite_bwd", t, c) for t in LARGE_TILES for c in (1, 3, 5)] + [
    ("composite_manual_bwd", t, c) for t in LARGE_TILES for c in (3, 9)]


def frame(tile):
    """The body tests' image: 100x70, which no tile divides, scaled with
    tiles above 32 px to the tile grid 32 px tiles make of it (4 x 3 tiles,
    the last column and row cut)."""
    return (100, 70) if tile <= 32 else (100 * tile // 32, 70 * tile // 32)


@pytest.mark.parametrize("kernel,tile,channels", BWD_CASES)
def test_backward_body_matches_plain(cuda, kernel, tile, channels):
    """Each backward kernel against its plain version on ``frame(tile)``
    images, rows 1e-4 scaled per row, bitwise identical across two
    launches."""
    import splatpu_torch.render.padded as padded
    from splatpu_torch.render.binning import build_pair_stream
    from splatpu_torch.render.composite import pack_table

    rng = np.random.default_rng(tile * 10 + channels)
    args, cams = scene(tile + channels, 2500, 2, *frame(tile), 3, cuda)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    # Means spread across the whole image, so the cut tiles hold pairs.
    spread = torch.tensor([2.5, 2.0, 1.0], device=cuda)
    args = tt.RenderArgs(args.means3d * spread, t(rng.uniform(0, 1, (args.n, channels))),
                         args.rotations, args.opacities, args.scales)
    v, h, w = cams.num_views, cams.height, cams.width
    cot = (t(rng.normal(size=(v, channels, h, w))), t(rng.normal(size=(v, h, w))),
           t(rng.normal(size=(v, h, w))))
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    if kernel == "padded_bwd":
        cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 17, chunk_pairs=128)
        streams = [build_pair_stream(args, cams.view(i), cfg) for i in range(v)]
        records = torch.stack([
            pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth, s.g_colors)
            [s.gid.long()] for s in streams]).contiguous()
        kin = (records, torch.stack([s.start for s in streams]),
               torch.stack([s.end for s in streams]), bg)
        geo = dict(tiles_x=-(-w // 16), tiles_y=-(-h // 16), width=w, height=h)
        fwd, bwd, bwd_plain = padded.padded_fwd_cuda, padded.padded_bwd_cuda, padded.padded_bwd_plain
    else:
        cfg = BinningConfig(tile=tile, max_span=256, max_pairs=1 << 18, chunk_pairs=256)
        _, k = composite_inputs(args, cams, cfg)
        kin, geo = (k["table"], k["gid"], k["start"], k["end"], bg), k["geometry"]
        fwd = (composite.composite_fwd_cuda if kernel == "composite_bwd"
               else composite.composite_manual_fwd_cuda)
        bwd = getattr(composite, f"{kernel}_cuda")
        bwd_plain = getattr(composite, f"{kernel}_plain")
    _, _, tfin, last = fwd(*kin, **geo)
    rows = bwd(*kin, tfin, last, *cot, **geo)
    again = bwd(*kin, tfin, last, *cot, **geo)
    torch.cuda.synchronize()
    ref = bwd_plain(*kin, tfin, last, *cot, **geo)
    assert rows.shape == ref.shape and rows.shape[-1] == 7 + channels
    assert torch.isfinite(rows).all() and bool((rows.abs().amax((0, 1)) > 0).all())
    assert row_scaled_err(rows, ref) <= 1e-4
    assert torch.equal(rows, again)
    # The pixels of the cut tiles reach the rows: the last tile column and
    # row of the image hold live pixels.
    assert bool((last[:, :, w - 1] >= 0).any()) and bool((last[:, h - 1, :] >= 0).any())


def forward_scene(seed, channels, device, size=(100, 70)):
    """2,000 splats spread over most of a ``size`` frame (100x70: no tile
    size divides it; ``frame(tile)``) and, in front of view 0, a wall of 200
    opaque ones: at every tile size the renders hold empty tiles, segments
    of several hundred pairs, pixels whose T reaches 1e-4 within their
    first batch of 32 pairs, and live pixels in the cut last tile column
    and row."""
    rng = np.random.default_rng(seed)
    args, cams = scene(seed, 2000, 2, *size, channels, device)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    n = 200
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    wall = np.stack([rng.uniform(-0.6, 0.6, n), rng.uniform(-0.5, 0.5, n),
                     rng.uniform(-2.3, -1.8, n)], 1)
    return tt.RenderArgs(
        means3d=torch.cat([args.means3d * t([1.5, 1.3, 1.0]) + t([0.7, 0.5, 0.0]), t(wall)]),
        colors=torch.cat([args.colors, t(rng.uniform(0, 1, (n, channels)))]),
        rotations=torch.cat([args.rotations, t(q)]),
        opacities=torch.cat([args.opacities, t(np.full((n, 1), 0.98))]),
        scales=torch.cat([args.scales, t(rng.uniform(0.05, 0.12, (n, 3)))]),
    ), cams


FWD_CASES = [("composite_fwd", t, c) for t in (8, 16, 24, 32) for c in (1, 3, 5)] + [
    ("composite_manual_fwd", 32, c) for c in (1, 3, 9)] + [("padded_fwd", 16, c) for c in (3, 9)] + [
    ("composite_manual_fwd", t, c) for t in (8, 24) for c in (3, 9)] + [
    ("composite_fwd", t, c) for t in LARGE_TILES for c in (1, 3, 5)] + [
    ("composite_manual_fwd", t, c) for t in LARGE_TILES for c in (3, 9)]


@pytest.mark.parametrize("kernel,tile,channels", FWD_CASES)
def test_forward_body_matches_plain(cuda, kernel, tile, channels):
    """Each forward kernel against its plain version: image 2e-5, depth 2e-4,
    final T 2e-5, ``last`` identical; two launches bitwise identical; at the
    backward's tiles, the backward run from this forward's ``last`` and
    final T against its plain version, 1e-4 scaled per row."""
    import splatpu_torch.render.padded as padded
    from splatpu_torch.render.binning import build_pair_stream
    from splatpu_torch.render.composite import BWD_TILES, pack_table, untile

    args, cams = forward_scene(tile + channels, channels, cuda, frame(tile))
    v, h, w = cams.num_views, cams.height, cams.width
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    if kernel == "padded_fwd":
        cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 17, chunk_pairs=128)
        streams = [build_pair_stream(args, cams.view(i), cfg) for i in range(v)]
        records = torch.stack([
            pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth, s.g_colors)
            [s.gid.long()] for s in streams]).contiguous()
        start, end = torch.stack([s.start for s in streams]), torch.stack([s.end for s in streams])
        kin = (records, start, end, bg)
        geo = dict(tiles_x=-(-w // 16), tiles_y=-(-h // 16), width=w, height=h)
        fwd, fwd_plain = padded.padded_fwd_cuda, padded.padded_fwd_plain
        bwd, bwd_plain = padded.padded_bwd_cuda, padded.padded_bwd_plain
        counter = (padded, "LAUNCHES")
    else:
        cfg = BinningConfig(tile=tile, max_span=256, max_pairs=1 << 18, chunk_pairs=256)
        _, k = composite_inputs(args, cams, cfg)
        start, end = k["start"], k["end"]
        kin, geo = (k["table"], k["gid"], start, end, bg), k["geometry"]
        fwd, fwd_plain = getattr(composite, f"{kernel}_cuda"), getattr(composite, f"{kernel}_plain")
        bwd_name = kernel.replace("fwd", "bwd")
        bwd, bwd_plain = (getattr(composite, f"{bwd_name}_cuda"),
                          getattr(composite, f"{bwd_name}_plain"))
        counter = (composite, "LAUNCHES" if kernel == "composite_fwd" else "MANUAL_LAUNCHES")
    before = getattr(*counter)
    got = fwd(*kin, **geo)
    again = fwd(*kin, **geo)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 2
    *ref, n_eval, _ = fwd_plain(*kin, **geo, with_counts=True)
    assert got[0].shape == (v, channels, h, w)
    for a, b, tol in zip(got[:3], ref[:3], (2e-5, 2e-4, 2e-5)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    assert torch.equal(got[3], ref[3])
    assert all(torch.equal(a, b) for a, b in zip(got, again))

    # What the scene holds: empty tiles and segments of many batches; pixels
    # that stop (walk fewer pairs than their tile holds) within 32 pairs;
    # live pixels in the cut last tile column and row.
    seg = end - start
    assert bool((seg == 0).any()) and int(seg.max()) > 4 * 32
    seg_px = untile(seg.reshape(v, -1, 1, 1).expand(-1, -1, tile * tile, 1), geo["tiles_x"],
                    geo["tiles_y"], tile, w, h)[:, 0]
    assert bool(((n_eval > 0) & (n_eval <= 32) & (n_eval < seg_px)).any())
    assert bool((got[3][:, :, w - 1] >= 0).any()) and bool((got[3][:, h - 1, :] >= 0).any())

    if tile in BWD_TILES:
        rng = np.random.default_rng(tile * 10 + channels)
        t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
        cot = (t(rng.normal(size=(v, channels, h, w))), t(rng.normal(size=(v, h, w))),
               t(rng.normal(size=(v, h, w))))
        rows = bwd(*kin, got[2], got[3], *cot, **geo)
        torch.cuda.synchronize()
        ref_rows = bwd_plain(*kin, got[2], got[3], *cot, **geo)
        assert torch.isfinite(rows).all() and rows.abs().max() > 0
        assert row_scaled_err(rows, ref_rows) <= 1e-4


def test_stage1_dual_step_cuda_matches_plain(cuda):
    """One stage-1 iteration over 2 views (``render_dual``: one binning, an
    image and a segmentation composite; image + 3 x segmentation loss)
    through K1, K2 and the routing against the plain versions: losses 1e-5
    relative, images 2e-5, ``last`` identical, every parameter's gradient
    and the means2d_offset collector's 1e-4 scaled per row; two launches
    of each kernel per step; two CUDA runs bitwise identical."""
    import splatpu_torch.render.route as route
    from splatpu_torch.core.types import cloud_from_arrays
    from splatpu_torch.tools.measure import row_scaled_err
    from splatpu_torch.train.optim import Stage1Adam
    from splatpu_torch.train.stage1 import Stage1Config, Stage1Steps

    rng = np.random.default_rng(23)
    n, views, w, h = 1500, 3, 96, 64
    q = rng.normal(size=(n, 4))
    fg = (rng.uniform(size=n) < 0.6).astype(np.float32)
    cloud = cloud_from_arrays(
        means=rng.uniform(-1, 1, (n, 3)), colors=rng.uniform(0, 1, (n, 3)),
        segmentation_masks=np.stack([fg, 0 * fg, 1 - fg], -1),
        rotation_quaternions=q / np.linalg.norm(q, axis=1, keepdims=True),
        opacity_logits=rng.uniform(-1, 4, (n, 1)),
        log_scales=np.log(rng.uniform(0.02, 0.15, (n, 3))), capacity=2048, device=cuda)
    _, cams = scene(23, 8, views, w, h, 3, cuda)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    staged = (cams.w2c, cams.K, t(rng.uniform(size=(views, 3, h, w))),
              t(rng.uniform(size=(views, 3, h, w))))
    binning = BinningConfig(tile=32, max_span=256, max_pairs=1 << 17, chunk_pairs=256)
    pick = torch.tensor([2, 0], device=cuda)
    runs = []
    for impl in ("cuda", "cuda", "plain"):
        steps = Stage1Steps(Stage1Config(renderer=impl), 4.0, staged, w, h,
                            Stage1Adam(cloud.param_dict()))
        before = (composite.LAUNCHES, composite.BWD_LAUNCHES, route.LAUNCHES)
        runs.append(steps.forward_backward(cloud, pick, binning))
        torch.cuda.synchronize()
        after = (composite.LAUNCHES, composite.BWD_LAUNCHES, route.LAUNCHES)
        assert [a - b for a, b in zip(after, before)] == ([2, 2, 2] if impl == "cuda"
                                                          else [0, 0, 0])
    got, again, ref = runs
    assert float(got.total) == pytest.approx(float(ref.total), rel=1e-5)
    for a, b in ((got.image, ref.image), (got.segmentation, ref.segmentation)):
        assert float((a.image - b.image).abs().max()) <= 2e-5
        assert torch.equal(a.last_contributor, b.last_contributor)
    assert float(got.offset_grad.abs().max()) > 0
    assert row_scaled_err(got.offset_grad, ref.offset_grad) <= 1e-4
    assert torch.equal(got.offset_grad, again.offset_grad)
    for k, g in got.grads.items():
        assert torch.isfinite(g).all(), k
        assert row_scaled_err(g, ref.grads[k]) <= 1e-4, k
        assert torch.equal(g, again.grads[k]), k


def test_camera_sharded_training_on_two_gloo_ranks(cuda, tmp_path):
    """``stage2.train(mesh_cameras=2)`` as two gloo ranks sharing the card
    (``dist.launch``), against the single-process run on the card: every
    step's loss 1e-5 relative, the parameters within 2e-2 of how far they
    moved, both ranks' parameters bitwise equal, K1, K2 and the routing
    once per step in each rank, and no rank importing JAX."""
    from splatpu_torch.data.synthetic import lookat_matrices
    from splatpu_torch.dist import ranks
    from splatpu_torch.dist.launch import launch
    from splatpu_torch.core import prng
    from splatpu_torch.dynamics.network import init_deformation_net
    from splatpu_torch.train.stage2 import Stage2Config

    rng = np.random.default_rng(31)
    n, w, h = 3000, 128, 96
    q = rng.normal(size=(n, 4)).astype(np.float32)
    fg = (rng.uniform(size=n) < 0.6).astype(np.float32)
    cloud = dict(means=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
                 colors=rng.uniform(0, 1, (n, 3)).astype(np.float32),
                 segmentation_masks=np.stack([fg, 0 * fg, 1 - fg], -1),
                 rotation_quaternions=q / np.linalg.norm(q, axis=1, keepdims=True),
                 opacity_logits=rng.uniform(-1, 4, (n, 1)).astype(np.float32),
                 log_scales=np.log(rng.uniform(0.02, 0.1, (n, 3))).astype(np.float32),
                 alive=np.ones(n, bool))
    views = [[dict(camera_index=c, w2c=m[0], K=m[1], width=w, height=h,
                   image=rng.uniform(size=(3, h, w)).astype(np.float32),
                   segmentation=np.zeros((3, h, w), np.float32))
              for c, m in enumerate(lookat_matrices((3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)),
                                                    width=w, height=h)
                                    for a in np.linspace(0, 2 * np.pi, 6, endpoint=False))]
             for _t in range(2)]
    cfg = dict(total_iterations=2, warmup_iterations=1, hidden_dim=64, residual_blocks=2,
               views_per_step=5, timestep_count=2, renderer="cuda", overflow_check_every=1)
    single = ranks.train_on_rank(cloud, views, cfg, device="cuda")["runs"][0]
    got = launch(ranks.train_on_rank, 2, (cloud, views, dict(cfg, mesh_cameras=2), "cuda"),
                 tmp_path, device="cuda", timeout_s=300)
    init = init_deformation_net(prng.key(0), Stage2Config(**cfg).net_config(),
                                device="cpu").state_dict()
    runs = [r["runs"][0] for r in got]
    assert all(r["jax_modules"] == [] for r in got)
    for (_, a), (_, b) in zip(single["rows"], runs[0]["rows"]):
        assert b["total"] == pytest.approx(a["total"], rel=1e-5)
    for k, v in single["params"].items():
        moved = float(np.abs(v - init[k].numpy()).max())
        assert float(np.abs(runs[0]["params"][k] - v).max()) <= 2e-2 * moved, k
        assert np.array_equal(runs[1]["params"][k], runs[0]["params"][k]), k
    for run in runs:
        assert [run["counts"][k] for k in ("composite_fwd", "composite_bwd", "route_pairs")] == [4] * 3


# The projection kernel (csrc/project.cu) against its plain version; on
# the training cells' clouds and at the fit's shape bit for bit.
TRAINING_PROJECTIONS = [CLOUD100K, "cloud250k", "fit250k"]
PROJECTION_CASES = ["fixture", "offset_shared", "offset_per_view", "strip", "rig100k",
                    *TRAINING_PROJECTIONS]


def projection_case(name, device):
    """(RenderArgs, camera, binning) on ``device``: ``_np_scenes``' cloud
    (dead slots: opacity 0) under 3 look-at views at 96x64, with a shared
    or per-view ``means2d_offset``, or as 2 strips' views (rows 32-63 of a
    96x96 image); or 100,000 random Gaussians, some behind the cameras,
    under the first 5 rig views at 1280x720; or ``training_scene``, or
    config 4's 250,000-Gaussian truth under the same views; or the fit's
    shape: that truth in 500,224 slots under one rig view with a (1, N, 2)
    offset collector."""
    import dataclasses

    from _np_scenes import np_cloud, np_lookat
    from splatpu_torch.io.checkpoint import load_cloud
    from splatpu_torch.render.api import demand_binning, measure_binning_demand

    if name == CLOUD100K:
        args, cam = training_scene(device)
        return args, cam, demand_binning(*measure_binning_demand(args, cam))
    if name in TRAINING_PROJECTIONS:
        truth = load_cloud(ROOT / "runs" / "acceptance_truth" / "truth_n250000.npz", device=device)
        cam = rig_camera(1 if name == "fit250k" else 5, device)
        if name == "fit250k":
            cloud = tt.cloud_from_arrays(**truth.param_dict(), capacity=500_224, device=device)
            args = dataclasses.replace(tt.activate_cloud(cloud), means2d_offset=torch.zeros(
                (1, cloud.capacity, 2), device=device))
        else:
            args = tt.activate_cloud(truth)
        return args, cam, demand_binning(*measure_binning_demand(args, cam))
    w, h, fov, row0 = 96, 64, None, 0
    eyes = [(3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)) for a in (0.0, 1.1, 2.6)]
    if name == "rig100k":
        c = np_cloud(41, 100_000, extent=3.0, scale_range=(0.005, 0.05), n_dead=1000)
        cam = rig_camera(5, device)
    else:
        if name == "strip":
            c = np_cloud(42, 3000, extent=1.5, n_dead=100)
            h, fov, row0 = 32, (96, 96), 32
            cams = [np_lookat(e, 96, 96) for e in eyes[:2]]
        else:
            c = np_cloud(43, 3000, extent=1.5, n_dead=100)
            cams = [np_lookat(e, w, h) for e in eyes]
        cam = tt.Camera(w2c=torch.from_numpy(np.stack([x[0] for x in cams])).to(device),
                        K=torch.from_numpy(np.stack([x[1] for x in cams])).to(device), width=w,
                        height=h, fov_width=fov and fov[0], fov_height=fov and fov[1],
                        row_offset=row0)
    cloud = tt.GaussianCloud(**{k: torch.from_numpy(np.array(v)) for k, v in c.items()})
    args = tt.activate_cloud(cloud.to(device))
    rng = np.random.default_rng(len(name))
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
    if name == "offset_shared":
        args.means2d_offset = t(rng.normal(size=(args.n, 2)) * 1e-3)
    if name == "offset_per_view":
        args.means2d_offset = t(rng.normal(size=(cam.num_views, args.n, 2)) * 1e-3)
    if name == "rig100k":
        binning = demand_binning(*measure_binning_demand(args, cam))
    else:
        binning = BinningConfig(tile=16, max_span=256, max_pairs=1 << 18)
    return args, cam, binning


def ulp_gap(a, b) -> int:
    """The largest distance of two float32 tensors in units in the last
    place (over zero too: the bit patterns mapped to ordered integers)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max())


@pytest.mark.parametrize("name", PROJECTION_CASES)
def test_projection_kernel_matches_plain(cuda, name):
    """The forward kernel against ``preprocess`` + the table pack on the
    card: radius and visibility identical, so the binning's gid, start and
    end are; mean2d, conic and depth within 1 ulp, identical on the
    ``TRAINING_PROJECTIONS`` (the largest gap is printed); the masked
    opacity and colours identical; two launches bitwise identical, one
    launch each."""
    import splatpu_torch.render.exact as exact
    import splatpu_torch.render.project as project

    args, cams, binning = projection_case(name, cuda)
    before = project.LAUNCHES
    got = project.project_views_cuda(args, cams)
    again = project.project_views_cuda(args, cams)
    torch.cuda.synchronize()
    assert project.LAUNCHES == before + 2
    table, radius, visible = got
    ref_table, ref_radius, ref_visible = project.project_views_plain(args, cams)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert torch.equal(visible, ref_visible)
    assert torch.equal(radius, ref_radius)
    # Every Gaussian of the training cells' clouds is in view.
    assert bool(visible.any()) and (name in (CLOUD100K, "cloud250k") or not bool(visible.all()))
    gaps = {col: ulp_gap(table[..., i], ref_table[..., i])
            for i, col in enumerate(("mean2d_x", "mean2d_y", "conic_a", "conic_b", "conic_c"))}
    gaps["depth"] = ulp_gap(table[..., 6], ref_table[..., 6])
    print(f"projection {name}: largest ulp gaps {gaps}; values differing "
          f"{int((table[..., :7] != ref_table[..., :7]).sum())} of {table[..., :7].numel()}")
    assert max(gaps.values()) <= (0 if name in TRAINING_PROJECTIONS else 1), gaps
    assert torch.equal(table[..., 5], ref_table[..., 5])
    assert torch.equal(table[..., 7:], ref_table[..., 7:])
    streams = exact.bin_projected(args, cams, binning, table, radius, visible)
    for s, r in zip(streams, exact.bin_views(args, cams, binning)):
        for f in ("gid", "start", "end", "lane", "offsets", "counts", "total_pairs"):
            assert torch.equal(getattr(s, f), getattr(r, f)), f


@pytest.mark.parametrize("name", PROJECTION_CASES)
def test_projection_backward_matches_autograd(cuda, name):
    """The backward kernel (through ``ProjectViews``) against autograd
    through the plain forward on the card, for a random d(table): within
    2e-5 of each gradient's largest value, column by column.  Float32 sums
    in another order: the views summed in order in one thread, the 3D
    covariance's gradient summed over the views before it goes back through
    R(q) and s, FMAs.  Two runs bitwise identical; one launch per backward."""
    import splatpu_torch.render.project as project

    args, cams, _ = projection_case(name, cuda)
    names = [f for f in project.GRAD_NAMES if getattr(args, f) is not None]
    d_table = None
    grads = []
    for impl in ("cuda", "cuda", "plain"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True) for f in names}
        largs = tt.RenderArgs(**leaves)
        if impl == "cuda":
            table = project.project_views(largs, cams)[0]
        else:
            table = project.project_views_plain(largs, cams)[0]
        if d_table is None:
            rng = np.random.default_rng(5)
            d_table = torch.tensor(rng.normal(size=table.shape).astype(np.float32), device=cuda)
        before = project.BWD_LAUNCHES
        grads.append(torch.autograd.grad((table * d_table).sum(), list(leaves.values())))
        assert project.BWD_LAUNCHES == before + (impl == "cuda")
    got, again, ref = grads
    errs = {f: row_scaled_err(a, b) for f, a, b in zip(names, got, ref)}
    print(f"projection {name}: backward column-scaled errors {errs}")
    for f, a, b, c in zip(names, got, again, ref):
        assert torch.isfinite(a).all() and float(c.abs().max()) > 0, f
        assert torch.equal(a, b), f
        assert errs[f] <= 2e-5, f


def test_render_makes_one_projection_launch_each_way(cuda):
    """``render(impl="cuda")`` and ``render_dual(impl="cuda")``: one forward
    and one backward launch of the projection kernel for all views (both
    tables of the dual render in the same launches); ``impl="plain"``:
    none."""
    import splatpu_torch.render.project as project
    from splatpu_torch.render.api import render, render_dual

    args, cams, binning = projection_case("offset_per_view", cuda)
    for dual in (False, True):
        for impl, expected in (("cuda", (1, 1)), ("plain", (0, 0))):
            leaves = {f: getattr(args, f).clone().requires_grad_(True)
                      for f in project.GRAD_NAMES}
            largs = tt.RenderArgs(**leaves)
            before = (project.LAUNCHES, project.BWD_LAUNCHES)
            if dual:
                out, seg = render_dual(largs, leaves["colors"].flip(1), cams, impl=impl,
                                       config=binning)
                loss = out.image.square().mean() + seg.image.abs().mean()
            else:
                loss = render(largs, cams, impl=impl, config=binning).image.square().mean()
            loss.backward()
            torch.cuda.synchronize()
            assert (project.LAUNCHES - before[0], project.BWD_LAUNCHES - before[1]) == expected


@pytest.mark.parametrize("name", PROJECTION_CASES)
def test_projection_dual_launch_keeps_the_single_launchs_table(cuda, name):
    """The launch with a second colour set (``render_dual``'s): its table,
    radius and visibility bitwise the single launch's, its second table the
    same first seven columns with the second colours.  Its backward of both
    tables against the plain analytic backward within 2e-5 of each
    gradient's largest value, column by column, two runs bitwise identical,
    one launch each way; ``means2d_offset``'s gradient bitwise the single
    backward's of the first table's cotangent alone."""
    import splatpu_torch.render.project as project

    args, cams, _ = projection_case(name, cuda)
    colors_b = args.colors.flip(1).contiguous()
    before = (project.LAUNCHES, project.BWD_LAUNCHES)
    single = project.project_views_cuda(args, cams)
    dual = project.project_views_cuda(args, cams, colors_b)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(single, dual[:3]))
    assert torch.equal(dual[3][..., :7], dual[0][..., :7])
    assert torch.equal(dual[3][..., 7:], colors_b.expand(cams.num_views, -1, -1))
    rng = np.random.default_rng(5)
    d_table, d_table_b = (torch.tensor(rng.normal(size=x.shape).astype(np.float32), device=cuda)
                          for x in (dual[0], dual[3]))
    needs = [getattr(args, f) is not None for f in project.GRAD_NAMES] + [True]
    got, again = (project.project_views_bwd_cuda(d_table, args, cams, dual[2], needs, d_table_b)
                  for _ in range(2))
    torch.cuda.synchronize()
    assert (project.LAUNCHES - before[0], project.BWD_LAUNCHES - before[1]) == (2, 2)
    ref = project.project_views_bwd_plain(d_table, args, cams, dual[2], needs, d_table_b)
    names = (*project.GRAD_NAMES, "colors_b")
    errs = {f: row_scaled_err(a, b) for f, a, b in zip(names, got, ref) if a is not None}
    print(f"projection {name}, dual: backward column-scaled errors {errs}")
    for f, a, b in zip(names, got, again):
        if a is not None:
            assert torch.isfinite(a).all() and torch.equal(a, b), f
            assert errs[f] <= 2e-5, f
    if args.means2d_offset is not None:
        alone = project.project_views_bwd_cuda(d_table, args, cams, dual[2], needs[:6])
        assert torch.equal(got[5], alone[5])


def test_projection_dual_backward_moves_no_isotropic_rotation(cuda):
    """Isotropic Gaussians with identity quaternions (stage 1's initial
    cloud): the dual backward's rotation gradient exactly zero, as
    autograd's through the plain path, so Adam takes no step on
    round-off."""
    import dataclasses

    import splatpu_torch.render.project as project

    args, cams, _ = projection_case("offset_per_view", cuda)
    iso = dataclasses.replace(
        args, rotations=torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=cuda).expand(
            args.n, 4).contiguous(), scales=args.scales[:, :1].expand(args.n, 3).contiguous())
    table, _, visible, table_b = project.project_views_cuda(iso, cams, iso.colors.flip(1))
    rng = np.random.default_rng(13)
    d_table, d_table_b = (torch.tensor(rng.normal(size=x.shape).astype(np.float32), device=cuda)
                          for x in (table, table_b))
    needs = [False, True, True, False, False, False, False]
    got = project.project_views_bwd_cuda(d_table, iso, cams, visible, needs, d_table_b)
    assert not bool(got[2].any()) and float(got[1].abs().max()) > 0


def test_render_dual_cuda_matches_plain_at_the_fit_shape(cuda):
    """Stage 1's render at the fit cell's shape (every third Gaussian of
    config 4's truth in 500,224 slots, one 1280x720 rig view, 32 px tiles at
    ``max_span`` 32, a (1, N, 2) offset collector; targets rendered from the
    means moved by N(0, 0.005^2)) under ``impl="cuda"`` (one projection
    launch each way for both tables, K1/K2, the routing) against
    ``impl="plain"``: radii, pairs and overflow flags identical, both
    images within 2e-5, the loss within 1e-5 relative, every gradient
    within 1e-4 of its largest value, column by column; the densify
    statistics' visible counts and radii identical, and one mutation at the
    fit's constants from each run's statistics gives the same integers."""
    import dataclasses
    from pathlib import Path

    import splatpu_torch.render.project as project
    from splatpu_torch.core import prng
    from splatpu_torch.core.types import activate_cloud, cloud_from_arrays
    from splatpu_torch.growth.densify import (
        DensifyConfig,
        accumulate_stats_batch,
        densify_and_prune,
        init_stats,
    )
    from splatpu_torch.io.checkpoint import load_cloud
    from splatpu_torch.render.api import render_dual
    from splatpu_torch.train.losses import SEGMENTATION_WEIGHT, image_losses
    from splatpu_torch.train.optim import Stage1Adam
    from splatpu_torch.train.stage1 import split_normals

    root = Path(__file__).resolve().parents[1]
    truth = load_cloud(root / "runs" / "acceptance_truth" / "truth_n250000.npz", device=cuda)
    third = {k: v[::3] for k, v in truth.param_dict().items()}
    cloud = cloud_from_arrays(**third, capacity=500_224, device=cuda)
    cam = rig_camera(1, cuda)
    binning = BinningConfig(tile=32, max_span=32, span_small=16, max_pairs=2_000_896)
    jitter = torch.from_numpy(np.random.default_rng(1).normal(
        0.0, 0.005, tuple(cloud.means.shape)).astype(np.float32)).to(cuda)
    with torch.no_grad():
        target, seg_target = (o.image for o in render_dual(
            activate_cloud(cloud.replace(means=cloud.means + jitter)),
            cloud.segmentation_masks, cam, impl="plain", config=binning))
    runs = {}
    for impl in ("cuda", "plain"):
        params = {k: p.clone().requires_grad_(True) for k, p in cloud.param_dict().items()}
        offsets = torch.zeros((1, cloud.capacity, 2), device=cuda, requires_grad=True)
        c = cloud.replace(**params)
        args = dataclasses.replace(activate_cloud(c), means2d_offset=offsets)
        before = (project.LAUNCHES, project.BWD_LAUNCHES)
        out, seg = render_dual(args, c.segmentation_masks, cam, impl=impl, config=binning)
        total = (image_losses(out.image, target)
                 + SEGMENTATION_WEIGHT * image_losses(seg.image, seg_target)).mean()
        grads = torch.autograd.grad(total, [*params.values(), offsets])
        torch.cuda.synchronize()
        launches = (project.LAUNCHES - before[0], project.BWD_LAUNCHES - before[1])
        assert launches == ((1, 1) if impl == "cuda" else (0, 0)), launches
        stats = accumulate_stats_batch(init_stats(cloud.capacity, cuda), grads[-1],
                                       out.radii.detach())
        _, _, _, info = densify_and_prune(
            cloud, Stage1Adam(cloud.param_dict()), stats,
            split_normals(prng.key(5), cloud.capacity, cuda), 500, 4.4, DensifyConfig())
        runs[impl] = out, seg, float(total.detach()), dict(zip([*params, "offsets"], grads)), stats, {
            k: int(v) for k, v in info.items()}
    (a, sa, loss, ga, st_a, mut_a), (b, sb, ref_loss, gb, st_b, mut_b) = runs["cuda"], runs["plain"]
    for x, y in ((a, b), (sa, sb)):
        for f in ("radii", "total_pairs", "overflowed", "span_overflowed"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f
        assert float((x.image - y.image).abs().max()) <= 2e-5
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    errs = {k: row_scaled_err(g, gb[k]) for k, g in ga.items()}
    print(f"render_dual at the fit's shape: loss {loss} / {ref_loss}; gradient errors {errs};"
          f" mutation {mut_a} / {mut_b}")
    assert max(errs.values()) <= 1e-4, errs
    assert torch.equal(st_a.vis_count, st_b.vis_count)
    assert torch.equal(st_a.max_radii, st_b.max_radii)
    assert mut_a == mut_b and mut_a["cloned"] + mut_a["split"] > 0, (mut_a, mut_b)


def test_stage2_step_cuda_matches_plain_within_benchmark_limits(cuda):
    """One stage-2 step (deform, 3-view render, L1 + SSIM + rigidity,
    backward) through ``render(impl="cuda")`` (the projection kernel, K1,
    K2, the routing) against ``impl="plain"`` on the card: the loss's
    relative gap and the worst network leaf's gradient gap (|norm - norm|
    over the larger of the leaf's and the median leaf's norm) within the
    tightest of ``splatbench/limits/``' numbers for them."""
    import json
    import statistics

    import splatpu_torch.train.stage2 as ts2
    from _np_scenes import np_cloud, np_lookat

    root = Path(__file__).resolve().parents[1]
    limits = [json.loads(p.read_text())["limits"]
              for p in sorted((root / "splatbench" / "limits").glob("train.*.json"))]
    loss_limit = min(x["loss"] for x in limits)
    grad_limit = min(x["grad"] for x in limits)
    w, h = 96, 64
    binning = BinningConfig(tile=16, max_span=256, max_pairs=1 << 16)
    cams = [np_lookat((3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)), w, h) for a in (0.0, 0.9, 2.0)]
    w2c = torch.from_numpy(np.stack([c[0] for c in cams])).to(cuda)
    K = torch.from_numpy(np.stack([c[1] for c in cams])).to(cuda)
    images = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (3, 3, h, w))
                              .astype(np.float32)).to(cuda)
    cloud = tt.GaussianCloud(**{k: torch.from_numpy(np.array(v))
                                for k, v in np_cloud(7, 2000).items()})
    runs = {}
    for impl in ("cuda", "plain"):
        config = ts2.Stage2Config(total_iterations=1, warmup_iterations=0, hidden_dim=32,
                                  residual_blocks=1, views_per_step=3, timestep_count=1,
                                  renderer=impl, binning=binning)
        state = ts2.setup(cloud.to(cuda), config, device=cuda)
        enc, fg = ts2.snapshot_previous(state.cloud, state.fg_idx, state.neighbor_info)
        _, _, metrics = ts2.make_step(config, state, w, h)(enc, fg, 1.0, w2c, K, images, binning)
        runs[impl] = (float(metrics["total"]),
                      {n: p.grad.detach().clone() for n, p in state.net.named_parameters()})
    (loss, grads), (ref_loss, ref_grads) = runs["cuda"], runs["plain"]
    norm = lambda x: float(torch.linalg.vector_norm(x.double()))  # noqa: E731
    med = statistics.median(norm(g) for g in ref_grads.values())
    gaps = {k: abs(norm(grads[k]) - norm(g)) / max(norm(g), med) for k, g in ref_grads.items()}
    print(f"stage-2 step: loss {loss} / {ref_loss}, worst grad gap {max(gaps.values()):.3e}")
    assert abs(loss - ref_loss) / abs(ref_loss) <= loss_limit
    assert max(gaps.values()) <= grad_limit


def test_exact_binning_is_the_span_budget_binning_at_the_train_cells(cuda):
    """At both stage-2 cells' clouds (config 3's fitted cloud, config 4's
    truth) at the 27 rig cameras, through the projection kernel and under
    the budget stage 2 sizes from their demand, exact binning gives every
    integer of the JAX package's span budget (``clamp_span``, the binning
    the exact path had before it emitted wide splats whole): no splat is
    wider than ``max_span`` there, so the cells bin the same pairs, keys
    and order as before.  ``python -m splatpu_torch.tools.compare_binning
    OTHER_ROOT`` holds the same inputs against an earlier tree's code."""
    import dataclasses
    import types

    from splatpu_torch.render import exact
    from splatpu_torch.tools import compare_binning

    clamped = types.SimpleNamespace(_bin=lambda sp, op, w, h, cfg, key_tiles: exact._bin(
        sp, op, w, h, dataclasses.replace(cfg, clamp_span=True), key_tiles))
    for name in compare_binning.CLOUDS:
        row = compare_binning.compare(name, clamped, cuda)
        assert row["differ"] == [] and row["wider_than_max_span"] == 0, row
