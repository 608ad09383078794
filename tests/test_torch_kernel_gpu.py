"""The CUDA composite kernels (K1/K2, K4 under kernel="manual", K5 of the
padded path; forward and backward) and the routing kernel against their
plain PyTorch versions, on the card: the backward body at 16 and 32 px
tiles, 1 to 9 channels and image sizes that cut the last tiles; the
routing in both slot modes, 8 to 16 rows, slot runs up to 512, dropped and
clipped slots; each bitwise identical across two launches.

Needs an NVIDIA Hopper GPU and nvcc; skipped elsewhere.  Imports nothing of
JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernel_gpu.py

(``--noconftest``: tests/conftest.py configures JAX for the other tests.)
"""

import numpy as np
import pytest
import torch

import splatpu_torch.core.types as tt
import splatpu_torch.render.composite as composite
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.exact import composite_inputs
from splatpu_torch.tools.measure import row_scaled_err

pytestmark = pytest.mark.gpu


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


@pytest.mark.parametrize(
    "n,views,width,height,tile,channels",
    [(300, 1, 48, 32, 16, 3), (3000, 3, 100, 70, 32, 3), (1500, 2, 64, 64, 32, 1)],
)
def test_kernel_matches_plain(cuda, n, views, width, height, tile, channels):
    args, cams = scene(n, n, views, width, height, channels, cuda)
    cfg = BinningConfig(tile=tile, max_span=256, max_pairs=1 << 18, chunk_pairs=256)
    _, k = composite_inputs(args, cams, cfg)
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    before = composite.LAUNCHES
    got = composite.composite_fwd_cuda(k["table"], k["gid"], k["start"], k["end"], bg, **k["geometry"])
    torch.cuda.synchronize()
    assert composite.LAUNCHES == before + 1
    ref = composite.composite_fwd_plain(k["table"], k["gid"], k["start"], k["end"], bg, **k["geometry"])
    assert got[0].shape == (views, channels, height, width)
    for a, b, tol in zip(got[:3], ref[:3], (2e-5, 2e-4, 2e-5)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    assert float((got[3] == ref[3]).float().mean()) >= 0.9999
    assert bool((got[3] >= 0).any())


def scaled_err(a, b):
    return float((a - b).abs().max() / (b.abs().max() + 1e-12))


@pytest.mark.parametrize(
    "n,views,width,height,tile,channels",
    [(300, 1, 48, 32, 16, 3), (3000, 3, 100, 70, 32, 3), (1500, 2, 64, 64, 32, 1)],
)
def test_backward_kernels_match_plain(cuda, n, views, width, height, tile, channels):
    import splatpu_torch.render.route as route

    args, cams = scene(n + 1, n, views, width, height, channels, cuda)
    cfg = BinningConfig(tile=tile, max_span=256, max_pairs=1 << 18, chunk_pairs=256)
    streams, k = composite_inputs(args, cams, cfg)
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    kin = (k["table"], k["gid"], k["start"], k["end"], bg)
    _, _, tfin, last = composite.composite_fwd_cuda(*kin, **k["geometry"])
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
    assert torch.equal(rows, rows_again)

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
    assert torch.equal(d_table, d_again)


def test_render_gradients_cuda_match_plain(cuda):
    from splatpu_torch.render.api import render

    args, cams = scene(7, 2000, 2, 96, 64, 3, cuda)
    cfg = BinningConfig(tile=32, max_span=256, max_pairs=1 << 17, chunk_pairs=256)
    target = torch.full((2, 3, 64, 96), 0.4, device=cuda)
    grads = {}
    for impl in ("cuda", "plain"):
        leaves = {f: getattr(args, f).clone().requires_grad_(True)
                  for f in ("means3d", "colors", "rotations", "opacities", "scales")}
        out = render(tt.RenderArgs(**leaves), cams, bg=torch.full((3,), 0.2, device=cuda),
                     impl=impl, config=cfg)
        loss = (out.image - target).abs().mean() + 0.1 * out.depth.mean()
        loss.backward()
        grads[impl] = {f: x.grad for f, x in leaves.items()}
    for f, g in grads["cuda"].items():
        assert torch.isfinite(g).all(), f
        assert scaled_err(g, grads["plain"][f]) <= 1e-4, f


def manual_case(args, cams, channels, seed, cuda):
    """The exact stream at 16 px tiles with ``channels`` seeded colours, the
    K4 forward inputs, and random cotangents."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    args = tt.RenderArgs(args.means3d, t(rng.uniform(0, 1, (args.n, channels))), args.rotations,
                         args.opacities, args.scales)
    cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 18, chunk_pairs=256, kernel="manual")
    streams, k = composite_inputs(args, cams, cfg)
    v, h, w = cams.num_views, cams.height, cams.width
    cot = (t(rng.normal(size=(v, channels, h, w))), t(rng.normal(size=(v, h, w))),
           t(rng.normal(size=(v, h, w))))
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    return streams, (k["table"], k["gid"], k["start"], k["end"], bg), k["geometry"], cot


@pytest.mark.parametrize("channels", [3, 9])
def test_manual_kernels_match_plain(cuda, channels):
    args, cams = scene(11, 2500, 2, 96, 64, 3, cuda)
    _, kin, geo, cot = manual_case(args, cams, channels, channels, cuda)
    before = (composite.MANUAL_LAUNCHES, composite.MANUAL_BWD_LAUNCHES)
    got = composite.composite_manual_fwd_cuda(*kin, **geo)
    torch.cuda.synchronize()
    ref = composite.composite_manual_fwd_plain(*kin, **geo)
    assert got[0].shape == (2, channels, 64, 96)
    for a, b, tol in zip(got[:3], ref[:3], (2e-5, 2e-4, 2e-5)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    assert torch.equal(got[3], ref[3]) and bool((got[3] >= 0).any())
    rows = composite.composite_manual_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    again = composite.composite_manual_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    torch.cuda.synchronize()
    assert (composite.MANUAL_LAUNCHES, composite.MANUAL_BWD_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 2)
    ref_rows = composite.composite_manual_bwd_plain(*kin, got[2], got[3], *cot, **geo)
    assert rows.shape == (2, kin[1].shape[1], 7 + channels)
    assert torch.isfinite(rows).all() and rows.abs().max() > 0
    assert scaled_err(rows, ref_rows) <= 1e-4
    assert torch.equal(rows, again)


def padded_case(args, cams, channels, seed, cuda):
    """The padded stream of every view at 16 px tiles with ``channels``
    seeded colours, K5's inputs (records gathered by gid), and random
    cotangents."""
    from splatpu_torch.render.binning import build_pair_stream
    from splatpu_torch.render.composite import pack_table

    rng = np.random.default_rng(seed)
    t = lambda a: torch.tensor(np.asarray(a, np.float32), device=cuda)  # noqa: E731
    args = tt.RenderArgs(args.means3d, t(rng.uniform(0, 1, (args.n, channels))), args.rotations,
                         args.opacities, args.scales)
    cfg = BinningConfig(tile=16, max_span=256, max_pairs=1 << 17, chunk_pairs=128)
    streams = [build_pair_stream(args, cams.view(i), cfg) for i in range(cams.num_views)]
    records = torch.stack([
        pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth, s.g_colors)
        [s.gid.long()] for s in streams]).contiguous()
    v, h, w = cams.num_views, cams.height, cams.width
    geo = dict(tiles_x=-(-w // 16), tiles_y=-(-h // 16), width=w, height=h)
    cot = (t(rng.normal(size=(v, channels, h, w))), t(rng.normal(size=(v, h, w))),
           t(rng.normal(size=(v, h, w))))
    bg = torch.linspace(0.1, 0.3, channels, device=cuda)
    start = torch.stack([s.start for s in streams])
    end = torch.stack([s.end for s in streams])
    return (records, start, end, bg), geo, cot


@pytest.mark.parametrize("channels", [3, 9])
def test_padded_kernels_match_plain(cuda, channels):
    import splatpu_torch.render.padded as padded

    args, cams = scene(12, 2500, 2, 100, 70, 3, cuda)
    kin, geo, cot = padded_case(args, cams, channels, channels + 1, cuda)
    before = (padded.LAUNCHES, padded.BWD_LAUNCHES)
    got = padded.padded_fwd_cuda(*kin, **geo)
    torch.cuda.synchronize()
    ref = padded.padded_fwd_plain(*kin, **geo)
    for a, b, tol in zip(got[:3], ref[:3], (2e-5, 2e-4, 2e-5)):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= tol
    assert torch.equal(got[3], ref[3]) and bool((got[3] >= 0).any())
    rows = padded.padded_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    again = padded.padded_bwd_cuda(*kin, got[2], got[3], *cot, **geo)
    torch.cuda.synchronize()
    assert (padded.LAUNCHES, padded.BWD_LAUNCHES) == (before[0] + 1, before[1] + 2)
    ref_rows = padded.padded_bwd_plain(*kin, got[2], got[3], *cot, **geo)
    assert torch.isfinite(rows).all() and rows.abs().max() > 0
    assert scaled_err(rows, ref_rows) <= 1e-4
    assert torch.equal(rows, again)


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


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
@pytest.mark.parametrize("r", [8, 10, 16])
def test_routing_modes_match_plain(cuda, padded, r):
    import splatpu_torch.render.route as route

    rows, slot_map, offsets, counts = routing_case(padded, r, r + 100 * padded, cuda)
    before = route.LAUNCHES
    got = route.route_pairs_cuda(rows, slot_map, offsets, counts, padded=padded)
    again = route.route_pairs_cuda(rows, slot_map, offsets, counts, padded=padded)
    torch.cuda.synchronize()
    assert route.LAUNCHES == before + 2
    ref = route.route_pairs_plain(rows, slot_map, offsets, counts, padded=padded)
    assert got.shape == (2, 3000, r) and torch.isfinite(got).all()
    assert row_scaled_err(got, ref) <= 1e-5
    assert torch.equal(got, again)
    # Long runs inside the slot map were summed, and slots run past it.
    ends = offsets.long() + counts.long()
    long_inside = (counts >= 100) & (ends <= slot_map.shape[1])
    assert bool(long_inside.any()) and bool((got[long_inside] != 0).all())
    assert bool((ends > slot_map.shape[1]).any())


BWD_CASES = [("composite_bwd", 16, c) for c in (1, 3, 5)] + [
    ("composite_bwd", 32, c) for c in (1, 3, 5)] + [
    ("composite_manual_bwd", t, c) for t in (16, 32) for c in (1, 3, 5, 9)] + [
    ("padded_bwd", 16, c) for c in (1, 3, 5, 9)]


@pytest.mark.parametrize("kernel,tile,channels", BWD_CASES)
def test_backward_body_matches_plain(cuda, kernel, tile, channels):
    """Each backward kernel against its plain version on 100x70 images
    (neither tile size divides them), rows 1e-4 scaled per row, bitwise
    identical across two launches."""
    import splatpu_torch.render.padded as padded
    from splatpu_torch.render.binning import build_pair_stream
    from splatpu_torch.render.composite import pack_table

    rng = np.random.default_rng(tile * 10 + channels)
    args, cams = scene(tile + channels, 2500, 2, 100, 70, 3, cuda)
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
