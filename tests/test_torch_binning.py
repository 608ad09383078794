"""Exact binning: the port's bin_splats fed the JAX package's own Splats2D must
give identical integers (gid, start, end, lane, offsets, counts, total_pairs
and both overflow flags)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import splatpu.core.types as jt
from splatpu.render.binning import BinningConfig as JBinningConfig
from splatpu.render.exact import build_exact_stream
from splatpu_torch.core.projection import Splats2D
from splatpu_torch.render.binning import BinningConfig, _depth_bits_for
from splatpu_torch.render.exact import bin_splats
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of

torch.set_num_threads(1)
# One compiled program per shape instead of eager op-by-op dispatch.
jax_build_exact_stream = jax.jit(build_exact_stream, static_argnums=2)

FIELDS = ("gid", "start", "end", "lane", "offsets", "counts", "total_pairs",
          "overflowed", "span_overflowed")


def check_identical(cloud, w, h, eye=(0.3, -0.2, -4.0), focal=None, **cfg):
    w2c, K = np_lookat(eye, w, h, focal)
    args = jt.activate_cloud(jax_cloud(cloud))
    ref = jax_build_exact_stream(args, jax_camera(w2c, K, w, h), JBinningConfig(**cfg))
    sp = ref.splats
    splats = Splats2D(
        mean2d=torch.from_numpy(np_of(sp.mean2d).copy()),
        depth=torch.from_numpy(np_of(sp.depth).copy()),
        conic=torch.from_numpy(np_of(sp.conic).copy()),
        radius=torch.from_numpy(np_of(sp.radius).copy()),
        visible=torch.from_numpy(np_of(sp.visible).copy()),
    )
    got = bin_splats(
        splats, torch.from_numpy(np_of(args.opacities)[:, 0].copy()), w, h,
        BinningConfig(**cfg),
    )
    for f in FIELDS:
        a, b = np_of(getattr(got, f)), np_of(getattr(ref, f))
        assert a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    return got, ref


def test_small_scene():
    got, _ = check_identical(np_cloud(0, 300), 96, 64, tile=16, max_span=64, max_pairs=4096)
    assert int(got.total_pairs) > 0 and not bool(got.overflowed)


def test_720p_grid_key_above_2_31():
    # 40 x 23 = 920 tiles at 32 px leave 22 depth bits: tile ids >= 512 put the
    # u32 key at or above 2^31, where a naive int64 (key << 32 | val) wraps.
    assert _depth_bits_for(920) == 22
    cloud = np_cloud(1, 3000, extent=1.6, scale_range=(0.01, 0.05))
    got, _ = check_identical(cloud, 1280, 720, eye=(0.0, 0.0, -3.0), focal=0.82 * 1280,
                             tile=32, max_span=64, max_pairs=1 << 15, chunk_pairs=256)
    gid, end = np_of(got.gid), np_of(got.end)
    assert end[-1] > 0 and end[500:].max() > 0, "no pairs in the upper tiles"
    assert gid.shape == (1 << 15,)


@pytest.mark.parametrize("cull", [True, False])
def test_two_class_split_and_cull(cull):
    cloud = np_cloud(2, 200, scale_range=(0.02, 0.4), opacity_range=(-4.0, 3.0))
    got, _ = check_identical(cloud, 96, 64, tile=16, span_small=4, max_span=64,
                             max_pairs=1 << 13, cull_tiles=cull)
    assert int((np_of(got.counts) > 4).sum()) > 0, "no Gaussian took the big class"


def test_single_class():
    check_identical(np_cloud(3, 150), 64, 48, tile=16, span_small=64, max_span=64,
                    max_pairs=4096)


def test_pair_budget_overflow():
    got, _ = check_identical(np_cloud(4, 300), 96, 64, tile=16, max_span=64, max_pairs=256)
    assert bool(got.overflowed) and not bool(got.span_overflowed)


def test_span_and_big_capacity_overflow():
    cloud = np_cloud(5, 120, scale_range=(0.1, 0.5))
    got, _ = check_identical(cloud, 96, 64, tile=16, span_small=2, max_span=8,
                             big_capacity=3, max_pairs=4096)
    assert bool(got.span_overflowed) and bool(got.overflowed)


def test_non_tile_aligned_image():
    check_identical(np_cloud(6, 250), 50, 37, tile=16, max_span=64, max_pairs=4096)


def test_empty_scene():
    cloud = np_cloud(7, 40)
    cloud["means"] = cloud["means"] - np.array([0.0, 0.0, 20.0], np.float32)  # behind
    got, _ = check_identical(cloud, 48, 32, tile=16, max_span=64, max_pairs=4096)
    assert int(got.total_pairs) == 0
    assert np.all(np_of(got.start) == 0) and np.all(np_of(got.end) == 0)


def test_ties_without_gid_order():
    # Pairs equal in (tile, depth) carry no order of their own: the fused sort
    # must break the tie by gaussian id and lane, as the reference does.
    cloud = np_cloud(8, 200)
    cloud["means"][100:] = cloud["means"][:100]  # exact depth ties
    check_identical(cloud, 64, 64, tile=16, max_span=64, max_pairs=4096)


def tie_cloud():
    """Wide Gaussians (the big class at span_small=4) and small ones in
    pairs at one mean, the small one of the higher id: equal (tile, depth)
    keys whose gaussian-id order (class B's wide one first) and emission
    order (class A's small one first) disagree."""
    cloud = np_cloud(12, 160, scale_range=(0.02, 0.05))
    cloud["log_scales"][:80] = np.log(np.float32(0.3))
    cloud["means"][80:] = cloud["means"][:80]
    return cloud


def test_ties_in_emission_order_without_exact_tie_order():
    """exact_tie_order=False: a stable sort on the key alone, as the JAX
    package's num_keys=1 sort; every integer identical to JAX's, and the
    order differs there from the gid-broken one."""
    cfg = dict(tile=16, span_small=4, max_span=64, max_pairs=1 << 13)
    emitted, _ = check_identical(tie_cloud(), 96, 64, exact_tie_order=False, **cfg)
    by_gid, _ = check_identical(tie_cloud(), 96, 64, exact_tie_order=True, **cfg)
    assert int((np_of(emitted.counts) > 4).sum()) > 0, "no Gaussian took the big class"
    for f in ("start", "end", "offsets", "counts"):
        np.testing.assert_array_equal(np_of(getattr(emitted, f)), np_of(getattr(by_gid, f)))
    moved = np_of(emitted.gid) != np_of(by_gid.gid)
    assert moved.sum() >= 2, "no tie whose order the flag changes"


def test_exact_tie_order_through_overrides():
    """The flag reaches the binning the trainers and the server build from
    ``binning_overrides``."""
    from splatpu_torch.render.api import demand_binning, resolve_binning

    ov = {"exact_tie_order": False, "tile": 48}
    for b in (resolve_binning(5000, overrides=ov), demand_binning(20000, 9, overrides=ov)):
        assert b.exact_tie_order is False and b.tile == 48


@pytest.mark.parametrize("tile", [48, 64])
def test_large_tile_budgets_and_integers_match_jax(tile):
    """At 48 and 64 px on a 1280x720 camera: default_config's and
    demand_binning's budgets, the depth-bit split and the binning integers
    at the default budget, each as JAX's."""
    from splatpu.render.api import default_config as jax_default_config
    from splatpu.render.api import demand_binning as jax_demand_binning
    from splatpu.render.binning import _depth_bits_for as jax_depth_bits_for
    from splatpu.render.binning import tile_grid as jax_tile_grid
    from splatpu_torch.render.api import default_config, demand_binning
    from splatpu_torch.render.binning import depth_key_tiles
    from _torch_scenes import torch_camera

    n = 3000
    for got, ref in ((default_config(n, tile=tile), jax_default_config(n, tile=tile)),
                     (demand_binning(421000, 37, tile=tile),
                      jax_demand_binning(421000, 37, tile=tile))):
        for f in dataclasses.fields(got):
            assert getattr(got, f.name) == getattr(ref, f.name), f.name
    w2c, K = np_lookat((0.0, 0.0, -3.0), 1280, 720, 0.82 * 1280)
    tx, ty = jax_tile_grid(jax_camera(w2c, K, 1280, 720), tile)
    bits = _depth_bits_for(depth_key_tiles(torch_camera(w2c, K, 1280, 720), tile))
    assert bits == jax_depth_bits_for(tx * ty) == (23 if tile == 48 else 24)
    cfg = dataclasses.asdict(default_config(n, tile=tile))
    cloud = np_cloud(1, n, extent=1.6, scale_range=(0.01, 0.05))
    got, _ = check_identical(cloud, 1280, 720, eye=(0.0, 0.0, -3.0), focal=0.82 * 1280, **cfg)
    # At 48 px this scene overflows the 4-per-Gaussian budget; the clipped
    # stream and the flags are held identical too.
    assert int(got.total_pairs) > 0
    assert np_of(got.end)[tx * ty // 2:].max() > 0, "no pairs in the lower tiles"


def test_config_fields_match_reference():
    # The port keeps the reference's defaults for every field it carries.
    ref = JBinningConfig()
    for f in dataclasses.fields(BinningConfig):
        assert getattr(BinningConfig(), f.name) == getattr(ref, f.name), f.name
    for n in (1, 100, 5000, 10**6):
        assert BinningConfig().resolved_big_capacity(n) == ref.resolved_big_capacity(n)


@pytest.mark.parametrize("n", [1, 2048, 100585, 10**6])
@pytest.mark.parametrize("tile", [16, 32])
def test_default_config_matches_jax(n, tile):
    from splatpu.render.api import default_config as jax_default_config
    from splatpu_torch.render.api import default_config

    got, ref = default_config(n, tile=tile), jax_default_config(n, tile=tile)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


@pytest.mark.parametrize("pairs,span", [(10, 1), (421000, 37), (9_000_000, 900), (3000, 300)])
def test_demand_binning_matches_jax(pairs, span):
    from splatpu.render.api import demand_binning as jax_demand_binning
    from splatpu_torch.render.api import demand_binning

    got, ref = demand_binning(pairs, span), jax_demand_binning(pairs, span)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(ref, f.name), f.name


def test_measure_binning_demand_matches_jax():
    from splatpu.render.api import measure_binning_demand as jax_measure
    from splatpu.train.inference import create_orbit_cameras as jax_orbit
    import splatpu_torch.core.types as tt
    from splatpu_torch.render.api import measure_binning_demand
    from splatpu_torch.train.inference import create_orbit_cameras
    from _torch_scenes import torch_cloud

    cloud = np_cloud(9, 500, extent=0.8)
    jcams = list(jax_orbit(160, 90).values())
    ref = jax_measure(jt.activate_cloud(jax_cloud(cloud)), jcams[0],
                      np.stack([np_of(c.w2c) for c in jcams]),
                      np.stack([np_of(c.K) for c in jcams]))
    cams = tt.stack_cameras(list(create_orbit_cameras(160, 90, device="cpu").values()))
    assert measure_binning_demand(tt.activate_cloud(torch_cloud(cloud)), cams) == ref


@pytest.mark.parametrize("far", [1.3e8, 1.3e10])
def test_far_off_screen_centres(far):
    # Centres ~1e10 px (far=1.3e8) and ~1e12 px (1.3e10, past the int32
    # range of floor(x / tile)) off screen on every side, one unit in front
    # of an axis-aligned camera, among ordinary splats.
    # The reference casts floor(x / tile) to int32 before clamping (undefined
    # past int32 range); the port clamps first.  Either way such a splat
    # covers no tile, so every binning integer must agree.
    cloud = np_cloud(10, 120)
    for i, d in enumerate([(far, 0, -3), (-far, 0, -3), (0, far, -3), (0, -far, -3),
                           (far, far, -3), (-far, -far, -3)]):
        cloud["means"][i] = np.asarray(d, np.float32)
    w2c, K = np_lookat((0.0, 0.0, -4.0), 96, 64)
    args = jt.activate_cloud(jax_cloud(cloud))
    sp = jax_build_exact_stream(args, jax_camera(w2c, K, 96, 64),
                                JBinningConfig(tile=16, max_span=64, max_pairs=4096)).splats
    m2 = np_of(sp.mean2d)[:6]
    assert np.all(np.abs(m2).max(axis=1) > far * 10) and bool(np_of(sp.visible)[:6].all())
    got, _ = check_identical(cloud, 96, 64, eye=(0.0, 0.0, -4.0), tile=16, max_span=64,
                             max_pairs=4096)
    assert np.all(np_of(got.counts)[:6] == 0) and int(got.total_pairs) > 0
