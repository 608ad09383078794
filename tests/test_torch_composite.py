"""The forward composite: the port's plain version and render(impl="plain") vs
the JAX package's Pallas forward kernel (interpret mode off the TPU) and its
oracle, at the tolerances of tests/test_render_exact.py (image 2e-5,
depth 2e-4, final T 2e-5)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.types as jt
import splatpu.render.exact as jexact
from splatpu.render.api import render as jax_render
from splatpu.render.binning import BinningConfig as JBinningConfig
import splatpu_torch.core.types as tt
from splatpu_torch.render.api import render, resolve_impl
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.composite import (
    composite_fwd_cuda,
    composite_fwd_plain,
    composite_manual_fwd_plain,
    pack_table,
)
from splatpu_torch.render.exact import build_exact_stream
from _torch_scenes import (
    jax_camera, jax_cloud, np_cloud, np_lookat, np_of, torch_camera, torch_cloud,
)

torch.set_num_threads(1)

CFG = dict(max_span=64, max_pairs=1 << 12, chunk_pairs=256)
TOL = {"image": 2e-5, "depth": 2e-4, "final_transmittance": 2e-5}
jax_render_jit = jax.jit(jax_render, static_argnames=("impl", "config"))


def jax_views(cloud, cams, bg, impl, cfg, colors=None):
    args = jt.activate_cloud(jax_cloud(cloud))
    if colors is not None:
        args = args.replace(colors=jnp.asarray(colors))
    outs = [jax_render_jit(args, jax_camera(w2c, K, w, h), bg=jnp.asarray(bg),
                           impl=impl, config=JBinningConfig(**cfg))
            for (w2c, K, w, h) in cams]
    return {k: np.stack([np_of(getattr(o, k)) for o in outs]) for k in TOL}


def port_views(cloud, cams, bg, cfg, colors=None, impl="plain"):
    args = tt.activate_cloud(torch_cloud(cloud))
    if colors is not None:
        args = tt.RenderArgs(args.means3d, torch.from_numpy(colors), args.rotations,
                             args.opacities, args.scales)
    cam = tt.stack_cameras([torch_camera(*c) for c in cams])
    return render(args, cam, bg=torch.tensor(bg), impl=impl, config=BinningConfig(**cfg))


def assert_matches(out, ref):
    for k, tol in TOL.items():
        np.testing.assert_allclose(np_of(getattr(out, k)), ref[k], rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("ref_impl", ["pallas", "oracle"])
def test_render_matches_jax(seed, ref_impl):
    cloud = np_cloud(seed, 48)
    cams = [(*np_lookat((0.3, -0.2, -4.0), 48, 32), 48, 32)]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    out = port_views(cloud, cams, bg, CFG)
    assert_matches(out, jax_views(cloud, cams, bg, ref_impl, CFG))
    assert not bool(out.overflowed.any())


def test_batched_views_one_call():
    cloud = np_cloud(2, 64)
    eyes = [(0.3, -0.2, -4.0), (2.5, 0.5, -3.0), (-1.0, 2.0, -3.5)]
    cams = [(*np_lookat(e, 48, 32), 48, 32) for e in eyes]
    bg = np.array([0.0, 0.5, 1.0], np.float32)
    out = port_views(cloud, cams, bg, CFG)
    assert out.image.shape == (3, 3, 32, 48)
    assert_matches(out, jax_views(cloud, cams, bg, "pallas", CFG))


def test_deep_stack_termination():
    # 160 nearly opaque splats on one line of sight: T crosses 1e-4 early and
    # everything behind the cut must be ignored.
    cloud = np_cloud(3, 160, scale_range=(0.2, 0.3), opacity_range=(4.0, 6.0))
    cloud["means"][:, :2] *= 0.05
    cams = [(*np_lookat((0.0, 0.0, -4.0), 32, 32), 32, 32)]
    bg = np.array([0.3, 0.3, 0.3], np.float32)
    out = port_views(cloud, cams, bg, CFG)
    ref = jax_views(cloud, cams, bg, "oracle", CFG)
    assert_matches(out, ref)
    # The cut keeps T at or above 1e-4; deep pixels end just above it.
    assert 1e-4 <= float(out.final_transmittance.min()) < 1e-3


def test_single_channel():
    cloud = np_cloud(4, 48)
    colors = np.random.default_rng(4).uniform(size=(48, 1)).astype(np.float32)
    cams = [(*np_lookat((0.3, -0.2, -4.0), 40, 24), 40, 24)]
    bg = np.array([0.2], np.float32)
    out = port_views(cloud, cams, bg, CFG, colors=colors)
    assert_matches(out, jax_views(cloud, cams, bg, "oracle", CFG, colors=colors))


def test_non_tile_aligned_and_tile32():
    cloud = np_cloud(5, 80)
    cams = [(*np_lookat((0.5, 0.2, -3.5), 50, 37), 50, 37)]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg = dict(CFG, tile=32)
    assert_matches(port_views(cloud, cams, bg, cfg), jax_views(cloud, cams, bg, "pallas", cfg))


def test_render_without_exact_tie_order_matches_jax():
    """``exact_tie_order=False`` through render: wide and small Gaussians in
    pairs at one mean (equal (tile, depth) keys whose gid order and
    emission order disagree) against JAX's pallas render with the flag; the
    flag changes the image there."""
    cloud = np_cloud(12, 160, scale_range=(0.02, 0.05))
    cloud["log_scales"][:80] = np.log(np.float32(0.3))
    cloud["means"][80:] = cloud["means"][:80]
    cams = [(*np_lookat((0.3, -0.2, -4.0), 96, 64), 96, 64)]
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    cfg = dict(CFG, tile=16, span_small=4, max_pairs=1 << 13, exact_tie_order=False)
    out = port_views(cloud, cams, bg, cfg)
    assert_matches(out, jax_views(cloud, cams, bg, "pallas", cfg))
    by_gid = port_views(cloud, cams, bg, dict(cfg, exact_tie_order=True))
    assert float((out.image - by_gid.image).abs().max()) > 1e-3


def test_empty_scene_is_background():
    cloud = np_cloud(6, 16)
    cloud["means"] -= np.array([0.0, 0.0, 20.0], np.float32)
    cams = [(*np_lookat((0.0, 0.0, -4.0), 32, 32), 32, 32)]
    out = port_views(cloud, cams, np.array([0.4, 0.5, 0.6], np.float32), CFG)
    np.testing.assert_allclose(np_of(out.image)[0, 0], 0.4, atol=1e-6)
    assert np.all(np_of(out.final_transmittance) == 1.0)
    assert np.all(np_of(out.last_contributor) == -1)


@pytest.mark.parametrize("chunk", [7, 256])
def test_plain_composite_vs_pallas_kernel(chunk):
    """Same stream into both composites: the JAX grid kernel's packed output
    (image | depth | T | last position) against the plain version, including
    the last contributor, whatever the plain version's chunking."""
    cloud = np_cloud(7, 120)
    w, h, tile = 64, 48, 16
    w2c, K = np_lookat((0.4, 0.1, -3.0), w, h)
    cfg = JBinningConfig(tile=tile, **CFG)
    args = jt.activate_cloud(jax_cloud(cloud))
    stream = jax.jit(jexact.build_exact_stream, static_argnums=2)(
        args, jax_camera(w2c, K, w, h), cfg)
    table, _ = jexact._pack_table(stream.splats.mean2d, stream.splats.conic,
                                  args.colors, stream.g_opacity, stream.splats.depth)
    tiles_x, tiles_y = -(-w // tile), -(-h // tile)
    bg = jnp.array([0.1, 0.2, 0.3])
    fwd = jax.jit(functools.partial(
        jexact._fwd_call_grid,
        num_tiles=tiles_x * tiles_y, tiles_x=tiles_x, G=256, C=3, scan="mxu2", tile=tile,
    ))
    packed = fwd(table[:, stream.gid], stream.start, stream.end, bg[None, :])
    packed = np_of(packed).reshape(tiles_y, tiles_x, tile, tile, 8)
    packed = packed.transpose(0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, 8)[:h, :w]

    port_table = torch.from_numpy(np_of(table)[:10].T.copy())[None]
    ints = [torch.from_numpy(np.array(x))[None] for x in (stream.gid, stream.start, stream.end)]
    image, depth, tfin, last = composite_fwd_plain(
        port_table, *ints,
        torch.tensor([0.1, 0.2, 0.3]), tiles_x=tiles_x, tiles_y=tiles_y, tile=tile,
        width=w, height=h, chunk=chunk,
    )
    np.testing.assert_allclose(np_of(image)[0].transpose(1, 2, 0), packed[..., :3], atol=2e-5)
    np.testing.assert_allclose(np_of(depth)[0], packed[..., 3], atol=2e-4)
    np.testing.assert_allclose(np_of(tfin)[0], packed[..., 4], atol=2e-5)
    np.testing.assert_array_equal(np_of(last)[0], packed[..., 5].astype(np.int32))


def test_work_counts():
    cloud = np_cloud(8, 60)
    w2c, K = np_lookat((0.0, 0.0, -4.0), 32, 32)
    args = tt.activate_cloud(torch_cloud(cloud))
    out = render(args, torch_camera(w2c, K, 32, 32), impl="plain",
                 config=BinningConfig(tile=16, **CFG))
    assert bool((out.last_contributor >= 0).any())
    s = build_exact_stream(args, torch_camera(w2c, K, 32, 32), BinningConfig(tile=16, **CFG))
    table = pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth, args.colors)
    *_, n_eval, n_contrib = composite_fwd_plain(
        table[None], s.gid[None], s.start[None], s.end[None], torch.zeros(3),
        tiles_x=2, tiles_y=2, tile=16, width=32, height=32, with_counts=True,
    )
    seg = (s.end - s.start).max()
    assert bool((n_contrib <= n_eval).all()) and int(n_eval.max()) <= int(seg)
    assert int(n_contrib.sum()) > 0


def test_dispatch_and_guards():
    assert resolve_impl("auto", torch.device("cpu")) == "plain"
    assert resolve_impl("auto", torch.device("cuda")) == "cuda"
    # The JAX package's names: the card's kernels, or their plain versions
    # on the CPU.
    assert resolve_impl("pallas", torch.device("cpu")) == "plain"
    assert resolve_impl("pallas_padded", torch.device("cuda")) == "cuda_padded"
    z = torch.zeros
    args = (z((1, 4, 10)), z((1, 8), dtype=torch.int32), z((1, 1), dtype=torch.int32),
            z((1, 1), dtype=torch.int32), z(3))
    geo = dict(tiles_x=1, tiles_y=1, tile=16, width=16, height=16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        composite_fwd_cuda(*args, **geo)
    image, *_ = composite_fwd_plain(*args, **geo)
    assert image.shape == (1, 3, 16, 16)
    args4 = tt.activate_cloud(torch_cloud(np_cloud(9, 4)))
    cam = torch_camera(*np_lookat((0, 0, -4.0), 16, 16), 16, 16)
    with pytest.raises(ValueError, match="unknown renderer impl"):
        render(args4, cam, impl="triton")
    with pytest.raises(ValueError, match="CUDA tensors"):  # never falls back
        render(args4, cam, impl="cuda")
    with pytest.raises(ValueError, match="channels"):
        composite_fwd_plain(z((1, 4, 14)), *args[1:4], z(7), **geo)


@pytest.mark.parametrize("tile", [4, 12, 20, 72])
def test_tile_outside_forward_set_refused(tile):
    """The composite takes the forward kernels' tiles, every multiple of 8
    from 8 to 64 px: the input check, which the CUDA wrappers run before
    they launch, refuses any other (no test, script, run or CLI help of
    either package names one)."""
    z = torch.zeros
    args = (z((1, 4, 10)), z((1, 8), dtype=torch.int32), z((1, 1), dtype=torch.int32),
            z((1, 1), dtype=torch.int32), z(3))
    geo = dict(tiles_x=1, tiles_y=1, tile=tile, width=tile, height=tile)
    for fwd in (composite_fwd_plain, composite_manual_fwd_plain):
        with pytest.raises(ValueError, match="px tiles"):
            fwd(*args, **geo)
    image, *_ = composite_fwd_plain(*args, **dict(geo, tile=8, width=8, height=8))
    assert image.shape == (1, 3, 8, 8)
