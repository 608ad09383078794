"""The composite at 40, 48, 56 and 64 px tiles: the port's plain versions
against the JAX package's Pallas kernels (interpret mode off the TPU), whose
blocks take any tile (``NPIX = tile * tile``).

- the forward: the JAX grid kernel's packed output (image, depth, final T,
  last position) against ``composite_fwd_plain`` and
  ``composite_manual_fwd_plain`` on the same stream, at the tolerances of
  tests/test_render_exact.py (image 2e-5, depth 2e-4, final T 2e-5, ``last``
  identical), after the port's binning integers are held identical to
  JAX's there;
- the gradients of render(impl="plain") against jax.grad through
  render(impl="pallas"), scaled by the reference's largest value, atol
  1e-4, as tests/test_torch_grad.py's at 8 and 24 px.

The 100 x 72 image makes a grid of several tiles at each of these tiles,
its last column and row cut (100 and 72 are multiples of none of them).
"""

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
from splatpu_torch.render.api import render
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.render.composite import composite_fwd_plain, composite_manual_fwd_plain
from splatpu_torch.render.exact import build_exact_stream
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of, torch_camera, torch_cloud

torch.set_num_threads(1)

W, H = 100, 72
EYE = (0.3, -0.2, -3.5)
BG = np.array([0.1, 0.2, 0.3], np.float32)
PARAMS = ("means", "colors", "rotation_quaternions", "opacity_logits", "log_scales")
GRAD_ATOL = 1e-4
LARGE_TILES = (40, 48, 56, 64)


def cfg(tile):
    return dict(tile=tile, max_span=64, max_pairs=1 << 13, chunk_pairs=256)


def cloud():
    return np_cloud(21, 96, scale_range=(0.03, 0.12))


@pytest.mark.parametrize("tile", LARGE_TILES)
def test_plain_forward_at_large_tiles_matches_jax(tile):
    c = cloud()
    w2c, K = np_lookat(EYE, W, H)
    bc = cfg(tile)
    args = jt.activate_cloud(jax_cloud(c))
    stream = jax.jit(jexact.build_exact_stream, static_argnums=2)(
        args, jax_camera(w2c, K, W, H), JBinningConfig(**bc))
    ts = build_exact_stream(tt.activate_cloud(torch_cloud(c)), torch_camera(w2c, K, W, H),
                            BinningConfig(**bc))
    for f in ("gid", "start", "end", "lane", "offsets", "counts"):
        np.testing.assert_array_equal(np_of(getattr(ts, f)), np_of(getattr(stream, f)), err_msg=f)
    tiles_x, tiles_y = -(-W // tile), -(-H // tile)
    assert tiles_x >= 2 and tiles_y >= 2 and W % tile and H % tile
    table, _ = jexact._pack_table(stream.splats.mean2d, stream.splats.conic,
                                  args.colors, stream.g_opacity, stream.splats.depth)
    fwd = jax.jit(functools.partial(
        jexact._fwd_call_grid,
        num_tiles=tiles_x * tiles_y, tiles_x=tiles_x, G=bc["chunk_pairs"], C=3, scan="mxu2",
        tile=tile,
    ))
    packed = fwd(table[:, stream.gid], stream.start, stream.end, jnp.asarray(BG)[None, :])
    packed = np_of(packed).reshape(tiles_y, tiles_x, tile, tile, -1)
    packed = packed.transpose(0, 2, 1, 3, 4).reshape(tiles_y * tile, tiles_x * tile, -1)[:H, :W]
    assert (packed[..., 5] >= 0).mean() > 0.3, "too few pixels covered"

    port_table = torch.from_numpy(np_of(table)[:10].T.copy())[None]
    ints = [torch.from_numpy(np.array(x))[None] for x in (stream.gid, stream.start, stream.end)]
    geo = dict(tiles_x=tiles_x, tiles_y=tiles_y, tile=tile, width=W, height=H)
    for fwd_plain in (composite_fwd_plain, composite_manual_fwd_plain):
        image, depth, tfin, last = fwd_plain(port_table, *ints, torch.from_numpy(BG), **geo)
        np.testing.assert_allclose(np_of(image)[0].transpose(1, 2, 0), packed[..., :3], rtol=0,
                                   atol=2e-5)
        np.testing.assert_allclose(np_of(depth)[0], packed[..., 3], rtol=0, atol=2e-4)
        np.testing.assert_allclose(np_of(tfin)[0], packed[..., 4], rtol=0, atol=2e-5)
        np.testing.assert_array_equal(np_of(last)[0], packed[..., 5].astype(np.int32))


def jax_loss(params, c, cam, bcfg):
    out = jax_render(jt.activate_cloud(c.replace(**params)), cam, bg=jnp.asarray(BG),
                     impl="pallas", config=bcfg)
    return (jnp.mean(jnp.abs(out.image - 0.4)) + 0.1 * jnp.mean(out.depth)
            + 0.05 * jnp.mean(out.final_transmittance))


jax_grad = jax.jit(jax.grad(jax_loss), static_argnames=("bcfg",))


@pytest.mark.parametrize("tile", LARGE_TILES)
def test_plain_gradients_at_large_tiles_match_jax(tile):
    c_np = cloud()
    jc = jax_cloud(c_np)
    ref = jax_grad({k: getattr(jc, k) for k in PARAMS}, jc,
                   jax_camera(*np_lookat(EYE, W, H), W, H), JBinningConfig(**cfg(tile)))
    tc = torch_cloud(c_np)
    leaves = {k: getattr(tc, k).clone().requires_grad_(True) for k in PARAMS}
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    out = render(tt.activate_cloud(tc.replace(**leaves)), cam, bg=torch.from_numpy(BG),
                 impl="plain", config=BinningConfig(**cfg(tile)))
    assert not bool(out.overflowed.any())
    loss = ((out.image - 0.4).abs().mean() + 0.1 * out.depth.mean()
            + 0.05 * out.final_transmittance.mean())
    loss.backward()
    for k in PARAMS:
        r = np.asarray(ref[k])
        scale = np.abs(r).max() + 1e-8
        assert np.abs(r).max() > 0, k
        np.testing.assert_allclose(leaves[k].grad.numpy() / scale, r / scale, rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)
