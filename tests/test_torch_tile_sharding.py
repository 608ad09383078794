"""Tile strips: one render split across gloo ranks by image rows
(``splatpu_torch.dist.tile_sharding``) against the port's whole render and
the JAX package's ``make_tile_sharded_render`` on the first k of the
conftest's virtual CPU devices, on the same numpy inputs.

Tolerances:
- ``strip_height`` identical over a grid of sizes;
- ``preprocess`` (with a ``means2d_offset``) and ``offset_pixel_scale``
  of a strip camera: the whole camera's screen quantities, the positions
  less the strip's first row, bit for bit; against the JAX package's
  strip, visibility and radii identical, the rest 1e-6 of the largest
  value (1e-5 for the conic), as in ``test_torch_core.py``;
- strip renders, 2 and 4 strips: each strip's rows identical to the whole
  render's, and 2e-5 of JAX's strips (the tolerance of
  ``tests/test_tile_sharding.py``);
- the dual strips' gradients (every render input, ``means2d_offset`` and
  the segmentation colours included) 1e-5 of each tensor's largest value
  and 1e-4 of each row's, against the whole dual render's; the loss 1e-6
  relative.  The strips' images are the whole render's, but each rank
  sums its strip's share of a Gaussian's gradient and the shares are then
  added, another order than the whole render's: on rows whose terms
  nearly cancel the gradients differ by more than 1e-5 of the row's
  largest value.  The strips' gather hands
  each rank its own rows of the cotangent: one that summed the cotangents
  over the ranks would double these gradients, an error of 1.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.projection as jproj
import splatpu.core.types as jt
from splatpu.dist.mesh import get_mesh as jget_mesh
from splatpu.dist.tile_sharding import (
    make_tile_sharded_render as jstrips,
    strip_height as jstrip_height,
)
from splatpu.render.binning import BinningConfig as JBinningConfig
import splatpu_torch.core.projection as tproj
import splatpu_torch.core.types as tt
from splatpu_torch.dist import ranks
from splatpu_torch.dist.launch import launch
from splatpu_torch.dist.tile_sharding import strip_camera, strip_height
from splatpu_torch.render.api import render, render_dual
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.train.losses import SEGMENTATION_WEIGHT, image_losses
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of, torch_camera, torch_cloud

torch.set_num_threads(1)

BIN = dict(tile=16, max_span=32, max_pairs=1 << 12, chunk_pairs=128)
TIMEOUT_S = 120


def test_strip_height_matches_jax():
    for height in (1, 15, 16, 17, 64, 100, 720, 1080):
        for n in (1, 2, 3, 4, 8):
            for tile in (8, 16, 24, 32):
                assert strip_height(height, n, tile) == jstrip_height(height, n, tile)
    assert strip_height(720, 8) == jstrip_height(720, 8)


@pytest.mark.parametrize("n,row", [(2, 1), (4, 2)])
def test_strip_preprocess_matches_jax(n, row):
    """The camera of strip ``row`` of ``n``: its screen quantities the whole
    camera's, the positions less the strip's first row, bit for bit; and
    within the tolerances above of the JAX package's strip (which moves
    the principal point instead and rounds the positions otherwise)."""
    c = np_cloud(3, 300, extent=1.5, scale_range=(0.01, 0.3))
    w, h = 64, 56
    w2c, K = np_lookat((0.3, -0.2, -3.5), w, h)
    sh = strip_height(h, n, 16)
    tstrip = strip_camera(torch_camera(w2c, K, w, h), sh, row * sh)
    jstrip = jt.Camera(w2c=jnp.asarray(w2c), K=jnp.asarray(K).at[1, 2].add(-float(row * sh)),
                       width=w, height=sh, fov_width=w, fov_height=h)
    assert (tstrip.fov_width, tstrip.fov_height, tstrip.height, tstrip.row_offset) == (
        w, h, min(sh, h - row * sh), row * sh)
    np.testing.assert_array_equal(np_of(tproj.offset_pixel_scale(tstrip)),
                                  np_of(jproj.offset_pixel_scale(jstrip)))
    off = np.random.default_rng(5).normal(size=(300, 2)).astype(np.float32) * 1e-3
    targs = dataclasses.replace(tt.activate_cloud(torch_cloud(c)),
                                means2d_offset=torch.from_numpy(off))
    got = tproj.preprocess(targs, tstrip)
    whole = tproj.preprocess(targs, torch_camera(w2c, K, w, h))
    ref = jproj.preprocess(dataclasses.replace(jt.activate_cloud(jax_cloud(c)),
                                               means2d_offset=jnp.asarray(off)), jstrip)
    shifted = np_of(whole.mean2d) - np.float32([0.0, row * sh])
    np.testing.assert_array_equal(np_of(got.mean2d), shifted)
    for name in ("depth", "conic", "radius", "visible"):
        np.testing.assert_array_equal(np_of(getattr(got, name)), np_of(getattr(whole, name)))
    vis = np_of(ref.visible)
    np.testing.assert_array_equal(np_of(got.visible), vis)
    np.testing.assert_array_equal(np_of(got.radius), np_of(ref.radius))
    for name, tol in (("depth", 1e-6), ("mean2d", 1e-6), ("conic", 1e-5)):
        a, b = np_of(getattr(got, name)), np_of(getattr(ref, name))
        if name != "depth":
            a, b = a[vis], b[vis]
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(float(np.abs(b).max()), 1.0),
                                   err_msg=name)


def scene(seed=0, n=64, w=64, h=64):
    c = np_cloud(seed, n)
    a = jt.activate_cloud(jax_cloud(c))
    args = {k: np.asarray(getattr(a, k)) for k in
            ("means3d", "colors", "rotations", "opacities", "scales", "means2d_offset")}
    w2c, K = np_lookat((0.2, -0.1, -4.0), w, h)
    return c, args, w2c, K


@pytest.mark.parametrize("n,renderer", [(2, "stream"), (4, "plain")])
def test_strip_render_matches_full_render_and_jax(tmp_path, n, renderer):
    c, args, w2c, K = scene()
    w = h = 64
    got = launch(ranks.strips_on_rank, n,
                 (args, dict(w2c=w2c, K=K, width=w, height=h), n, renderer, BinningConfig(**BIN),
                  "cpu"), tmp_path, device="cpu", timeout_s=TIMEOUT_S)
    targs = tt.RenderArgs(**{k: torch.from_numpy(v.copy()) for k, v in args.items()})
    full = render(targs, torch_camera(w2c, K, w, h), impl=renderer,
                  config=BinningConfig(**BIN)).image.numpy()
    mesh = jget_mesh(camera_axis=1, tile_axis=n, devices=jax.devices()[:n])
    cam = jax_camera(w2c, K, w, h)
    jimg = np.asarray(jax.jit(jstrips(mesh, cam, renderer="stream", binning=JBinningConfig(**BIN)))(
        jt.RenderArgs(**{k: jnp.asarray(v) for k, v in args.items()}), cam.w2c, cam.K))
    sh = strip_height(h, n, 16)
    for r in got:
        assert r["jax_modules"] == [] and r["row0"] == r["rank"] * sh
        img = r["image"]
        assert img.shape == (1, 3, n * sh, w)
        np.testing.assert_array_equal(img[0, :, :h], full[0])
        np.testing.assert_allclose(img[0, :, :h], jimg[:, :h], rtol=0, atol=2e-5)
        assert (r["last_gid"] >= -1).all()


def test_dual_strip_gradients_match_full_dual_render(tmp_path):
    c, args, w2c, K = scene(1, 80, 48, 40)
    w, h = 48, 40
    rng = np.random.default_rng(4)
    seg = c["segmentation_masks"]
    targets = rng.uniform(size=(1, 3, h, w)).astype(np.float32)
    seg_targets = (rng.uniform(size=(1, 3, h, w)) > 0.5).astype(np.float32)
    got = launch(ranks.dual_grads_on_rank, 2,
                 (args, seg, dict(w2c=w2c, K=K, width=w, height=h), targets, seg_targets, 2,
                  "plain", BinningConfig(**BIN), "cpu"), tmp_path, device="cpu",
                 timeout_s=TIMEOUT_S)
    leaves = {k: torch.from_numpy(v.copy()).requires_grad_(True) for k, v in args.items()}
    cb = torch.from_numpy(seg.copy()).requires_grad_(True)
    out, seg_out = render_dual(tt.RenderArgs(**leaves), cb, torch_camera(w2c, K, w, h),
                               impl="plain", config=BinningConfig(**BIN))
    loss = (image_losses(out.image, torch.from_numpy(targets))
            + SEGMENTATION_WEIGHT * image_losses(seg_out.image, torch.from_numpy(seg_targets))).mean()
    names = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names] + [cb])
    want = {**dict(zip(names, (g.numpy() for g in grads))), "colors_b": grads[-1].numpy()}
    assert float(np.abs(want["means2d_offset"]).max()) > 0
    for r in got:
        assert r["loss"] == pytest.approx(loss.item(), rel=1e-6)
        np.testing.assert_array_equal(r["radii"], out.radii.detach().numpy())
        np.testing.assert_array_equal(r["image"], out.image.detach().numpy())
        for k, g in want.items():
            err = np.abs(r["grads"][k] - g).reshape(len(g), -1).max(1)
            scale = np.maximum(np.abs(g).reshape(len(g), -1).max(1), 1e-12)
            assert float(err.max() / np.abs(g).max()) <= 1e-5, k
            assert float((err / scale).max()) <= 1e-4, k
