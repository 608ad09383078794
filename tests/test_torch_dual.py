"""render_dual, the port against the JAX package on the same numpy inputs.

- "plain" (K1/K2's plain versions) against JAX "pallas" (interpret mode),
  "stream" against "stream", "plain_padded" against "pallas_padded" and
  "oracle" against "oracle", with a small nonzero ``means2d_offset``: both
  composites' image (2e-5), depth (2e-4) and final T (2e-5), and the
  gradients of one loss over both composites to every cloud parameter and
  to the offset, 1e-4 scaled by the reference's largest value;
- the gradient contract: the offset takes the image render's cotangent
  only, every parameter both renders' (against two separate renders);
- a batched camera with a (V, N, 2) offset: each view collects its own
  screen gradients, equal to one-view renders;
- "cuda" on CPU tensors raises (no fallback to the plain versions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.types as jt
from splatpu.render.api import render_dual as jax_render_dual
from splatpu.render.binning import BinningConfig as JBinningConfig
import splatpu_torch.core.types as tt
from splatpu_torch.render.api import render, render_dual
from splatpu_torch.render.binning import BinningConfig
from _torch_scenes import jax_camera, np_cloud, np_lookat, np_of, torch_camera

torch.set_num_threads(1)

W, H = 48, 32
EYE = (0.3, -0.2, -4.0)
BG = np.array([0.1, 0.2, 0.3], np.float32)
CFG = dict(tile=16, max_span=64, max_pairs=1 << 12, chunk_pairs=128)
PARAMS = ("means", "colors", "segmentation_masks", "rotation_quaternions", "opacity_logits",
          "log_scales")
TOL = {"image": 2e-5, "depth": 2e-4, "final_transmittance": 2e-5}
GRAD_ATOL = 1e-4
# port impl -> the JAX package's
IMPLS = {"plain": "pallas", "stream": "stream", "plain_padded": "pallas_padded",
         "oracle": "oracle"}


def scene():
    cloud = np_cloud(31, 48, n_dead=4)
    rng = np.random.default_rng(32)
    offset = rng.uniform(-0.01, 0.01, (48, 2)).astype(np.float32)
    weights = {k: rng.uniform(0.0, 1.0, shape).astype(np.float32)
               for k, shape in (("a", (3, H, W)), ("b", (3, H, W)), ("depth", (H, W)),
                                ("t", (H, W)))}
    return cloud, offset, weights


def loss_of(a_image, a_depth, a_t, b_image, w, xp):
    """A loss over both composites with seeded weights on every output."""
    return (xp.mean(w["a"] * a_image) + 3.0 * xp.mean(w["b"] * b_image)
            + 0.1 * xp.mean(w["depth"] * a_depth) + 0.05 * xp.mean(w["t"] * a_t))


def jax_dual(params, offset, alive, w, impl):
    cloud = jt.GaussianCloud(alive=alive, **params)
    args = jt.activate_cloud(cloud).replace(means2d_offset=offset)
    a, b = jax_render_dual(args, cloud.segmentation_masks,
                           jax_camera(*np_lookat(EYE, W, H), W, H), bg=jnp.asarray(BG),
                           impl=impl, config=JBinningConfig(**CFG))
    loss = loss_of(a.image, a.depth, a.final_transmittance, b.image, w, jnp)
    outs = {f"{tag}_{k}": getattr(o, k) for tag, o in (("a", a), ("b", b)) for k in TOL}
    return loss, outs


jax_dual_grad = jax.jit(jax.value_and_grad(jax_dual, argnums=(0, 1), has_aux=True),
                        static_argnames="impl")


def port_dual(cloud_np, offset_np, w, impl, camera=None, offset_shape=None):
    """(outputs, parameter gradients, offset gradient) of the port's
    render_dual on the same loss."""
    params = {k: torch.from_numpy(cloud_np[k].copy()).requires_grad_(True) for k in PARAMS}
    off = torch.from_numpy(offset_np.copy())
    if offset_shape is not None:
        off = off.expand(offset_shape).contiguous()
    off.requires_grad_(True)
    c = tt.GaussianCloud(alive=torch.from_numpy(cloud_np["alive"]), **params)
    args = dataclasses.replace(tt.activate_cloud(c), means2d_offset=off)
    cam = camera or torch_camera(*np_lookat(EYE, W, H), W, H)
    a, b = render_dual(args, c.segmentation_masks, cam, bg=torch.from_numpy(BG), impl=impl,
                       config=BinningConfig(**CFG))
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    loss = loss_of(a.image, a.depth, a.final_transmittance, b.image, wt, torch)
    loss.backward()
    outs = {f"{tag}_{k}": getattr(o, k) for tag, o in (("a", a), ("b", b)) for k in TOL}
    return outs, {k: p.grad for k, p in params.items()}, off.grad


def assert_scaled(got, ref, what):
    scale = np.abs(ref).max() + 1e-12
    np.testing.assert_allclose(np_of(got) / scale, ref / scale, rtol=0, atol=GRAD_ATOL,
                               err_msg=what)


@pytest.mark.parametrize("impl", list(IMPLS))
def test_dual_matches_jax(impl):
    cloud, offset, w = scene()
    params = {k: jnp.asarray(cloud[k]) for k in PARAMS}
    (_, ref_outs), (ref_pg, ref_og) = jax_dual_grad(
        params, jnp.asarray(offset), jnp.asarray(cloud["alive"]),
        {k: jnp.asarray(v) for k, v in w.items()}, impl=IMPLS[impl])
    outs, pgrads, ograd = port_dual(cloud, offset, w, impl)
    for k, ref in ref_outs.items():
        got = np_of(outs[k])[0]
        assert got.shape == ref.shape, k
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=TOL[k[2:]], err_msg=k)
    for k in PARAMS:
        assert_scaled(pgrads[k], np.asarray(ref_pg[k]), k)
    assert np.abs(np.asarray(ref_og)).max() > 0
    assert_scaled(ograd, np.asarray(ref_og), "means2d_offset")


@pytest.mark.parametrize("impl", ["plain", "plain_padded"])
def test_offset_gradient_contract(impl):
    """The offset's gradient is the image loss's alone; every parameter's
    is the sum of both renders' (two separate renders, the secondary with
    a detached offset)."""
    cloud, offset, w = scene()
    _, dual_pg, dual_og = port_dual(cloud, offset, w, impl)

    params = {k: torch.from_numpy(cloud[k].copy()).requires_grad_(True) for k in PARAMS}
    off = torch.from_numpy(offset.copy()).requires_grad_(True)
    c = tt.GaussianCloud(alive=torch.from_numpy(cloud["alive"]), **params)
    args = dataclasses.replace(tt.activate_cloud(c), means2d_offset=off)
    cam = torch_camera(*np_lookat(EYE, W, H), W, H)
    bcfg = BinningConfig(**CFG)
    bg = torch.from_numpy(BG)
    a = render(args, cam, bg=bg, impl=impl, config=bcfg)
    b = render(dataclasses.replace(args, colors=c.segmentation_masks,
                                   means2d_offset=off.detach()),
               cam, bg=bg, impl=impl, config=bcfg)
    wt = {k: torch.from_numpy(v) for k, v in w.items()}
    loss_of(a.image, a.depth, a.final_transmittance, b.image, wt, torch).backward()
    for k in PARAMS:
        assert_scaled(dual_pg[k], np_of(params[k].grad), k)
    assert_scaled(dual_og, np_of(off.grad), "means2d_offset")
    # And the image loss alone gives the offset the same gradient.
    off2 = torch.from_numpy(offset.copy()).requires_grad_(True)
    args2 = dataclasses.replace(tt.activate_cloud(c), means2d_offset=off2)
    a2 = render(args2, cam, bg=bg, impl=impl, config=bcfg)
    (torch.mean(wt["a"] * a2.image) + 0.1 * torch.mean(wt["depth"] * a2.depth)
     + 0.05 * torch.mean(wt["t"] * a2.final_transmittance)).backward()
    assert_scaled(dual_og, np_of(off2.grad), "means2d_offset, image loss only")


def test_batched_offsets_per_view():
    """Two views through one batched camera with a (2, N, 2) offset: each
    view's images and offset gradient equal its one-view render's."""
    cloud, offset, w = scene()
    eyes = (EYE, (-0.5, 0.3, -4.0))
    cams = [torch_camera(*np_lookat(e, W, H), W, H) for e in eyes]
    outs, _, ograd = port_dual(cloud, offset, w, "plain", camera=tt.stack_cameras(cams),
                               offset_shape=(2, 48, 2))
    assert ograd.shape == (2, 48, 2)
    for i, cam in enumerate(cams):
        one, _, og = port_dual(cloud, offset, w, "plain", camera=cam)
        for k in outs:
            np.testing.assert_allclose(np_of(outs[k][i]), np_of(one[k][0]), rtol=0, atol=1e-6,
                                       err_msg=k)
        # The batched loss is a mean over 2 views: each view's share is half.
        np.testing.assert_allclose(np_of(ograd[i]) * 2.0, np_of(og), rtol=1e-5, atol=1e-9)


def test_cuda_dual_raises_on_cpu_tensors():
    cloud, offset, w = scene()
    with pytest.raises(ValueError, match="CUDA tensors"):
        port_dual(cloud, offset, w, "cuda")
