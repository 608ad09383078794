"""The exact path under BinningConfig(kernel="manual") (K4's plain versions):
the port against the JAX package's kernel="manual" (interpret mode), on the
same numpy inputs.

- 3 and 9 colour channels (the 9-channel colours from a seeded generator):
  image 2e-5, depth 2e-4, final T 2e-5 (tests/test_render_exact.py's
  tolerances), and gradients to every per-Gaussian input within 1e-4 of
  the JAX ones, scaled by the reference's largest value;
- the guards raise the JAX package's messages: kernel="grid" with 6
  channels, kernel="grid" with max_pairs = 2^24 + 128, and 10 channels.
"""

import types

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
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of, torch_camera, torch_cloud

torch.set_num_threads(1)

W, H = 48, 32
EYE = (0.3, -0.2, -4.0)
CFG = dict(tile=16, max_span=64, max_pairs=1 << 12, chunk_pairs=256, kernel="manual")
PARAMS = ("means", "colors", "rotation_quaternions", "opacity_logits", "log_scales")
TOL = {"image": 2e-5, "depth": 2e-4, "final_transmittance": 2e-5}
GRAD_ATOL = 1e-4


def scene(channels):
    cloud = np_cloud(31, 64)
    rng = np.random.default_rng(channels)
    cloud["colors"] = rng.uniform(0.0, 1.0, (64, channels)).astype(np.float32)
    bg = np.linspace(0.1, 0.5, channels).astype(np.float32)
    return cloud, bg


def jax_loss(params, cloud, cam, bg, bcfg):
    out = jax_render(jt.activate_cloud(cloud.replace(**params)), cam, bg=bg, impl="pallas",
                     config=bcfg)
    return (jnp.mean(jnp.abs(out.image - 0.4)) + 0.1 * jnp.mean(out.depth)
            + 0.05 * jnp.mean(out.final_transmittance)), out


jax_value_and_grad = jax.jit(jax.value_and_grad(jax_loss, has_aux=True), static_argnames="bcfg")


@pytest.fixture(scope="module", params=[3, 9])
def case(request):
    """(channels, cloud, bg, JAX outputs, JAX gradients), jitted once per
    channel count."""
    channels = request.param
    cloud_np, bg = scene(channels)
    cloud = jax_cloud(cloud_np)
    cam = jax_camera(*np_lookat(EYE, W, H), W, H)
    (_, out), grads = jax_value_and_grad({k: getattr(cloud, k) for k in PARAMS}, cloud, cam,
                                         jnp.asarray(bg), JBinningConfig(**CFG))
    return (channels, cloud_np, bg, {k: np_of(getattr(out, k)) for k in TOL},
            {k: np_of(v) for k, v in grads.items()})


def test_forward_and_gradients_match_jax(case):
    channels, cloud_np, bg, ref_out, ref_grads = case
    c = torch_cloud(cloud_np)
    leaves = {k: getattr(c, k).clone().requires_grad_(True) for k in PARAMS}
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    out = render(tt.activate_cloud(c.replace(**leaves)), cam, bg=torch.from_numpy(bg),
                 impl="plain", config=BinningConfig(**CFG))
    assert out.image.shape == (1, channels, H, W) and not bool(out.overflowed.any())
    for k, tol in TOL.items():
        np.testing.assert_allclose(np_of(getattr(out, k))[0], ref_out[k], rtol=0, atol=tol,
                                   err_msg=k)
    loss = ((out.image - 0.4).abs().mean() + 0.1 * out.depth.mean()
            + 0.05 * out.final_transmittance.mean())
    loss.backward()
    for k in PARAMS:
        ref = ref_grads[k]
        scale = np.abs(ref).max()
        assert scale > 0, k
        np.testing.assert_allclose(leaves[k].grad.numpy() / scale, ref / scale, rtol=0,
                                   atol=GRAD_ATOL, err_msg=k)


def jax_message(channels, **cfg):
    """The ValueError the JAX package's composite_exact raises for this
    config, reached with a stand-in stream (its guards run before it reads
    the stream's arrays)."""
    z = jnp.zeros((4,))
    stream = types.SimpleNamespace(
        g_colors=jnp.zeros((4, channels)), offsets=z, g_opacity=z,
        splats=types.SimpleNamespace(mean2d=jnp.zeros((4, 2)), conic=jnp.zeros((4, 3)), depth=z))
    with pytest.raises(ValueError) as err:
        jexact.composite_exact(stream, jax_camera(*np_lookat(EYE, W, H), W, H),
                               JBinningConfig(**cfg), jnp.zeros((channels,)))
    return str(err.value)


@pytest.mark.parametrize("channels,cfg", [
    (6, dict(CFG, kernel="grid")),
    (3, dict(CFG, kernel="grid", max_pairs=(1 << 24) + 128, chunk_pairs=128)),
    (10, CFG),
])
def test_guards_raise_jax_messages(channels, cfg):
    message = jax_message(channels, **cfg)
    cloud_np, bg = scene(channels)
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    with pytest.raises(ValueError) as err:
        render(tt.activate_cloud(torch_cloud(cloud_np)), cam, bg=torch.from_numpy(bg),
               impl="plain", config=BinningConfig(**cfg))
    assert str(err.value) == message


def test_manual_cuda_raises_on_cpu_tensors():
    # No fallback: kernel="manual" on "cuda" never runs the plain versions.
    cloud_np, bg = scene(9)
    cam = tt.stack_cameras([torch_camera(*np_lookat(EYE, W, H), W, H)])
    with pytest.raises(ValueError, match="CUDA tensors"):
        render(tt.activate_cloud(torch_cloud(cloud_np)), cam, bg=torch.from_numpy(bg),
               impl="cuda", config=BinningConfig(**CFG))
