"""splatpu_torch.core vs splatpu.core: quaternions, positional encoding, cloud
activation, EWA preprocess and tile rects on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.encoding as jenc
import splatpu.core.projection as jproj
import splatpu.core.quaternion as jquat
import splatpu.core.types as jt
import splatpu_torch.core.encoding as tenc
import splatpu_torch.core.projection as tproj
import splatpu_torch.core.quaternion as tquat
import splatpu_torch.core.types as tt
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of, torch_camera, torch_cloud

torch.set_num_threads(1)


def close(a, b, atol_rel=1e-6, what=""):
    a, b = np_of(a), np_of(b)
    scale = max(float(np.abs(b).max()), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=atol_rel * scale, err_msg=what)


@pytest.mark.parametrize("seed", [0, 1])
def test_quaternions(seed):
    q = np.random.default_rng(seed).normal(size=(257, 4)).astype(np.float32)
    close(tquat.quat_normalize(torch.from_numpy(q)), jquat.quat_normalize(jnp.asarray(q)))
    close(tquat.build_rotation(torch.from_numpy(q)), jquat.build_rotation(jnp.asarray(q)))


@pytest.mark.parametrize("quirk", [True, False])
@pytest.mark.parametrize("freqs", [4, 10])
def test_positional_encoding(quirk, freqs):
    x = np.random.default_rng(freqs).uniform(-1, 1, (65, 3)).astype(np.float32)
    got = tenc.positional_encoding(torch.from_numpy(x), freqs, quirk)
    ref = jenc.positional_encoding(jnp.asarray(x), freqs, quirk)
    assert got.shape == ref.shape == (65, 2 * freqs * 3)
    close(got, ref, what="layout or values differ")


def test_activate_cloud_dead_slots():
    c = np_cloud(3, 40, n_dead=7)
    got = tt.activate_cloud(torch_cloud(c))
    ref = jt.activate_cloud(jax_cloud(c))
    for k in ("means3d", "colors", "rotations", "opacities", "scales"):
        close(getattr(got, k), getattr(ref, k), what=k)
    assert np.all(np_of(got.opacities)[-7:] == 0.0)


SCENES = [
    # (seed, n, eye, width, height)
    (0, 300, (0.3, -0.2, -4.0), 96, 64),
    (1, 300, (2.0, 1.0, -1.5), 50, 37),        # close camera, non-aligned image
    (2, 200, (0.0, 0.0, -1.2), 64, 64),        # many splats near / behind the near plane
]


@pytest.mark.parametrize("seed,n,eye,w,h", SCENES)
def test_preprocess(seed, n, eye, w, h):
    c = np_cloud(seed, n, extent=1.5, scale_range=(0.01, 0.3))
    w2c, K = np_lookat(eye, w, h)
    ref = jproj.preprocess(jt.activate_cloud(jax_cloud(c)), jax_camera(w2c, K, w, h))
    got = tproj.preprocess(tt.activate_cloud(torch_cloud(c)), torch_camera(w2c, K, w, h))
    vis = np_of(ref.visible)
    np.testing.assert_array_equal(np_of(got.visible), vis)
    close(got.depth, ref.depth, what="depth")
    close(np_of(got.mean2d)[vis], np_of(ref.mean2d)[vis], what="mean2d")
    close(np_of(got.conic)[vis], np_of(ref.conic)[vis], 1e-5, what="conic")
    np.testing.assert_array_equal(np_of(got.radius), np_of(ref.radius))
    tx, ty = -(-w // 16), -(-h // 16)
    for a, b in zip(
        tproj.tile_rect(got.mean2d, got.radius, tx, ty, 16),
        jproj.tile_rect(ref.mean2d, ref.radius, tx, ty, 16),
    ):
        np.testing.assert_array_equal(np_of(a)[vis], np_of(b)[vis])


def test_batched_camera_views():
    cams = [torch_camera(*np_lookat(e, 32, 24), 32, 24) for e in [(0, 0, -3), (1, 0, -3)]]
    batch = tt.stack_cameras(cams)
    assert batch.num_views == 2
    for i, c in enumerate(cams):
        assert torch.equal(batch.view(i).w2c, c.w2c)
        assert torch.equal(batch.view(i).tan_fovx, c.tan_fovx)


def test_offset_pixel_scale():
    w2c, K = np_lookat((0.0, 0.0, -4.0), 50, 37)
    np.testing.assert_array_equal(
        np_of(tproj.offset_pixel_scale(torch_camera(w2c, K, 50, 37))),
        np_of(jproj.offset_pixel_scale(jax_camera(w2c, K, 50, 37))))
