"""The port's rank grid, launcher, sharded stage-2 losses and one-build-per-
host kernel library, run as gloo ranks on the CPU through
``splatpu_torch.dist.launch`` and held against the JAX package's
``splatpu.dist`` on the conftest's virtual CPU devices (the first k of them
for a k-rank mesh), on the same numpy inputs.

Tolerances:
- ``pad_views`` / ``pad_picks`` identical;
- the camera-sharded and 2D losses 1e-5 relative of JAX's (float32 sums in
  another order); the camera-sharded gradients, summed over the ranks,
  1e-5 of the port's single-process gradients scaled per row by the
  largest value; the 2D ones within JAX's own gate for them (rtol 2e-3,
  atol 2e-5, ``tests/test_dist.py::test_2d_sharded_image_losses_match_single_device``):
  each strip's per-Gaussian sums are added across the ranks in another
  order;
- the grid layout, the launcher's failures and the build count exact.
"""

import operator
import os
import stat
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.core.types as jt
from splatpu.dist.mesh import get_mesh as jget_mesh
from splatpu.dist.sharding import (
    make_2d_sharded_image_losses as j2d,
    make_camera_sharded_image_losses as jcam,
    pad_picks as jpad_picks,
    pad_views as jpad_views,
)
from splatpu.render.binning import BinningConfig as JBinningConfig
from splatpu_torch.core.ssim import ssim
from splatpu_torch.core.types import Camera, RenderArgs
from splatpu_torch.dist import mesh as tmesh, ranks
from splatpu_torch.dist.launch import RankFailure, launch
from splatpu_torch.dist.sharding import pad_picks, pad_views
from splatpu_torch.render.api import render
from splatpu_torch.render.binning import BinningConfig
from _torch_scenes import jax_cloud, np_cloud, np_lookat

torch.set_num_threads(1)

W = H = 32
BIN = dict(max_span=64, max_pairs=1 << 12, chunk_pairs=256)
TIMEOUT_S = 120


def ring(n, w=W, h=H):
    cams = [np_lookat((4.0 * np.sin(a), 0.4, -4.0 * np.cos(a)), w, h)
            for a in np.linspace(0, 2 * np.pi, n, endpoint=False)]
    return np.stack([c[0] for c in cams]), np.stack([c[1] for c in cams])


def activated(seed, n):
    """The JAX package's activated args of a numpy cloud, as numpy."""
    a = jt.activate_cloud(jax_cloud(np_cloud(seed, n)))
    return {k: np.asarray(getattr(a, k)) for k in
            ("means3d", "colors", "rotations", "opacities", "scales", "means2d_offset")}


def jax_args(a):
    return jt.RenderArgs(**{k: jnp.asarray(v) for k, v in a.items()})


def port_args(a, grad=False):
    t = {k: torch.from_numpy(v.copy()).requires_grad_(grad) for k, v in a.items()}
    return RenderArgs(**t), t


def scaled(a, b):
    """max |a - b| over each row scaled by the row's largest |b|."""
    a, b = np.asarray(a).reshape(len(a), -1), np.asarray(b).reshape(len(b), -1)
    return float((np.abs(a - b) / np.maximum(np.abs(b).max(1, keepdims=True), 1e-12)).max())


def single_process_grads(a, w2c, K, images, weights, renderer):
    """The port's one-process gradients of 0.8 l1 + 0.2 ssim over the views."""
    args, leaves = port_args(a, grad=True)
    total = 0.0
    for i in range(len(w2c)):
        cam = Camera(w2c=torch.from_numpy(w2c[i]), K=torch.from_numpy(K[i]), width=W, height=H)
        img = render(args, cam, impl=renderer, config=BinningConfig(**BIN)).image
        t = torch.from_numpy(images[i])[None]
        l1 = (img - t).abs().mean() * float(weights[i])
        s = (1.0 - ssim(img, t)) * float(weights[i])
        total = total + 0.8 * l1 + 0.2 * s
    names = [k for k in leaves if k != "means2d_offset"]
    return dict(zip(names, (g.numpy() for g in torch.autograd.grad(total, [leaves[k] for k in names]))))


@pytest.mark.parametrize("v,axis", [(3, 2), (5, 2), (6, 4), (4, 4)])
def test_pad_views_and_picks_match_jax(v, axis):
    rng = np.random.default_rng(v)
    w2c = rng.normal(size=(v, 4, 4)).astype(np.float32)
    K = rng.normal(size=(v, 3, 3)).astype(np.float32)
    imgs = rng.uniform(size=(v, 3, 4, 5)).astype(np.float32)
    got = pad_views(torch.from_numpy(w2c), torch.from_numpy(K), torch.from_numpy(imgs), axis)
    want = jpad_views(jnp.asarray(w2c), jnp.asarray(K), jnp.asarray(imgs), axis)
    for g, w_ in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    pick = rng.permutation(9)[:v].astype(np.int32)
    gp, gw = pad_picks(torch.from_numpy(pick), axis)
    jp, jw = jpad_picks(jnp.asarray(pick), axis)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(gw.numpy(), np.asarray(jw))


def test_mesh_grid_over_four_ranks(tmp_path):
    got = launch(ranks.grid_on_rank, 4, (2, 2), tmp_path, device="cpu", timeout_s=TIMEOUT_S)
    # Row-major like JAX's reshape: rank r at (r // tiles, r % tiles).
    jm = jget_mesh(camera_axis=2, tile_axis=2, devices=jax.devices()[:4])
    ids = [[d.id for d in row] for row in jm.devices]
    for r, cell in enumerate(got):
        c, t = cell["cell"]
        assert (cell["rank"], c, t) == (r, r // 2, r % 2)
        assert ids[c][t] == jax.devices()[r].id
        assert cell["tiles"] == [2 * c, 2 * c + 1] and cell["cameras"] == [t, t + 2]
        assert cell["refused"] == "mesh 3x2 != 4 ranks"
        assert cell["jax_modules"] == []
    m = tmesh.get_mesh()  # no process group: the one-cell grid
    assert (m.shape, m.rank, m.groups["world"]) == ({"cameras": 1, "tiles": 1}, 0, None)


def test_initialize_multihost_wiring(monkeypatch):
    calls = []
    monkeypatch.setattr(tmesh.dist, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    tmesh.initialize_multihost()
    tmesh.initialize_multihost(num_processes=1)
    assert calls == []
    tmesh.initialize_multihost("10.0.0.1:1234", 2, 1, device="cpu")
    assert calls == [(("gloo",), dict(init_method="tcp://10.0.0.1:1234", world_size=2, rank=1,
                                       timeout=tmesh.TIMEOUT))]
    assert tmesh.default_backend("cpu", 1) == "gloo"


@pytest.mark.parametrize("renderer", ["stream", "plain"])
def test_camera_sharded_losses_match_jax(tmp_path, renderer):
    a = activated(0, 40)
    w2c, K = ring(4)
    images = np.random.default_rng(1).uniform(size=(4, 3, H, W)).astype(np.float32)
    weights = np.ones(4, np.float32)
    got = launch(ranks.losses_on_rank, 2, (a, dict(width=W, height=H), w2c, K, images, weights, 2,
                                           1, renderer, BinningConfig(**BIN), "cpu"), tmp_path,
                 device="cpu", timeout_s=TIMEOUT_S)
    jm = jget_mesh(camera_axis=2, tile_axis=1, devices=jax.devices()[:2])
    jl1, jss, _, _ = jax.jit(jcam(jm, jt.Camera(w2c=jnp.asarray(w2c[0]), K=jnp.asarray(K[0]),
                                                 width=W, height=H),
                                  "stream", JBinningConfig(**BIN)))(
        jax_args(a), jnp.asarray(w2c), jnp.asarray(K), jnp.asarray(images), jnp.asarray(weights))
    want = single_process_grads(a, w2c, K, images, weights, renderer)
    for r in got:
        assert r["jax_modules"] == []
        assert r["l1"] == pytest.approx(float(jl1), rel=1e-5)
        assert r["ssim"] == pytest.approx(float(jss), rel=1e-5)
        assert r["overflow"] == 0.0
        for k, g in want.items():
            assert scaled(r["grads"][k], g) <= 1e-5, k
    # Every rank rendered its own two views.
    assert all(r["l1"] == got[0]["l1"] for r in got)


def test_padding_and_masking(tmp_path):
    """3 views on 2 camera ranks: padded to 4, the padding weighing 0."""
    a = activated(1, 30)
    w2c, K = ring(3)
    images = np.zeros((3, 3, H, W), np.float32)
    pw, pK, pi, wts = (x.numpy() for x in pad_views(torch.from_numpy(w2c), torch.from_numpy(K),
                                                    torch.from_numpy(images), 2))
    assert pw.shape[0] == 4 and float(wts.sum()) == 3.0
    got = launch(ranks.losses_on_rank, 2, (a, dict(width=W, height=H), pw, pK, pi, wts, 2, 1,
                                           "stream", BinningConfig(**BIN), "cpu"), tmp_path,
                 device="cpu", timeout_s=TIMEOUT_S)
    jm = jget_mesh(camera_axis=2, tile_axis=1, devices=jax.devices()[:2])
    jl1, jss, _, _ = jax.jit(jcam(jm, jt.Camera(w2c=jnp.asarray(w2c[0]), K=jnp.asarray(K[0]),
                                                 width=W, height=H),
                                  "stream", JBinningConfig(**BIN)))(
        jax_args(a), *(jnp.asarray(x) for x in (pw, pK, pi, wts)))
    want = single_process_grads(a, w2c, K, images, np.ones(3), "stream")
    for r in got:
        assert r["l1"] == pytest.approx(float(jl1), rel=1e-5)
        assert r["ssim"] == pytest.approx(float(jss), rel=1e-5)
        for k, g in want.items():
            assert scaled(r["grads"][k], g) <= 1e-5, k


def test_2d_sharded_losses_match_jax(tmp_path):
    a = activated(5, 40)
    w2c, K = ring(4)
    images = np.random.default_rng(2).uniform(size=(4, 3, H, W)).astype(np.float32)
    weights = np.ones(4, np.float32)
    b16 = dict(BIN, tile=16, chunk_pairs=128)
    got = launch(ranks.losses_on_rank, 4, (a, dict(width=W, height=H), w2c, K, images, weights, 2,
                                           2, "stream", BinningConfig(**b16), "cpu"), tmp_path,
                 device="cpu", timeout_s=TIMEOUT_S)
    jm = jget_mesh(camera_axis=2, tile_axis=2, devices=jax.devices()[:4])
    jl1, jss, _, _ = jax.jit(j2d(jm, jt.Camera(w2c=jnp.asarray(w2c[0]), K=jnp.asarray(K[0]),
                                                width=W, height=H),
                                 "stream", JBinningConfig(**b16)))(
        jax_args(a), jnp.asarray(w2c), jnp.asarray(K), jnp.asarray(images), jnp.asarray(weights))
    args, leaves = port_args(a, grad=True)
    total = 0.0
    for i in range(4):
        cam = Camera(w2c=torch.from_numpy(w2c[i]), K=torch.from_numpy(K[i]), width=W, height=H)
        img = render(args, cam, impl="stream", config=BinningConfig(**b16)).image
        t = torch.from_numpy(images[i])[None]
        total = total + 0.8 * (img - t).abs().mean() + 0.2 * (1.0 - ssim(img, t))
    names = [k for k in leaves if k != "means2d_offset"]
    want = dict(zip(names, torch.autograd.grad(total, [leaves[k] for k in names])))
    for r in got:
        assert r["l1"] == pytest.approx(float(jl1), rel=1e-5)
        assert r["ssim"] == pytest.approx(float(jss), rel=1e-5)
        for k, g in want.items():
            np.testing.assert_allclose(r["grads"][k], g.numpy(), rtol=2e-3, atol=2e-5,
                                       err_msg=k)


def test_launcher_raises_on_a_failing_or_hung_rank(tmp_path):
    with pytest.raises(RankFailure, match="ZeroDivisionError"):
        launch(operator.truediv, 2, (1, 0), tmp_path / "fail", device="cpu", timeout_s=TIMEOUT_S)
    t0 = time.monotonic()
    with pytest.raises(RankFailure, match="timed out after 5 s"):
        launch(time.sleep, 2, (600,), tmp_path / "hang", device="cpu", timeout_s=5)
    assert time.monotonic() - t0 < 60
    assert launch(operator.add, 2, (2, 3), tmp_path / "ok", device="cpu", timeout_s=TIMEOUT_S) == [5, 5]


FAKE_NVCC = """#!{python}
import os, subprocess, sys
with open({log!r}, "a") as f:
    f.write(f"{{os.getppid()}}\\n")
out = sys.argv[sys.argv.index("-o") + 1]
if "-shared" in sys.argv:
    src = out + ".c"
    open(src, "w").write('const char *splatpu_cuda_error_string(int c) {{ return "stub"; }}\\n')
    subprocess.run(["gcc", "-shared", "-fPIC", "-o", out, src], check=True)
else:
    open(out, "w").close()
"""


def test_one_build_per_host_under_ranks(tmp_path, monkeypatch):
    """Three ranks load the kernel library at once; a stub nvcc logs the
    process that ran it: one rank compiled every source and linked, the
    others waited and loaded its library."""
    cuda = tmp_path / "cuda"
    (cuda / "bin").mkdir(parents=True)
    log = tmp_path / "nvcc.log"
    nvcc = cuda / "bin" / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    (build / "knn").mkdir(parents=True)
    (build / "knn" / "keep").write_text("kNN library of another rank")
    monkeypatch.setenv("CUDA_HOME", str(cuda))
    monkeypatch.setenv("SPLATPU_TORCH_BUILD_DIR", str(build))
    pids = launch(ranks.build_on_rank, 3, (), tmp_path / "rdv", device="cpu", timeout_s=TIMEOUT_S)
    callers = log.read_text().split()
    from splatpu_torch import _build

    assert len(callers) == len(_build.sources()) + 1
    assert set(callers) == {str(pids[0])}
    assert (build / "libsplatpu_kernels.so").is_file()
    assert (build / "knn" / "keep").is_file()
    assert len(set(pids)) == 3 and os.getpid() not in pids
