"""The port's distributed trainers, run as gloo ranks on the CPU through
``splatpu_torch.dist.launch``:

- ``make_sharded_train_step`` on 2 camera ranks against the JAX package's
  on the first 2 virtual CPU devices, from the JAX package's initial
  network (carried across with ``state_dict_from_jax``), two steps, 5 views
  padded to 6: losses 1e-5 relative, the parameters within 2e-2 of how far
  they moved (the stage-2 gate of ``test_torch_train.py``);
- ``stage2.train(mesh_cameras=2)`` (host staging: the padded picks'
  views copied ahead) and ``stage2.train(mesh_cameras=2, mesh_tiles=2)``
  (4 ranks) against the port's own single-process run, and
  ``stage1.fit(mesh_tiles=2)`` against its single-process fit, with the JAX
  package's gates for the same comparison (``tests/test_dist.py:197,
  222-229, 315``): stage 2's parameters rtol 2e-3, atol 2e-5; stage 1's
  means and opacity logits rtol 1e-4, atol 1e-6; and every logged loss
  1e-5 relative, the alive masks identical, and every rank's parameters
  bitwise equal to rank 0's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.train.stage2 as js2
from splatpu.core.types import Camera as JCamera
from splatpu.dist.mesh import get_mesh as jget_mesh
from splatpu.dist.sharding import pad_picks as jpad_picks
from splatpu.dist.train_step import make_sharded_train_step as jstep
from splatpu.render.binning import BinningConfig as JBinningConfig
from splatpu_torch.dist import ranks
from splatpu_torch.dist.launch import launch
from splatpu_torch.dynamics.network import net_params_to_jax_tree, state_dict_from_jax
from splatpu_torch.growth.densify import DensifyConfig
from splatpu_torch.render.binning import BinningConfig
from _torch_scenes import jax_cloud, np_cloud, np_lookat

torch.set_num_threads(1)

W = H = 32
BIN = dict(max_span=64, max_pairs=1 << 12, chunk_pairs=256)
BIN16 = dict(tile=16, max_span=64, max_pairs=1 << 12, chunk_pairs=128)
TIMEOUT_S = 180


def ring_views(n_cams, n_timesteps, rng, w=W, h=H):
    out = []
    for _t in range(n_timesteps):
        per_t = []
        for i, a in enumerate(np.linspace(0, 2 * np.pi, n_cams, endpoint=False)):
            w2c, K = np_lookat((4.0 * np.sin(a), 0.4, -4.0 * np.cos(a)), w, h)
            per_t.append(dict(camera_index=i, w2c=w2c, K=K, width=w, height=h,
                              image=rng.random((3, h, w), dtype=np.float32),
                              segmentation=(rng.random((3, h, w)) > 0.5).astype(np.float32)))
        out.append(per_t)
    return out


def assert_rows_match(single, dist):
    assert [s for s, _ in dist] == [s for s, _ in single]
    for (_, a), (_, b) in zip(single, dist):
        for k in ("total", "l1", "ssim", "rigidity", "total_loss", "image_loss"):
            if k in a:
                assert b[k] == pytest.approx(a[k], rel=1e-5), k


def assert_ranks_equal(results, key):
    for r in results[1:]:
        for k, v in results[0][key].items():
            np.testing.assert_array_equal(r[key][k], v, err_msg=k)


def test_sharded_step_matches_jax(tmp_path):
    cloud = np_cloud(2, 48)
    rng = np.random.default_rng(0)
    views = ring_views(6, 1, rng)[0]
    w2c = np.stack([v["w2c"] for v in views])
    K = np.stack([v["K"] for v in views])
    images = np.stack([v["image"] for v in views])
    picks = [np.array([4, 0, 2, 5, 1]), np.array([3, 1, 5, 0, 2])]
    common = dict(total_iterations=2, warmup_iterations=1, hidden_dim=32, residual_blocks=1,
                  views_per_step=5, timestep_count=2, renderer="stream")
    jcfg = js2.Stage2Config(binning=JBinningConfig(**BIN), compute_dtype="float32",
                            mesh_cameras=2, **common)
    jc, fg, nbr, enc0, params0, optimizer, opt_state = js2.setup(jax_cloud(cloud), jcfg)
    step = jstep(optimizer, jcfg, jget_mesh(2, 1, devices=jax.devices()[:2]),
                 JCamera(w2c=jnp.asarray(w2c[0]), K=jnp.asarray(K[0]), width=W, height=H))
    enc, pfg = js2.snapshot_previous(jc, fg, nbr, jcfg.quirk_compat)
    params, j_rows = params0, []
    for t, pick in enumerate(picks, start=1):
        p, wts = jpad_picks(jnp.asarray(pick, jnp.int32), 2)
        params, opt_state, enc, pfg, aux = step(
            params, opt_state, enc, pfg, np.float32(t), jnp.asarray(w2c), jnp.asarray(K),
            jnp.asarray(images), p, wts, jc, enc0, fg, nbr)
        j_rows.append({k: float(v) for k, v in aux.items()})
    init = jax.tree.map(np.asarray, params0)
    sd = {k: v.numpy() for k, v in state_dict_from_jax(init).items()}
    got = launch(ranks.steps_on_rank, 2,
                 (cloud, w2c, K, images, picks, [1, 2],
                  dict(binning=BinningConfig(**BIN), mesh_cameras=2, **common), sd, "cpu"), tmp_path,
                 device="cpu", timeout_s=TIMEOUT_S)
    for r in got:
        assert r["jax_modules"] == []
        for jm, tm in zip(j_rows, r["rows"]):
            for k in ("total", "l1", "ssim", "rigidity"):
                assert tm[k] == pytest.approx(jm[k], rel=1e-5), k
            assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-3)
            assert tm["binning_overflow"] == jm["binning_overflow"] == 0.0
    assert_ranks_equal(got, "params")
    from splatpu_torch.dynamics.network import DeformationNet, net_config_for

    sd_got = {k: torch.from_numpy(v) for k, v in got[0]["params"].items()}
    net = DeformationNet(net_config_for(sd_got))
    net.load_state_dict(sd_got)
    mine = net_params_to_jax_tree(net)
    for (path, want), g, s0 in zip(jax.tree_util.tree_leaves_with_path(params),
                                   jax.tree.leaves(mine), jax.tree.leaves(init)):
        moved = np.abs(np.asarray(want) - s0).max()
        assert moved > 0
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=2e-2 * moved,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("cameras,tiles,renderer,binning,staging", [
    (2, 1, "stream", BIN, "host"), (2, 2, "plain", BIN16, "device")],
    ids=["cameras", "cameras_x_tiles"])
def test_stage2_train_distributed_matches_single_process(tmp_path, cameras, tiles, renderer,
                                                         binning, staging):
    rng = np.random.default_rng(0 if tiles == 1 else 7)
    cloud = np_cloud(2, 48)
    views = ring_views(6, 2, rng)
    cfg = dict(total_iterations=2, warmup_iterations=1, hidden_dim=32, residual_blocks=1,
               views_per_step=5, timestep_count=2, renderer=renderer,
               binning=BinningConfig(**binning), seed=3, overflow_check_every=1,
               view_staging=staging)
    single = ranks.train_on_rank(cloud, views, cfg, "cpu")["runs"][0]
    got = launch(ranks.train_on_rank, cameras * tiles,
                 (cloud, views, dict(cfg, mesh_cameras=cameras, mesh_tiles=tiles), "cpu"), tmp_path,
                 device="cpu", timeout_s=TIMEOUT_S)
    runs = [r["runs"][0] for r in got]
    assert all(r["jax_modules"] == [] for r in got)
    assert len(runs[0]["rows"]) == 4 and all(not r["rows"] for r in runs[1:])
    assert_rows_match(single["rows"], runs[0]["rows"])
    assert_ranks_equal(runs, "params")
    for k, v in single["params"].items():
        np.testing.assert_allclose(runs[0]["params"][k], v, rtol=2e-3, atol=2e-5, err_msg=k)


def test_stage1_fit_mesh_tiles_matches_single_process(tmp_path):
    rng = np.random.default_rng(1)
    n = 40
    pts = np.concatenate([rng.normal(size=(n, 3)).astype(np.float32) * 0.5,
                          rng.random((n, 3), dtype=np.float32),
                          (rng.random((n, 1)) > 0.5).astype(np.float32)], axis=1)
    views = ring_views(2, 1, rng)[0]
    cfg = dict(iterations=4, capacity_factor=1.5, renderer="stream",
               binning=BinningConfig(**BIN16), densify=DensifyConfig(
                   mutate_start=2, mutate_every=2, window_end=3, grad_threshold=1e-7))
    single = ranks.fit_on_rank(pts, views, 2.0, cfg, "cpu")
    got = launch(ranks.fit_on_rank, 2, (pts, views, 2.0, dict(cfg, mesh_tiles=2), "cpu"), tmp_path,
                 device="cpu", timeout_s=TIMEOUT_S)
    assert all(r["jax_modules"] == [] for r in got)
    assert_rows_match(single["rows"], got[0]["rows"])
    assert sorted(single["alive"]) == sorted(got[0]["alive"]) == [2]
    for i, mask in single["alive"].items():
        for r in got:
            np.testing.assert_array_equal(r["alive"][i], mask)
    assert_ranks_equal(got, "cloud")
    for k in ("means", "opacity_logits"):
        np.testing.assert_allclose(got[0]["cloud"][k], single["cloud"][k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    with pytest.raises(Exception, match="views_per_step > 1 cannot be combined with mesh_tiles"):
        ranks.fit_on_rank(pts, views, 2.0, dict(cfg, mesh_tiles=2, views_per_step=2), "cpu")
