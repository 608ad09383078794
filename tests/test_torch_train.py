"""The port's stage-2 ``train()`` against the JAX package's, and the Adam
state carried across from a JAX checkpoint.

- 2 timesteps x 2 sequence iterations of both trainers from the same
  initial network (``initial_net`` carries the JAX init across), the same
  numpy cloud and views, the JAX renderer "pallas" (interpret mode): the
  per-step losses, the final parameters and the last metrics;
- the Adam state of runs/config3_100k_r5/stage2_ckpt.msgpack read by the
  port (no flax) bit-exact against flax's reader, and one Adam step from
  that state against optax's;
- view staging: uint8 views are never re-scaled.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import splatpu.data.dataset as jds
import splatpu.train.optim as joptim
import splatpu.train.stage2 as js2
from splatpu.dynamics.network import init_deformation_net as jinit
import splatpu_torch.data.dataset as tds
import splatpu_torch.train.optim as toptim
import splatpu_torch.train.stage2 as ts2
from splatpu_torch.dynamics.network import (
    DeformationNet,
    net_config_for,
    net_params_to_jax_tree,
    state_dict_from_jax,
)
from splatpu_torch.io.checkpoint import load_stage2_opt_state
from _torch_scenes import jax_cloud, np_cloud, np_lookat, torch_cloud

torch.set_num_threads(1)

CKPT = Path(__file__).resolve().parent.parent / "runs" / "config3_100k_r5" / "stage2_ckpt.msgpack"
W, H = 48, 32
N_CAMS = 3


class Recorder:
    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    def flush(self):
        pass


def views(seed, u8):
    rng = np.random.default_rng(seed)
    out = []
    for t in range(2):
        per_t = []
        for c in range(N_CAMS):
            a = 2 * np.pi * c / N_CAMS
            w2c, K = np_lookat((3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)), W, H)
            img = rng.uniform(0.0, 1.0, (3, H, W)).astype(np.float32)
            if u8:
                img = np.rint(img * 255.0).astype(np.uint8)
            per_t.append(dict(camera_index=c, w2c=w2c, K=K, width=W, height=H, image=img,
                              segmentation=np.zeros((3, H, W), np.float32)))
        out.append(per_t)
    return out


@pytest.mark.parametrize("order,staging,u8,k", [
    ("sequential", "device", False, 1),
    ("shuffled", "device_u8", True, 2),
])
def test_train_matches_jax(order, staging, u8, k):
    cloud = np_cloud(11, 256)
    vs = views(12, u8)
    common = dict(total_iterations=2, warmup_iterations=1, hidden_dim=32, residual_blocks=2,
                  views_per_step=2, timestep_count=2, view_staging=staging,
                  steps_per_timestep=k, timestep_order=order, overflow_check_every=1, seed=3)
    jcfg = js2.Stage2Config(renderer="pallas", compute_dtype="float32", **common)
    tcfg = ts2.Stage2Config(renderer="plain", **common)
    j_log, t_log = Recorder(), Recorder()
    j_params, j_cloud, _, j_met = js2.train(
        jax_cloud(cloud), [[jds.ViewData(**v) for v in per_t] for per_t in vs], jcfg,
        logger=j_log)
    init = jax.tree.map(np.asarray, jinit(jax.random.key(3), jcfg.net_config()))
    sd = state_dict_from_jax(init)
    net = DeformationNet(net_config_for(sd))
    net.load_state_dict(sd)
    t_net, t_cloud, _, t_met = ts2.train(
        torch_cloud(cloud), [[tds.ViewData(**v) for v in per_t] for per_t in vs], tcfg,
        logger=t_log, initial_net=net, device="cpu")

    assert t_cloud.capacity == j_cloud.capacity == 256
    steps = [s for s, _ in j_log.rows]
    assert [s for s, _ in t_log.rows] == steps == [1, 2, 3, 4]
    for (_, jm), (_, tm) in zip(j_log.rows, t_log.rows):
        for key in ("total", "l1", "ssim", "rigidity"):
            assert tm[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-8), key
        assert tm["learning_rate"] == jm["learning_rate"]
        assert tm["binning_overflow"] == jm["binning_overflow"] == 0.0
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-3)
    # After 4 x k Adam steps the parameters agree to a small part of how far
    # they moved.
    got = net_params_to_jax_tree(t_net)
    for (path, want), g, start in zip(
        jax.tree_util.tree_leaves_with_path(j_params), jax.tree.leaves(got),
        jax.tree.leaves(init),
    ):
        moved = np.abs(np.asarray(want) - start).max()
        assert moved > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=2e-2 * moved,
                                   err_msg=jax.tree_util.keystr(path))
    assert float(t_met["total"]) == pytest.approx(float(j_met["total"]), rel=1e-5)


def jax_opt_tree():
    return serialization.msgpack_restore(CKPT.read_bytes())["opt_state"]


def test_opt_state_reader_bit_exact():
    ref = jax_opt_tree()
    got = load_stage2_opt_state(CKPT)
    assert got["count"] == int(ref["0"]["count"]) == int(ref["1"]["count"]) == 6000
    for name in ("mu", "nu"):
        tree = net_params_to_jax_tree(got[name])
        want = ref["0"][name]
        want = dict(want, blocks=[want["blocks"][str(i)] for i in range(len(want["blocks"]))])
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(tree)):
            assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(path)
            assert np.array_equal(g, w), jax.tree_util.keystr(path)


def test_adam_step_from_checkpoint_matches_optax():
    ref = jax_opt_tree()
    raw = serialization.msgpack_restore(CKPT.read_bytes())["net_params"]
    params = {"fc_in": raw["fc_in"], "fc_out": raw["fc_out"],
              "blocks": [raw["blocks"][str(i)] for i in range(len(raw["blocks"]))]}
    params = jax.tree.map(jnp.asarray, params)
    # A schedule still mid-cosine at the checkpoint's count of 6,000.
    warmup, total = 16, 8000
    opt = joptim.make_stage2_optimizer(1e-3, warmup, total)
    state = serialization.from_state_dict(opt.init(params), {"0": ref["0"], "1": ref["1"]})
    rng = np.random.default_rng(9)
    grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32) * 1e-2),
                         params)
    updates, new_state = opt.update(grads, state, params)
    want = jax.tree.map(lambda p, u: p + u, params, updates)

    sd = state_dict_from_jax(raw)
    tparams = {k: v.clone() for k, v in sd.items()}
    adam = toptim.make_stage2_optimizer(tparams, 1e-3, warmup, total)
    adam.load_state(**load_stage2_opt_state(CKPT))
    lr = adam.step(tparams, state_dict_from_jax(grads))
    assert lr == pytest.approx(float(joptim.warmup_cosine_schedule(1e-3, warmup, total)(6000)),
                               rel=1e-7)
    assert adam.count == int(new_state[0].count) == 6001
    # Float32 Adam in both; pow() of the bias correction may differ by an ulp.
    for name, got, wt in (
        ("params", tparams, want), ("mu", adam.mu, new_state[0].mu), ("nu", adam.nu, new_state[0].nu),
    ):
        g_tree = net_params_to_jax_tree(got)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(wt), jax.tree.leaves(g_tree)):
            w = np.asarray(w)
            np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-12,
                                       err_msg=f"{name} {jax.tree_util.keystr(path)}")


def test_view_staging_keeps_uint8_levels():
    per_t = views(1, u8=True)[0]
    vd = [tds.ViewData(**v) for v in per_t]
    raw = np.stack([v.image for v in vd])
    _, _, dev_f32 = ts2._stage(vd, "device", "cpu")
    _, _, dev_u8 = ts2._stage(vd, "device_u8", "cpu")
    assert dev_u8.dtype == torch.uint8 and np.array_equal(dev_u8.numpy(), raw)
    np.testing.assert_array_equal(dev_f32.numpy(), raw.astype(np.float32) / 255.0)
    floats = [tds.ViewData(**dict(v, image=v["image"].astype(np.float32) / 255.0)) for v in per_t]
    _, _, q = ts2._stage(floats, "device_u8", "cpu")
    assert np.array_equal(q.numpy(), raw)


def test_unported_staging_raises():
    per_t = views(1, u8=False)
    cfg = ts2.Stage2Config(view_staging="host", timestep_count=2)
    with pytest.raises(NotImplementedError):
        ts2.train(torch_cloud(np_cloud(1, 16)),
                  [[tds.ViewData(**v) for v in p] for p in per_t], cfg, device="cpu")
