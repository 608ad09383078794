"""The port's stage-2 ``train()`` against the JAX package's, and the Adam
state carried across from a JAX checkpoint.

- 2 timesteps x 2 sequence iterations of both trainers from the same
  initial network (the port's draw from ``key(seed)``, held bit for bit
  against the JAX package's, handed in as ``initial_net``), the same
  numpy cloud and views, the JAX renderer "pallas" (interpret mode): the
  per-step losses, the final parameters and the last metrics, under each
  view staging ("device", "device_u8", "host", "device_rotate" with a
  rotation every sequence iteration) and view batching ("vmap", "map");
  and with no network handed in, each trainer drawing its own from the
  config's seed (faithful and zero-init heads);
- resume: JAX trains 2 of 3 sequence iterations writing a checkpoint, then
  JAX and the port each resume from that file to the third, step for step;
  a checkpoint the port writes restores in JAX's ``load_checkpoint``;
- ``mesh_tiles`` 2 without ``mesh_cameras`` trains on one device in both
  packages, the port's bitwise as with ``mesh_tiles`` 1;
- an ``on_iteration`` early stop; an unknown ``view_staging`` refused;
- the Adam state of runs/config3_100k_r5/stage2_ckpt.msgpack read by the
  port (no flax) bit-exact against flax's reader, and one Adam step from
  that state against optax's;
- view staging: uint8 views are never re-scaled.
"""

import dataclasses
from fractions import Fraction
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
from splatpu_torch.core import prng
from splatpu_torch.dynamics.network import (
    DeformationNet,
    DeformationNetConfig,
    init_deformation_net,
    net_config_for,
    net_params_to_jax_tree,
    state_dict_from_jax,
)
from splatpu_torch.io.checkpoint import load_checkpoint, load_stage2_opt_state
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


def port_net(jcfg, seed=3):
    """The port's initial network from ``key(seed)`` (and its numpy tree),
    which is the JAX package's draw bit for bit."""
    net = init_deformation_net(prng.key(seed), DeformationNetConfig(
        **dataclasses.asdict(jcfg.net_config())), device="cpu")
    init = jax.tree.map(np.asarray, jinit(jax.random.key(seed), jcfg.net_config()))
    for got, want in zip(jax.tree.leaves(net_params_to_jax_tree(net)), jax.tree.leaves(init)):
        np.testing.assert_array_equal(got, want)
    return net, init


def assert_steps_match(j_rows, t_rows):
    """Per-step losses 1e-5 relative, the learning rate exactly, no
    overflow, gradient norms 1e-3 relative."""
    assert [s for s, _ in t_rows] == [s for s, _ in j_rows]
    for (_, jm), (_, tm) in zip(j_rows, t_rows):
        for key in ("total", "l1", "ssim", "rigidity"):
            assert tm[key] == pytest.approx(jm[key], rel=1e-5, abs=1e-8), key
        assert tm["learning_rate"] == jm["learning_rate"]
        assert tm["binning_overflow"] == jm["binning_overflow"] == 0.0
        assert tm["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-3)


def assert_params_match(j_params, t_net, start):
    """The parameters agree to 2e-2 of how far they moved from ``start``."""
    got = net_params_to_jax_tree(t_net)
    for (path, want), g, s0 in zip(
        jax.tree_util.tree_leaves_with_path(j_params), jax.tree.leaves(got),
        jax.tree.leaves(start),
    ):
        moved = np.abs(np.asarray(want) - s0).max()
        assert moved > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, np.asarray(want), rtol=0, atol=2e-2 * moved,
                                   err_msg=jax.tree_util.keystr(path))


def both_views(vs):
    return ([[jds.ViewData(**v) for v in per_t] for per_t in vs],
            [[tds.ViewData(**v) for v in per_t] for per_t in vs])


@pytest.mark.parametrize("order,staging,u8,k,extra", [
    ("sequential", "device", False, 1, {}),
    ("shuffled", "device_u8", True, 2, {}),
    ("sequential", "host", False, 1, {}),
    ("shuffled", "device_rotate", True, 1, {"resident_cameras": 2, "restage_every": 1}),
    ("sequential", "device", False, 1, {"view_batching": "map"}),
], ids=["device", "device_u8", "host", "device_rotate", "map"])
def test_train_matches_jax(order, staging, u8, k, extra):
    cloud = np_cloud(11, 256)
    j_views, t_views = both_views(views(12, u8))
    common = dict(total_iterations=2, warmup_iterations=1, hidden_dim=32, residual_blocks=2,
                  views_per_step=2, timestep_count=2, view_staging=staging,
                  steps_per_timestep=k, timestep_order=order, overflow_check_every=1, seed=3,
                  **extra)
    jcfg = js2.Stage2Config(renderer="pallas", compute_dtype="float32", **common)
    tcfg = ts2.Stage2Config(renderer="plain", **common)
    j_log, t_log = Recorder(), Recorder()
    j_params, j_cloud, _, j_met = js2.train(jax_cloud(cloud), j_views, jcfg, logger=j_log)
    net, init = port_net(jcfg)
    t_net, t_cloud, _, t_met = ts2.train(torch_cloud(cloud), t_views, tcfg, logger=t_log,
                                         initial_net=net, device="cpu")

    assert t_cloud.capacity == j_cloud.capacity == 256
    assert [s for s, _ in j_log.rows] == [1, 2, 3, 4]
    assert_steps_match(j_log.rows, t_log.rows)
    # After 4 x k Adam steps the parameters agree to a small part of how far
    # they moved.
    assert_params_match(j_params, t_net, init)
    assert float(t_met["total"]) == pytest.approx(float(j_met["total"]), rel=1e-5)


@pytest.mark.parametrize("zero_init_head", [False, True], ids=["faithful", "zero_init"])
def test_train_from_seed_matches_jax(zero_init_head):
    """No network handed in: both trainers draw their own from
    ``key(config.seed)``; the same losses (1e-5) and parameters."""
    cloud = np_cloud(11, 256)
    j_views, t_views = both_views(views(12, False))
    common = dict(total_iterations=2, warmup_iterations=1, hidden_dim=32, residual_blocks=2,
                  views_per_step=2, timestep_count=2, overflow_check_every=1, seed=5,
                  zero_init_head=zero_init_head)
    jcfg = js2.Stage2Config(renderer="pallas", compute_dtype="float32", **common)
    j_log, t_log = Recorder(), Recorder()
    j_params, *_ = js2.train(jax_cloud(cloud), j_views, jcfg, logger=j_log)
    t_net, *_ = ts2.train(torch_cloud(cloud), t_views,
                          ts2.Stage2Config(renderer="plain", **common), logger=t_log,
                          device="cpu")
    assert [s for s, _ in t_log.rows] == [s for s, _ in j_log.rows] == [1, 2, 3, 4]
    assert_steps_match(j_log.rows, t_log.rows)
    _, init = port_net(jcfg, seed=5)
    assert_params_match(j_params, t_net, init)


def test_mesh_tiles_alone_trains_on_one_device():
    """``mesh_tiles`` 2 without ``mesh_cameras``: JAX's ``train`` builds
    its single-device step (``splatpu/train/stage2.py:469``); the port's
    trains in this process, matching JAX's and bitwise its own
    ``mesh_tiles`` 1 run."""
    cloud = np_cloud(11, 256)
    j_views, t_views = both_views(views(12, False))
    common = dict(total_iterations=2, warmup_iterations=1, hidden_dim=32, residual_blocks=2,
                  views_per_step=2, timestep_count=2, overflow_check_every=1, seed=3)
    jcfg = js2.Stage2Config(renderer="pallas", compute_dtype="float32", mesh_tiles=2, **common)
    j_log = Recorder()
    j_params, _, _, _ = js2.train(jax_cloud(cloud), j_views, jcfg, logger=j_log)
    runs = []
    for tiles in (2, 1):
        net, init = port_net(jcfg)
        log = Recorder()
        t_net, *_ = ts2.train(torch_cloud(cloud), t_views,
                              ts2.Stage2Config(renderer="plain", mesh_tiles=tiles, **common),
                              logger=log, initial_net=net, device="cpu")
        runs.append(([(step, {k: v for k, v in m.items() if k != "step_ms"})
                      for step, m in log.rows], t_net.state_dict()))
    assert_steps_match(j_log.rows, runs[0][0])
    assert_params_match(j_params, net_of(runs[0][1]), init)
    assert runs[0][0] == runs[1][0]
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k


def net_of(state_dict) -> DeformationNet:
    net = DeformationNet(net_config_for(state_dict))
    net.load_state_dict(state_dict)
    return net


def test_resume_from_jax_checkpoint_matches_jax(tmp_path):
    """JAX trains sequence iterations 0 and 1 of 3, checkpointing each, and
    stops; JAX and the port resume from that file (seq_it 1) and train
    iteration 2: the same steps (5, 6), losses and parameters.  Then the
    port's own checkpoint of iteration 2 restores in JAX's
    ``load_checkpoint`` with JAX's template, equal to the port's state."""
    from splatpu.io.checkpoint import load_checkpoint as jax_load_checkpoint

    cloud = np_cloud(11, 256)
    j_views, t_views = both_views(views(12, False))
    ckpt = tmp_path / "jax_ckpt.msgpack"
    common = dict(total_iterations=3, warmup_iterations=1, hidden_dim=32, residual_blocks=2,
                  views_per_step=2, timestep_count=2, overflow_check_every=1, seed=3,
                  checkpoint_every=1)
    jcfg = js2.Stage2Config(renderer="pallas", compute_dtype="float32",
                            checkpoint_path=str(ckpt), **common)
    js2.train(jax_cloud(cloud), j_views, jcfg, on_iteration=lambda it, *a: it == 1)
    start = jax.tree.map(np.asarray,
                         serialization.msgpack_restore(ckpt.read_bytes())["net_params"])
    start = dict(start, blocks=[start["blocks"][str(i)] for i in range(len(start["blocks"]))])

    j_log, t_log = Recorder(), Recorder()
    j_params, *_ = js2.train(jax_cloud(cloud), j_views,
                             dataclasses.replace(jcfg, checkpoint_path=None),
                             logger=j_log, resume_from=str(ckpt))
    port_ckpt = tmp_path / "port_ckpt.msgpack"
    tcfg = ts2.Stage2Config(renderer="plain", checkpoint_path=str(port_ckpt), **common)
    t_net, *_ = ts2.train(torch_cloud(cloud), t_views, tcfg, logger=t_log,
                          resume_from=str(ckpt), device="cpu")
    assert [s for s, _ in j_log.rows] == [5, 6]
    assert_steps_match(j_log.rows, t_log.rows)
    assert_params_match(j_params, t_net, start)

    template = {
        "net_params": jinit(jax.random.key(0), jcfg.net_config()),
        "opt_state": joptim.make_stage2_optimizer(1e-3, 2, 6).init(
            jinit(jax.random.key(0), jcfg.net_config())),
        "seq_it": jnp.int32(0), "max_pairs": jnp.int32(0), "max_span": jnp.int32(0),
        "growths": jnp.int32(0),
    }
    restored = jax_load_checkpoint(port_ckpt, template)
    assert int(restored["seq_it"]) == 2 and int(restored["growths"]) == 0
    assert int(restored["opt_state"][0].count) == int(restored["opt_state"][1].count) == 6
    want = net_params_to_jax_tree(t_net)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree.leaves(restored["net_params"])):
        assert np.array_equal(np.asarray(g), w), jax.tree_util.keystr(path)


def test_on_iteration_stops_after_its_checkpoint(tmp_path):
    """A truthy ``on_iteration`` return ends the loop after that sequence
    iteration, whose checkpoint is written first; the callback sees the
    network and the resolved config."""
    ckpt = tmp_path / "ckpt.msgpack"
    seen = []

    def stop(seq_it, net, config, metrics):
        seen.append((seq_it, ckpt.exists(), config.binning is not None, float(metrics["total"])))
        return seq_it == 0

    log = Recorder()
    cfg = ts2.Stage2Config(renderer="plain", total_iterations=3, warmup_iterations=1,
                           hidden_dim=16, residual_blocks=1, views_per_step=2, timestep_count=2,
                           checkpoint_every=1, checkpoint_path=str(ckpt))
    ts2.train(torch_cloud(np_cloud(1, 64)), both_views(views(1, False))[1], cfg, logger=log,
              on_iteration=stop, device="cpu")
    assert [s for s, _ in log.rows] == [1, 2]
    assert len(seen) == 1 and seen[0][:3] == (0, True, True) and np.isfinite(seen[0][3])
    assert int(load_checkpoint(ckpt)["seq_it"]) == 0


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


ULPS = 2  # optax's float32 bias corrections against the correctly rounded (ulps)


def nearest_f32(x: Fraction) -> np.float32:
    """The float32 nearest the rational ``x`` (ties need not be broken: the
    test's values are not halfway)."""
    c = np.float32(float(x))
    cands = (np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf)))
    return min(cands, key=lambda f: abs(Fraction(float(f)) - x))


def test_adam_step_from_checkpoint_matches_optax():
    """One Adam step from the checkpoint's state (count 6,000 -> 6,001),
    the port's against optax's on the same gradients.

    The moments take the same float32 operations in the same order, so
    ``mu`` and ``nu`` are held bitwise.  The bias corrections 1 - b^6001
    come from two float32 pows: the port's (numpy) is held to the correctly
    rounded value (``fractions.Fraction``), optax's (JAX's eager pow, as
    its update runs here) to within ULPS ulps of it (two ulps less for
    b = 0.999 on an AMD EPYC CPU).

    The parameters p' = p + u, u = -lr (mu / bc1) / (sqrt(nu / bc2) + eps).
    With eps32 = 2^-24 (float32's unit roundoff), elementwise:
    - an ulp of a bias correction in [0.5, 1] is at most 2 eps32 of it, so
      ULPS ulps of bc2 move nu / bc2 by 2 ULPS eps32 and its square root by
      ULPS eps32 (adding eps only dilutes that), and ULPS ulps of bc1 move
      u by 2 ULPS eps32: together 3 ULPS eps32 |u| = 6 eps32 |u|;
    - each side rounds six operations (nu / bc2, sqrt, + eps, mu / bc1, the
      quotient, the product with -lr), each by at most eps32 relative, so a
      side is within 6.1 eps32 |u| of its exact u: 12.2 eps32 |u| apart;
    - the learning rates (held to 1e-7 relative) may differ by d_lr |u|;
    - each side rounds p + u, by at most eps32 (|p| + |u|).
    So |p'_port - p'_optax| <= eps32 (21 |u| + 2 |p|) + d_lr |u|, with u
    optax's update.  Relative to |p + u| no bound holds: where p and u
    nearly cancel, an ulp of u is a large share of the sum (2.9e-11 against
    a sum of 9.7e-6 was seen)."""
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
    lr_jax = float(joptim.warmup_cosine_schedule(1e-3, warmup, total)(6000))
    assert lr == pytest.approx(lr_jax, rel=1e-7)
    count = int(new_state[0].count)
    assert adam.count == count == 6001
    for b, bc in zip((adam.b1, adam.b2), adam.bias_corrections(count)):
        exact = nearest_f32(1 - Fraction(float(np.float32(b))) ** count)
        bc_jax = np.asarray(1 - b ** jnp.asarray(count, jnp.int32))  # as optax's update
        assert np.float32(bc) == exact, (b, bc, exact)
        assert abs(int(exact.view(np.int32)) - int(bc_jax.view(np.int32))) <= ULPS, (b, bc_jax)
    for name, got, wt in (("mu", adam.mu, new_state[0].mu), ("nu", adam.nu, new_state[0].nu)):
        g_tree = net_params_to_jax_tree(got)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(wt), jax.tree.leaves(g_tree)):
            w = np.asarray(w)
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                          err_msg=f"{name} {jax.tree_util.keystr(path)}")
    eps32 = 2.0 ** -24
    d_lr = abs(lr - lr_jax) / lr_jax
    g_tree = net_params_to_jax_tree(tparams)
    leaves = zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(params),
                 jax.tree.leaves(updates), jax.tree.leaves(g_tree))
    for (path, w), p, u, g in leaves:
        w, p, u = (np.asarray(x, np.float64) for x in (w, p, u))
        bound = eps32 * (21 * np.abs(u) + 2 * np.abs(p)) + d_lr * np.abs(u)
        excess = np.abs(g - w) - bound
        assert (excess <= 0).all(), (
            f"params {jax.tree_util.keystr(path)}: {int((excess > 0).sum())} elements over the"
            f" bound, worst by {excess.max():.3e}")


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


def test_unknown_view_staging_raises():
    """An unknown ``view_staging`` is refused before anything runs (the JAX
    package treats any other string like "host" without the prefetch)."""
    cfg = ts2.Stage2Config(view_staging="hostt", timestep_count=2)
    with pytest.raises(ValueError, match="view_staging"):
        ts2.train(torch_cloud(np_cloud(1, 16)), both_views(views(1, False))[1], cfg,
                  device="cpu")
