"""Densification and the stage-1 optimizer, the port against the JAX package.

- ``split_normals`` (the port's split noise from a subkey) against the
  draws JAX's ``densify_and_prune`` makes from it, bit for bit;
- ``densify_and_prune`` handed the port's own draws from the key JAX's is
  handed (the split noise is an argument in the port): alive masks and the
  masks of zeroed ("fresh") moment rows identical, ``info`` counts equal,
  parameters and moments within 1e-6, the statistics reset; on scenes that
  clone, split and prune at once (iteration 600), with the final-window
  prune (0.25), the big-scale prune (from 3000), and a capacity overflow;
- ``reset_opacity``, ``accumulate_stats`` and ``accumulate_stats_batch``;
- ``Stage1Adam`` + ``apply_stage1_updates`` against optax's
  ``scale_by_adam(eps=1e-15)`` + the JAX package's ``apply_stage1_updates``
  over 5 steps, 1e-6 relative; the per-group learning rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.growth.densify as jd
import splatpu.train.optim as joptim
import splatpu_torch.growth.densify as td
import splatpu_torch.train.optim as toptim
from splatpu_torch.core import prng
from splatpu_torch.train.stage1 import split_normals
from _torch_scenes import jax_cloud, np_cloud, np_of, torch_cloud

torch.set_num_threads(1)

PARAMS = ("means", "colors", "segmentation_masks", "rotation_quaternions", "opacity_logits",
          "log_scales")
CFG = jd.DensifyConfig()


def scene(seed, n_alive=24, cap=64):
    """A cloud whose alive rows clone (hot, small), split (hot, large), are
    pruned (low opacity, or one over-large), moments nonzero everywhere,
    statistics with some rows never seen."""
    rng = np.random.default_rng(seed)
    cloud = np_cloud(seed, cap, n_dead=cap - n_alive)
    small = rng.uniform(size=cap) < 0.5
    cloud["log_scales"] = np.where(small[:, None], np.log(0.004), np.log(0.05)).astype(
        np.float32) + rng.uniform(-0.2, 0.2, (cap, 3)).astype(np.float32)
    cloud["log_scales"][3] = np.log(0.5)  # the big-prune candidate
    cloud["opacity_logits"] = rng.uniform(-7.0, 3.0, (cap, 1)).astype(np.float32)
    cloud["opacity_logits"][3] = 2.0
    vis = rng.integers(0, 4, cap).astype(np.float32)
    stats = {"grad_accum": (rng.uniform(0.0, 6e-4, cap) * vis).astype(np.float32),
             "vis_count": vis, "max_radii": rng.uniform(0.0, 9.0, cap).astype(np.float32)}
    moments = {m: {k: rng.uniform(0.5, 1.5, cloud[k].shape).astype(np.float32)
                   for k in PARAMS} for m in ("mu", "nu")}
    return cloud, stats, moments


def jax_state(moments, count=7):
    state = joptim.make_stage1_adam().init(
        {k: jnp.zeros(v.shape) for k, v in moments["mu"].items()})
    return state._replace(count=jnp.int32(count),
                          mu={k: jnp.asarray(v) for k, v in moments["mu"].items()},
                          nu={k: jnp.asarray(v) for k, v in moments["nu"].items()})


def port_adam(cloud_np, moments, count=7):
    adam = toptim.Stage1Adam({k: torch.from_numpy(cloud_np[k]) for k in PARAMS})
    adam.load_state(count, {k: torch.from_numpy(v) for k, v in moments["mu"].items()},
                    {k: torch.from_numpy(v) for k, v in moments["nu"].items()})
    return adam


def jax_normals(key, cap):
    """The draws JAX's densify_and_prune makes from ``key``."""
    k1, k2 = jax.random.split(key)
    return tuple(np.array(jax.random.normal(k, (cap, 3))) for k in (k1, k2))


@pytest.mark.parametrize("seed,cap", [(11, 64), (0, 500_224), (2**31 + 3, 1000)])
def test_split_normals_match_jax(seed, cap):
    """``train/stage1.py``'s ``split_normals(sub)`` against the draws JAX's
    densify_and_prune makes from ``sub`` (a stage-1 mutation's subkey),
    bit for bit (on a CPU with FMA; see ``test_torch_prng.py``)."""
    _, sub = jax.random.split(jax.random.PRNGKey(seed))
    _, tsub = prng.split(prng.key(seed))
    np.testing.assert_array_equal(tsub, np.asarray(sub))
    got = split_normals(tsub, cap, "cpu")
    for g, w in zip(got, jax_normals(sub, cap)):
        assert g.shape == (cap, 3) and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("case,i,n_alive,cap", [
    ("clone_split_prune", 600, 24, 64),
    ("final_window_prune", CFG.window_end, 24, 64),
    ("big_prune", 3000, 24, 64),
    ("capacity_overflow", 600, 40, 44),
])
def test_densify_matches_jax(case, i, n_alive, cap):
    cloud_np, stats_np, moments = scene(5 + i + cap, n_alive, cap)
    key = jax.random.PRNGKey(11)
    ref_cloud, ref_state, ref_stats, ref_info = jd.densify_and_prune(
        jax_cloud(cloud_np), jax_state(moments), jd.DensifyStats(
            **{k: jnp.asarray(v) for k, v in stats_np.items()}), key, i, 1.0, CFG)
    adam = port_adam(cloud_np, moments)
    normals = split_normals(prng.key(11), cap, "cpu")  # the port's own draw from the key
    got_cloud, got_adam, got_stats, got_info = td.densify_and_prune(
        torch_cloud(cloud_np), adam, td.DensifyStats(
            **{k: torch.from_numpy(v) for k, v in stats_np.items()}), normals, i, 1.0,
        td.DensifyConfig())
    assert got_adam is adam
    np.testing.assert_array_equal(np_of(got_cloud.alive), np.asarray(ref_cloud.alive))
    for k in ("cloned", "split", "pruned", "dropped_for_capacity", "n_alive"):
        assert int(got_info[k]) == int(ref_info[k]), k
    for k in PARAMS:
        np.testing.assert_allclose(np_of(getattr(got_cloud, k)), np.asarray(getattr(ref_cloud, k)),
                                   rtol=0, atol=1e-6, err_msg=k)
        for m in ("mu", "nu"):
            ref_m = np.asarray(getattr(ref_state, m)[k])
            got_m = np_of(getattr(adam, m)[k])
            np.testing.assert_array_equal(got_m == 0, ref_m == 0, err_msg=f"{m} {k} fresh rows")
            np.testing.assert_allclose(got_m, ref_m, rtol=0, atol=1e-6, err_msg=f"{m} {k}")
    for k in ("grad_accum", "vis_count", "max_radii"):
        assert not np_of(getattr(got_stats, k)).any() and not np.asarray(getattr(ref_stats, k)).any()
    if case == "clone_split_prune":
        assert all(int(ref_info[k]) > 0 for k in ("cloned", "split", "pruned"))
    if case == "capacity_overflow":
        assert int(ref_info["dropped_for_capacity"]) > 0
    if case == "big_prune":
        assert not bool(ref_cloud.alive[3])


def test_reset_opacity_matches_jax():
    cloud_np, _, moments = scene(3)
    ref_cloud, ref_state = jd.reset_opacity(jax_cloud(cloud_np), jax_state(moments), CFG)
    adam = port_adam(cloud_np, moments)
    got_cloud, _ = td.reset_opacity(torch_cloud(cloud_np), adam, td.DensifyConfig())
    np.testing.assert_array_equal(np_of(got_cloud.opacity_logits),
                                  np.asarray(ref_cloud.opacity_logits))
    for m in ("mu", "nu"):
        for k in PARAMS:
            np.testing.assert_array_equal(np_of(getattr(adam, m)[k]),
                                          np.asarray(getattr(ref_state, m)[k]), err_msg=k)


def test_accumulate_stats_match_jax():
    rng = np.random.default_rng(4)
    cap, v = 32, 4
    grads = rng.standard_normal((v, cap, 2)).astype(np.float32)
    radii = (rng.uniform(0, 6, (v, cap)) * (rng.uniform(size=(v, cap)) > 0.4)).astype(np.float32)
    start = {"grad_accum": rng.uniform(0, 1e-3, cap).astype(np.float32),
             "vis_count": rng.integers(0, 5, cap).astype(np.float32),
             "max_radii": rng.uniform(0, 4, cap).astype(np.float32)}
    jstats = jd.DensifyStats(**{k: jnp.asarray(x) for k, x in start.items()})
    tstats = td.DensifyStats(**{k: torch.from_numpy(x) for k, x in start.items()})
    ref_b = jd.accumulate_stats_batch(jstats, jnp.asarray(grads), jnp.asarray(radii))
    got_b = td.accumulate_stats_batch(tstats, torch.from_numpy(grads), torch.from_numpy(radii))
    ref_s, got_s = jstats, tstats
    for j in range(v):
        ref_s = jd.accumulate_stats(ref_s, jnp.asarray(grads[j]), jnp.asarray(radii[j]))
        got_s = td.accumulate_stats(got_s, torch.from_numpy(grads[j]), torch.from_numpy(radii[j]))
    for k in start:
        for got, ref in ((got_b, ref_b), (got_s, ref_s)):
            np.testing.assert_allclose(np_of(getattr(got, k)), np.asarray(getattr(ref, k)),
                                       rtol=1e-6, atol=0, err_msg=k)


def test_stage1_adam_matches_optax():
    rng = np.random.default_rng(8)
    cloud_np = np_cloud(8, 20)
    params_np = {k: cloud_np[k] for k in PARAMS}
    lrs = joptim.stage1_learning_rates(2.5)
    assert toptim.stage1_learning_rates(2.5) == lrs
    assert toptim.STAGE1_BASE_LRS == joptim.STAGE1_BASE_LRS
    jadam = joptim.make_stage1_adam()
    jparams = {k: jnp.asarray(v) for k, v in params_np.items()}
    jstate = jadam.init(jparams)
    tparams = {k: torch.from_numpy(v.copy()) for k, v in params_np.items()}
    tadam = toptim.Stage1Adam(tparams)
    assert tadam.eps == 1e-15
    for _ in range(5):
        grads = {k: rng.standard_normal(v.shape).astype(np.float32) * 1e-3
                 for k, v in params_np.items()}
        updates, jstate = jadam.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate)
        jparams = joptim.apply_stage1_updates(jparams, updates, lrs)
        tparams = toptim.apply_stage1_updates(
            tparams, tadam.update({k: torch.from_numpy(g) for k, g in grads.items()}), lrs)
    assert tadam.count == int(jstate.count) == 5
    for k in PARAMS:
        np.testing.assert_allclose(np_of(tparams[k]), np.asarray(jparams[k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
        for m in ("mu", "nu"):
            ref = np.asarray(getattr(jstate, m)[k])
            np.testing.assert_allclose(np_of(getattr(tadam, m)[k]), ref, rtol=1e-6,
                                       atol=1e-6 * np.abs(ref).max(), err_msg=f"{m} {k}")
    # The segmentation group has learning rate 0: it does not move.
    np.testing.assert_array_equal(np_of(tparams["segmentation_masks"]),
                                  params_np["segmentation_masks"])
