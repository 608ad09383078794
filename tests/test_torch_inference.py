"""The serving slice as a whole: the real config-3 checkpoint's full-width net
(hidden 128, 3 blocks) on a 2,048-row numpy subsample of the real cloud, 2
timesteps, the five orbit cameras at 64x36.  The port's frames must be within
1 of the JAX package's run_inference frames (renderer "pallas", interpret
mode), and its deformed means within 1e-5 of the JAX rollout's."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import splatpu.core.types as jt
from splatpu.dynamics.deform import normalize_and_encode_means_and_rotations as jax_encode
from splatpu.train.inference import run_inference as jax_run_inference
from splatpu.train.stage2 import Stage2Config as JStage2Config
from splatpu.train.stage2 import rollout_step as jax_rollout_step
from splatpu_torch.dynamics.deform import normalize_and_encode_means_and_rotations
from splatpu_torch.dynamics.network import DeformationNet, net_config_for, state_dict_from_jax
from splatpu_torch.train.inference import create_orbit_cameras, run_inference
from splatpu_torch.train.stage2 import Stage2Config, rollout_step
from _torch_scenes import np_of, torch_cloud

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
RUN = ROOT / "runs" / "config3_100k_r5"
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
T_COUNT = 2
W, H = 64, 36


@pytest.fixture(scope="module")
def slice_inputs():
    data = np.load(CLOUD)
    alive = np.nonzero(data["alive"])[0]
    rows = np.sort(np.random.default_rng(0).choice(alive, 2048, replace=False))
    cloud = {k: np.array(data[k][rows]) for k in data.files}
    tree = serialization.msgpack_restore((RUN / "stage2_ckpt.msgpack").read_bytes())
    params = tree["net_params"]
    params = dict(params, blocks=[params["blocks"][str(i)] for i in range(len(params["blocks"]))])
    head = json.loads((RUN / "stage2_result.json").read_text())["head"]
    return cloud, params, head


def test_orbit_cameras_match_jax():
    from splatpu.train.inference import create_orbit_cameras as jax_cams

    ref = jax_cams(W, H)
    got = create_orbit_cameras(W, H, device="cpu")
    assert list(got) == list(ref)
    for name in ref:
        np.testing.assert_array_equal(np_of(got[name].w2c), np_of(ref[name].w2c))
        np.testing.assert_array_equal(np_of(got[name].K), np_of(ref[name].K))


def test_serving_slice_matches_jax(slice_inputs):
    cloud, params, head = slice_inputs
    knobs = dict(delta_scale=head["delta_scale"], double_residual=head["double_residual"],
                 zero_init_head=head["zero_init_head"], time_gate_head=head["time_gate_head"])
    quirk = head["quirk_compat"]

    jcloud = jt.GaussianCloud(**{k: jnp.asarray(v) for k, v in cloud.items()})
    jcfg = JStage2Config(timestep_count=T_COUNT, renderer="pallas", compute_dtype="float32",
                         quirk_compat=quirk, **knobs)
    jenc = jax_encode(jcloud.means, jcloud.rotation_quaternions, quirk_compat=quirk)
    jparams = jax.tree.map(jnp.asarray, params)
    ref_frames, _ = jax_run_inference(jparams, jcloud, jenc, jcfg, width=W, height=H)

    sd = state_dict_from_jax(params)
    net = DeformationNet(net_config_for(sd, **knobs))
    net.load_state_dict(sd)
    tcloud = torch_cloud(cloud)
    tcfg = Stage2Config(timestep_count=T_COUNT, renderer="plain", quirk_compat=quirk)
    tenc = normalize_and_encode_means_and_rotations(
        tcloud.means, tcloud.rotation_quaternions, quirk_compat=quirk)
    frames, stats = run_inference(net, tcloud, tenc, tcfg, width=W, height=H, device="cpu")

    assert list(frames) == list(ref_frames)
    for name in ref_frames:
        assert len(frames[name]) == len(ref_frames[name]) == T_COUNT + 1
        for f, r in zip(frames[name], ref_frames[name]):
            assert f.dtype == np.uint8 and f.shape == r.shape == (H, W, 3)
            diff = np.abs(f.astype(np.int16) - np.asarray(r).astype(np.int16))
            assert diff.max() <= 1, (name, diff.max())
    assert not stats["residual_overflow"] and stats["renders"] == T_COUNT + 1
    assert float(np.mean([f.mean() for f in frames["000"]])) > 1.0, "blank frames"

    # The deformed state the frames were rendered from.
    enc_j, enc_t = jenc, tenc
    for t in range(1, T_COUNT + 1):
        jc, enc_j = jax_rollout_step(jparams, jcloud, jenc, enc_j, jnp.float32(t), jcfg)
        tc, enc_t = rollout_step(net, tcloud, tenc, enc_t, t, tcfg)
        np.testing.assert_allclose(np_of(tc.means), np_of(jc.means), atol=1e-5, rtol=0)
        np.testing.assert_allclose(np_of(tc.rotation_quaternions),
                                   np_of(jc.rotation_quaternions), atol=1e-5, rtol=0)
