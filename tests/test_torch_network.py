"""The deformation network and state encoding: the port, loaded from a numpy
pytree in the JAX layout, against deformation_net_apply / deform.py at f32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import splatpu.dynamics.deform as jdeform
from splatpu.dynamics.network import DeformationNetConfig as JNetConfig
from splatpu.dynamics.network import deformation_net_apply
import splatpu_torch.dynamics.deform as tdeform
from splatpu_torch.dynamics.network import DeformationNet, net_config_for, state_dict_from_jax
from splatpu_torch.train.stage2 import compact_cloud
from _torch_scenes import jax_cloud, np_cloud, np_of, torch_cloud

torch.set_num_threads(1)


def np_params(seed, hidden=32, blocks=2, din=192, dout=7):
    rng = np.random.default_rng(seed)
    u = lambda *s: rng.uniform(-0.3, 0.3, s).astype(np.float32)  # noqa: E731
    return {
        "fc_in": {"w": u(din, hidden), "b": u(hidden)},
        "fc_out": {"w": u(hidden, dout), "b": u(dout)},
        "blocks": [
            {"fc1": {"w": u(hidden, hidden)}, "fc2": {"w": u(hidden, hidden)},
             "bn1": {"gamma": 1 + u(hidden), "beta": u(hidden)},
             "bn2": {"gamma": 1 + u(hidden), "beta": u(hidden)}}
            for _ in range(blocks)
        ],
    }


def port_net(params, **head):
    sd = state_dict_from_jax(params)
    net = DeformationNet(net_config_for(sd, **head))
    net.load_state_dict(sd)
    return net


@pytest.mark.parametrize("double_residual", [True, False])
def test_net_matches_jax(double_residual):
    params = np_params(0)
    rng = np.random.default_rng(1)
    n = 300
    x0 = rng.normal(size=(n, 7)).astype(np.float32)
    e_i, e_p = (rng.uniform(-1, 1, (n, 92)).astype(np.float32) for _ in range(2))
    e_t = np.broadcast_to(rng.uniform(-1, 1, (1, 8)).astype(np.float32), (n, 8)).copy()
    cfg = JNetConfig(hidden_dim=32, residual_blocks=2, compute_dtype="float32",
                     double_residual=double_residual)
    ref = deformation_net_apply(params, *(jnp.asarray(a) for a in (x0, e_i, e_p, e_t)), cfg)
    net = port_net(params, double_residual=double_residual)
    with torch.no_grad():
        got = net(*(torch.from_numpy(a) for a in (x0, e_i, e_p, e_t)))
    np.testing.assert_allclose(np_of(got), np_of(ref), atol=1e-5, rtol=0)


def test_batchnorm_uses_batch_statistics():
    # The same row gives different outputs in different batches: statistics
    # come from the batch, in inference too (no running buffers, no eval mode).
    net = port_net(np_params(2)).eval()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=(64, 192)).astype(np.float32))
    z7 = torch.zeros(64, 7)
    with torch.no_grad():
        full = net(z7, a[:, :92], a[:, 92:184], a[:, 184:])
        half = net(z7[:32], a[:32, :92], a[:32, 92:184], a[:32, 184:])
    assert not torch.allclose(full[:32], half)
    assert not any("running" in k for k in net.state_dict())


@pytest.mark.parametrize("quirk", [True, False])
def test_encode_state_and_progress(quirk):
    c = np_cloud(4, 200)
    ref = jdeform.normalize_and_encode_means_and_rotations(
        jnp.asarray(c["means"]), jnp.asarray(c["rotation_quaternions"]), quirk_compat=quirk)
    got = tdeform.normalize_and_encode_means_and_rotations(
        torch.from_numpy(c["means"]), torch.from_numpy(c["rotation_quaternions"]), quirk)
    np.testing.assert_allclose(np_of(got), np_of(ref), atol=1e-6, rtol=0)
    for t in (0, 1, 37, 150):
        np.testing.assert_allclose(
            np_of(tdeform.encode_progress(t, 150, 5, quirk, device="cpu")),
            np_of(jdeform.encode_progress(t, 150, 5, quirk)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("time_gate,delta_scale,double_residual",
                         [(True, 1.0, False), (False, 0.01, True)])
def test_update_cloud_parameters(time_gate, delta_scale, double_residual):
    c = np_cloud(5, 256)
    params = np_params(6)
    head = dict(delta_scale=delta_scale, double_residual=double_residual,
                time_gate_head=time_gate)
    jcloud = jax_cloud(c)
    enc = jdeform.normalize_and_encode_means_and_rotations(
        jcloud.means, jcloud.rotation_quaternions, quirk_compat=False)
    cfg = JNetConfig(hidden_dim=32, residual_blocks=2, compute_dtype="float32", **head)
    tcloud = torch_cloud(c)
    tenc = torch.from_numpy(np_of(enc).copy())
    net = port_net(params, **head)
    for t in (1, 7):
        ref = jdeform.update_cloud_parameters(params, jcloud, enc, enc, t, 10, cfg, False)
        with torch.no_grad():
            got = tdeform.update_cloud_parameters(net, tcloud, tenc, tenc, t, 10, False)
        np.testing.assert_allclose(np_of(got.means), np_of(ref.means), atol=1e-5, rtol=0)
        np.testing.assert_allclose(np_of(got.rotation_quaternions),
                                   np_of(ref.rotation_quaternions), atol=1e-5, rtol=0)


def test_compact_cloud_is_exactly_alive_rows():
    c = np_cloud(7, 300, n_dead=45)
    got = compact_cloud(torch_cloud(c))
    assert got.capacity == 255 and bool(got.alive.all())
    np.testing.assert_array_equal(np_of(got.means), c["means"][:255])


@pytest.mark.parametrize("caller_setting", [True, False])
def test_forward_turns_tf32_off_and_restores_it(caller_setting):
    # TF32 is off inside the forward pass whatever the caller set, and the
    # caller's setting is back once the pass returns.
    flags = torch.backends.cuda.matmul
    saved = flags.allow_tf32
    seen = []
    net = port_net(np_params(8))
    net.fc_in.register_forward_pre_hook(lambda *_: seen.append(flags.allow_tf32))
    n = 16
    try:
        flags.allow_tf32 = caller_setting
        with torch.no_grad():
            net(torch.zeros(n, 7), torch.zeros(n, 92), torch.zeros(n, 92), torch.zeros(n, 8))
        assert seen == [False]
        assert flags.allow_tf32 is caller_setting
    finally:
        flags.allow_tf32 = saved
