"""Stage-2 pieces and one stage-2 step: the port against the JAX package on
the same numpy inputs.

Tolerances, each with its reason:
- SSIM and the losses 1e-6: the same float32 shifted adds, summed in
  another order;
- the schedule 1e-7 relative: the same float32 operations;
- kNN indices identical (a scene without near ties, and a 6x6x6 integer
  grid, whose exact ties both order lower index first); squared distances
  1e-6 (|a|^2 + |b|^2 - 2ab in float32, two matmul libraries; exact on the
  grid), and so the weights exp(-2000 d^2) 2e-3;
- rigidity loss and its gradients 1e-5 relative;
- the step: see test_one_step_matches_jax.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import splatpu.core.types as jt
import splatpu.dynamics.rigidity as jrig
import splatpu.train.losses as jlosses
import splatpu.train.optim as joptim
import splatpu.train.stage2 as js2
from splatpu.core.ssim import ssim as jax_ssim
from splatpu.dynamics.network import DeformationNetConfig as JNetConfig, init_deformation_net as jinit
from splatpu.neighbors.knn import knn_bruteforce as jknn
from splatpu.render.binning import BinningConfig as JBinningConfig
from splatpu_torch.core import prng
from splatpu_torch.core.types import CLOUD_PARAMS
import splatpu_torch.dynamics.rigidity as trig
import splatpu_torch.train.losses as tlosses
import splatpu_torch.train.optim as toptim
import splatpu_torch.train.stage2 as ts2
from splatpu_torch.core.ssim import ssim
from splatpu_torch.dynamics.network import (
    DeformationNet,
    DeformationNetConfig,
    init_deformation_net,
    net_config_for,
    net_params_to_jax_tree,
    state_dict_from_jax,
)
from splatpu_torch.io.checkpoint import load_stage2_opt_state
from splatpu_torch.neighbors.knn import knn_bruteforce
from splatpu_torch.render.binning import BinningConfig
from _torch_scenes import jax_cloud, np_lookat, np_of, torch_cloud

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CKPT = ROOT / "runs" / "config3_100k_r5" / "stage2_ckpt.msgpack"
RESULT = ROOT / "runs" / "config3_100k_r5" / "stage2_result.json"
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"


def images(seed, shape):
    return np.random.default_rng(seed).uniform(0.0, 1.0, shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 40, 56), (2, 3, 36, 64)])
def test_ssim_matches_jax(shape):
    a, b = images(0, shape), images(1, shape)
    b = (0.6 * a + 0.4 * b).astype(np.float32)
    ref = float(jax_ssim(jnp.asarray(a), jnp.asarray(b)))
    got = float(ssim(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - ref) <= 1e-6
    if len(shape) == 4:
        ref_b = np.asarray(jax_ssim(jnp.asarray(a), jnp.asarray(b), size_average=False))
        got_b = ssim(torch.from_numpy(a), torch.from_numpy(b), size_average=False).numpy()
        np.testing.assert_allclose(got_b, ref_b, rtol=0, atol=1e-6)


def test_losses_match_jax():
    a, b = images(2, (3, 36, 64)), images(3, (3, 36, 64))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert abs(float(tlosses.l1_loss(ta, tb)) - float(jlosses.l1_loss(a, b))) <= 1e-6
    assert abs(float(tlosses.image_loss(ta, tb)) - float(jlosses.image_loss(a, b))) <= 1e-6
    for name in ("L1_WEIGHT", "SSIM_WEIGHT", "RIGIDITY_WEIGHT"):
        assert getattr(tlosses, name) == getattr(jlosses, name)


@pytest.mark.parametrize("warmup,total", [(20, 200), (1, 16), (0, 10)])
def test_schedule_matches_jax(warmup, total):
    ref = joptim.warmup_cosine_schedule(1e-3, warmup, total)
    got = toptim.warmup_cosine_schedule(1e-3, warmup, total)
    for step in sorted({0, max(warmup - 1, 0), warmup, total, (warmup + total) // 2}):
        r = float(ref(step))
        assert abs(got(step) - r) <= 1e-7 * abs(r) + 1e-15, step
        assert toptim.stage2_lr_at(1e-3, warmup, total, step) == joptim.stage2_lr_at(
            1e-3, warmup, total, step)
    assert got(0) == pytest.approx(1e-6 if warmup else 1e-3, rel=1e-6)


def test_knn_grid_ties_match_jax():
    # A 6x6x6 integer grid: every row's neighbours come in groups at exactly
    # equal distances, and the 20th falls inside such a group, so the order
    # among equals decides the neighbour set (lower index first, as JAX).
    g = np.arange(6, dtype=np.float32)
    pts = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    ref_i, ref_d = (np.asarray(x) for x in jknn(jnp.asarray(pts), k=20, chunk=64))
    got_i, got_d = knn_bruteforce(torch.from_numpy(pts), 20, chunk=64)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    np.testing.assert_array_equal(got_d.numpy(), ref_d)


@pytest.mark.parametrize("n,k", [(600, 20), (5, 8)])
def test_knn_matches_jax(n, k):
    pts = np.random.default_rng(n).uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    ref_i, ref_d = (np.asarray(x) for x in jknn(jnp.asarray(pts), k=k, chunk=64))
    got_i, got_d = knn_bruteforce(torch.from_numpy(pts), k, chunk=64)
    np.testing.assert_array_equal(got_i.numpy(), ref_i)
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=0, atol=1e-6)


def test_rigidity_loss_and_gradient_match_jax():
    rng = np.random.default_rng(7)
    f = 400
    means = rng.uniform(-0.3, 0.3, (f, 3)).astype(np.float32)
    quats = rng.normal(size=(f, 4)).astype(np.float32)
    prev_means = (means + 0.01 * rng.normal(size=(f, 3))).astype(np.float32)
    prev_quats = (quats + 0.05 * rng.normal(size=(f, 4))).astype(np.float32)
    j_nbr = jrig.build_neighbor_info(jnp.asarray(means))
    t_nbr = trig.build_neighbor_info(torch.from_numpy(means))
    np.testing.assert_array_equal(t_nbr.indices.numpy(), np.asarray(j_nbr.indices))
    # exp(-2000 d^2): 2000 x the squared distances' tolerance.
    np.testing.assert_allclose(t_nbr.weights.numpy(), np.asarray(j_nbr.weights), rtol=0, atol=2e-3)
    # Identical state from here on: the JAX graph carried across.
    t_nbr = trig.NeighborInfo(indices=torch.from_numpy(np.array(j_nbr.indices)).long(),
                              weights=torch.from_numpy(np.array(j_nbr.weights)))
    j_prev = jrig.foreground_info(jnp.asarray(prev_means), jnp.asarray(prev_quats), j_nbr.indices)
    t_prev = trig.foreground_info(torch.from_numpy(prev_means), torch.from_numpy(prev_quats),
                                  t_nbr.indices)
    np.testing.assert_allclose(t_prev.offsets_to_neighbors.numpy(),
                               np.asarray(j_prev.offsets_to_neighbors), rtol=0, atol=1e-7)

    def jloss(m, q):
        return jrig.rigidity_loss(m, q, j_nbr, j_prev)

    ref = float(jloss(jnp.asarray(means), jnp.asarray(quats)))
    ref_gm, ref_gq = (np.asarray(g) for g in jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(means), jnp.asarray(quats)))
    m = torch.from_numpy(means).requires_grad_(True)
    q = torch.from_numpy(quats).requires_grad_(True)
    loss = trig.rigidity_loss(m, q, t_nbr, t_prev)
    loss.backward()
    assert abs(float(loss.detach()) - ref) <= 1e-5 * abs(ref)
    for got, want in ((m.grad.numpy(), ref_gm), (q.grad.numpy(), ref_gq)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_init_deformation_net():
    cfg = DeformationNetConfig(hidden_dim=32, residual_blocks=2, zero_init_head=True)
    a = init_deformation_net(prng.key(3), cfg, device="cpu")
    b = init_deformation_net(prng.key(3), cfg, device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name
    c = init_deformation_net(prng.key(4), cfg, device="cpu")
    assert not torch.equal(a.fc_in.weight, c.fc_in.weight)
    assert not a.fc_out.weight.any() and not a.fc_out.bias.any()
    assert a.fc_in.weight.abs().max() <= 1 / 192**0.5
    assert a.fc_in.weight.abs().max() > 0.9 / 192**0.5
    assert torch.equal(a.blocks[0].bn1.weight, torch.ones(32))
    # The JAX init's tree shapes, and the round trip through the JAX layout.
    jtree = jinit(jax.random.key(0), JNetConfig(hidden_dim=32, residual_blocks=2))
    tree = net_params_to_jax_tree(a)
    assert jax.tree.map(np.shape, tree) == jax.tree.map(np.shape, jtree)
    back = state_dict_from_jax(tree)
    for name, p in a.state_dict().items():
        assert torch.equal(back[name], p), name


@pytest.mark.parametrize("zero_init_head", [False, True], ids=["faithful", "zero_init"])
@pytest.mark.parametrize("seed", [0, 7])
def test_init_deformation_net_matches_jax(seed, zero_init_head):
    """Config 3's and config 4's network (hidden 128, 3 blocks) from
    ``key(seed)``: the JAX package's draw, bit for bit."""
    jcfg = JNetConfig(hidden_dim=128, residual_blocks=3, zero_init_head=zero_init_head)
    want = state_dict_from_jax(jax.tree.map(np.asarray, jinit(jax.random.key(seed), jcfg)))
    cfg = DeformationNetConfig(hidden_dim=128, residual_blocks=3, zero_init_head=zero_init_head)
    got = init_deformation_net(prng.key(seed), cfg, device="cpu").state_dict()
    assert got.keys() == want.keys()
    for name, p in got.items():
        assert torch.equal(p, want[name]), name
    assert bool(got["fc_out.weight"].any()) != zero_init_head


# --- one stage-2 step from identical state -----------------------------------

W, H, V = 64, 36, 5
T_COUNT, TIMESTEP = 8, 3
BCFG = dict(tile=32, max_span=64, max_pairs=1 << 14, chunk_pairs=256)


@pytest.fixture(scope="module")
def step_inputs():
    """The config-3 net and Adam state, a 2,048-row sample of the config-3
    cloud, five 64x36 views of the 27-camera rig, noise targets."""
    raw = serialization.msgpack_restore(CKPT.read_bytes())
    head = json.loads(RESULT.read_text())["head"]
    data = np.load(CLOUD)
    alive = np.nonzero(data["alive"])[0]
    rows = np.sort(np.random.default_rng(0).choice(alive, 2048, replace=False))
    cloud = {k: data[k][rows] for k in CLOUD_PARAMS}
    cloud["alive"] = np.ones(2048, bool)
    rng = np.random.default_rng(1)
    cams = []
    for i in range(27):
        a = 2 * np.pi * i / 27
        eye = (4.0 * np.sin(a), 0.4 + 0.6 * rng.standard_normal(), -4.0 * np.cos(a))
        cams.append(np_lookat(eye, W, H, focal=0.8 * W))
    pick = [0, 5, 11, 16, 22]
    w2c = np.stack([cams[i][0] for i in pick])
    K = np.stack([cams[i][1] for i in pick])
    targets = images(2, (V, 3, H, W))
    knobs = {k: head[k] for k in ("delta_scale", "double_residual", "zero_init_head",
                                  "time_gate_head")}
    # A schedule whose rate at the checkpoint's count (6,000) is mid-cosine,
    # so the update is not vanishingly small.
    sched = dict(learning_rate=head["lr"], warmup_iterations=2, total_iterations=1000,
                 timestep_count=T_COUNT, quirk_compat=head["quirk_compat"], **knobs)
    return raw, cloud, w2c, K, targets, sched


def test_one_step_matches_jax(step_inputs):
    check_one_step(step_inputs, "pallas", JBinningConfig(**BCFG), "plain", BinningConfig(**BCFG))


def check_one_step(step_inputs, jax_renderer, jax_binning, port_renderer, port_binning):
    """One stage-2 step of each package from identical state, compared."""
    raw, cloud, w2c, K, targets, sched = step_inputs
    jcfg = js2.Stage2Config(renderer=jax_renderer, binning=jax_binning,
                            compute_dtype="float32", **sched)
    cloud_j, fg_j, nbr_j, enc_j, _, _, _ = js2.setup(jax_cloud(cloud), jcfg)
    params = {"fc_in": raw["net_params"]["fc_in"], "fc_out": raw["net_params"]["fc_out"],
              "blocks": [raw["net_params"]["blocks"][str(i)] for i in range(3)]}
    params = jax.tree.map(jnp.asarray, params)
    optimizer = joptim.make_stage2_optimizer(
        jcfg.learning_rate, jcfg.warmup_iterations * T_COUNT, jcfg.total_iterations * T_COUNT)
    opt_state = serialization.from_state_dict(optimizer.init(params), raw["opt_state"])
    enc_prev_j, prev_fg_j = js2.snapshot_previous(cloud_j, fg_j, nbr_j, jcfg.quirk_compat)
    cam = jt.Camera(w2c=jnp.asarray(w2c[0]), K=jnp.asarray(K[0]), width=W, height=H)
    new_j, opt_j, enc_out_j, fg_out_j, met_j = js2.make_train_step(optimizer, jcfg)(
        params, opt_state, enc_prev_j, prev_fg_j, np.float32(TIMESTEP), jnp.asarray(w2c),
        jnp.asarray(K), jnp.asarray(targets), np.arange(V, dtype=np.int32), cam, cloud_j,
        enc_j, fg_j, nbr_j,
    )

    tcfg = ts2.Stage2Config(renderer=port_renderer, binning=port_binning, **sched)
    sd = state_dict_from_jax(raw["net_params"])
    net = DeformationNet(net_config_for(sd, **{k: sched[k] for k in (
        "delta_scale", "double_residual", "zero_init_head", "time_gate_head")}))
    net.load_state_dict(sd)
    state = ts2.setup(torch_cloud(cloud), tcfg, initial_net=net, device="cpu")
    state.optimizer.load_state(**load_stage2_opt_state(CKPT))
    np.testing.assert_array_equal(np_of(state.fg_idx), np.asarray(fg_j))
    # Identical state: the JAX neighbour graph carried across (the kNN's
    # near ties may order one row's neighbours differently).
    state.neighbor_info = trig.NeighborInfo(
        indices=torch.from_numpy(np.array(nbr_j.indices)).long(),
        weights=torch.from_numpy(np.array(nbr_j.weights)))
    enc_prev, prev_fg = ts2.snapshot_previous(state.cloud, state.fg_idx, state.neighbor_info,
                                              tcfg.quirk_compat)
    np.testing.assert_allclose(np_of(enc_prev), np.asarray(enc_prev_j), rtol=0, atol=1e-6)
    enc_out, fg_out, met = ts2.make_step(tcfg, state, W, H)(
        enc_prev, prev_fg, float(TIMESTEP), torch.from_numpy(w2c), torch.from_numpy(K),
        torch.from_numpy(targets), tcfg.binning)

    # Losses: float32 sums over the same renders, 1e-6 relative.
    for k in ("l1", "ssim", "image", "rigidity", "total"):
        assert float(met[k]) == pytest.approx(float(met_j[k]), rel=1e-6, abs=1e-9), k
    assert float(met["binning_overflow"]) == float(met_j["binning_overflow"]) == 0.0
    # Gradients: the render backward in another summation order, 1e-4
    # relative on the norm and scaled 1e-3 on the first moments (mu moves
    # by 0.1 g from the checkpoint's mu).
    assert float(met["grad_norm"]) == pytest.approx(float(met_j["grad_norm"]), rel=1e-4)
    adam = opt_j[0]
    assert state.optimizer.count == int(adam.count) == 6001

    def leaves(tree):
        return {jax.tree_util.keystr(p): np.asarray(x)
                for p, x in jax.tree_util.tree_leaves_with_path(tree)}

    for name, got, want in (
        ("params", net_params_to_jax_tree(state.net), new_j),
        ("mu", net_params_to_jax_tree(state.optimizer.mu), adam.mu),
        ("nu", net_params_to_jax_tree(state.optimizer.nu), adam.nu),
    ):
        got, want = leaves(got), leaves(want)
        assert got.keys() == want.keys()
        for k, w in want.items():
            if name == "params":
                # The update itself: params moved by lr * mu_hat / sqrt(nu_hat).
                before = leaves(params)[k]
                delta = w - before
                np.testing.assert_allclose(got[k] - before, delta, rtol=0,
                                           atol=1e-3 * np.abs(delta).max() + 1e-9, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-3 * np.abs(w).max(),
                                           err_msg=f"{name} {k}")
    # The snapshot: the deformed cloud's encoding (10 frequencies amplify the
    # network's float32 rounding up to 2^9 pi-fold) and foreground state.
    np.testing.assert_allclose(np_of(enc_out), np.asarray(enc_out_j), rtol=0, atol=2e-3)
    np.testing.assert_allclose(np_of(fg_out.inverted_rotations),
                               np.asarray(fg_out_j.inverted_rotations), rtol=0, atol=1e-5)
    np.testing.assert_allclose(np_of(fg_out.offsets_to_neighbors),
                               np.asarray(fg_out_j.offsets_to_neighbors), rtol=0, atol=1e-5)


@pytest.mark.parametrize("eye,size,focal", [((0.3, -0.2, -4.0), (64, 48), None),
                                             ((4.0, 1.0, 0.5), (1280, 720), 1024.0)])
def test_make_lookat_camera_matches_jax(eye, size, focal):
    from splatpu.data.synthetic import make_lookat_camera as jax_lookat
    from splatpu_torch.data.synthetic import make_lookat_camera

    ref = jax_lookat(eye=eye, width=size[0], height=size[1], focal=focal)
    got = make_lookat_camera(eye=eye, width=size[0], height=size[1], focal=focal, device="cpu")
    assert (got.width, got.height) == (ref.width, ref.height)
    np.testing.assert_array_equal(got.w2c.numpy(), np.asarray(ref.w2c))
    np.testing.assert_array_equal(got.K.numpy(), np.asarray(ref.K))
