"""The port's stage 1 (``train/stage1.py``, ``cli/densify.py``) against the
JAX package's, on the same numpy inputs.

- ``initialize_cloud``: the same cloud from the same points;
- ``fit``, 12 iterations of a scaled schedule (mutations at 3, 6 and 9,
  the big-scale prune from 6, the final-window prune and an opacity reset
  at 9) at 1 and 2 views per step, the port's "plain" against JAX's "pallas"
  (interpret mode): per-iteration losses within 1e-5 relative, the
  mutations' counts equal, alive masks identical, parameters within 2e-2
  of how far they moved (the rotations through the covariance they give:
  see ``assert_runs_match``).  ``clone_scale_factor`` is high, so every hot
  Gaussian clones; then again with it low, so that every mutation splits,
  each package drawing its own split noise from its key, and the
  checkpoint's ``key`` JAX's bit for bit;
- resume: a checkpoint JAX wrote at iteration 5 of that fit, resumed by
  JAX and by the port to 12, step for step, under the same schedule;
- checkpoints: ``runs/acceptance_s1/stage1_ckpt.msgpack`` (JAX, capacity
  240,128) read into the port's state and written back byte-identical; a
  checkpoint the port writes byte-identical to ``flax.serialization``'s
  bytes of the same tree; the checkpoint before the budget fields resumes;
  a grown budget is adopted on resume;
- budget growth: a starved pair budget doubles, a span overflow grows the
  span and not the pairs;
- the split noise: the same draws from the same subkey, other draws
  from the next one;
- ``mesh_tiles`` with more than one view per step refused, as in the JAX
  package; ``cli.densify``'s parser against JAX's (plus ``--device``),
  ``--mesh-tiles 2 --views-per-step 2`` refused, and a run on the CPU of a tiny
  sequence with a checkpoint and a resume, its cloud read by both
  packages' ``load_cloud``.
"""

import dataclasses
import json
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import splatpu.cli.densify as jcli
import splatpu.core.types as jt
import splatpu.io.checkpoint as jckpt
import splatpu.train.stage1 as js1
from splatpu.growth.densify import DensifyConfig as JDensifyConfig
from splatpu.render.api import render_dual as jax_render_dual
from splatpu.render.binning import BinningConfig as JBinningConfig
import splatpu_torch.cli.densify as tcli
import splatpu_torch.train.stage1 as ts1
from splatpu_torch.core import prng
from splatpu_torch.data.dataset import save_synthetic_sequence
from splatpu_torch.growth.densify import DensifyConfig, DensifyStats
from splatpu_torch.io.checkpoint import (
    load_checkpoint,
    load_cloud,
    msgpack_restore,
    save_checkpoint,
    stage1_checkpoint_tree,
    stage1_state_from_tree,
    to_bytes,
)
from splatpu_torch.render.binning import BinningConfig
from splatpu_torch.train.optim import Stage1Adam
from test_torch_cli import jax_parser, options
from _torch_scenes import jax_camera, jax_cloud, np_cloud, np_lookat, np_of

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
JAX_CKPT = ROOT / "runs" / "acceptance_s1" / "stage1_ckpt.msgpack"
W = H = 32
N_CAMS = 3
RADIUS = 4.0
CFG = dict(tile=16, max_span=64, max_pairs=1 << 12, chunk_pairs=128)
SCHEDULE = dict(window_end=9, mutate_start=3, mutate_every=3, opacity_reset_every=9,
                prune_big_start=6, clone_scale_factor=1e3, grad_threshold=2e-5)
ITERATIONS = 12
LOSSES = ("image_loss", "segmentation_loss", "total_loss")
INFO = ("cloned", "split", "pruned", "dropped_for_capacity", "n_alive")
PARAMS = ("means", "colors", "segmentation_masks", "rotation_quaternions", "opacity_logits",
          "log_scales")


@dataclasses.dataclass
class View:
    w2c: np.ndarray
    K: np.ndarray
    width: int
    height: int
    image: np.ndarray
    segmentation: np.ndarray


class Recorder:
    def __init__(self):
        self.rows = []

    def log(self, metrics, step):
        self.rows.append((step, {k: float(v) for k, v in metrics.items()}))

    def flush(self):
        pass


def make_scene(seed=40, n=40):
    """A 40-Gaussian truth rendered by JAX's oracle into 3 ring views, and
    its (N, 7) points."""
    truth = np_cloud(seed, n, extent=0.8)
    jc = jax_cloud(truth)
    views = []
    for c in range(N_CAMS):
        a = 2 * np.pi * c / N_CAMS
        w2c, K = np_lookat((RADIUS * np.sin(a), 0.5, -RADIUS * np.cos(a)), W, H)
        img, seg = jax_render_dual(jt.activate_cloud(jc), jc.segmentation_masks,
                                   jax_camera(w2c, K, W, H), impl="oracle")
        views.append(View(w2c, K, W, H, np.asarray(img.image), np.asarray(seg.image)))
    pc = np.concatenate([truth["means"], truth["colors"],
                         (truth["segmentation_masks"][:, :1] > 0.5).astype(np.float32)], 1)
    return pc, views


def configs(v, **kw):
    common = dict(iterations=ITERATIONS, capacity_factor=2.0, views_per_step=v, **kw)
    return (js1.Stage1Config(renderer="pallas", binning=JBinningConfig(**CFG),
                             densify=JDensifyConfig(**SCHEDULE), **common),
            ts1.Stage1Config(renderer="plain", binning=BinningConfig(**CFG),
                             densify=DensifyConfig(**SCHEDULE), **common))


@pytest.fixture(scope="module")
def scene():
    return make_scene()


SPLIT_SCHEDULE = dict(SCHEDULE, clone_scale_factor=0.01)


def test_fit_with_splits_carries_jax_key(scene, tmp_path):
    """A fit whose mutations (3, 6, 9) split, each from ``split(key)``,
    with no draws carried across: JAX's checkpoint ``key`` bit for bit,
    the mutations' counts equal, the alive masks identical and the
    parameters (the rotations through their covariances) held as
    ``test_fit_matches_jax`` holds them; the losses 1e-5 relative up to
    the first split.  After it the losses part by ~1e-4: the children sit
    at R (n * s) from their parent, and the rotations R, whose covariance
    alone the packages agree on (see ``assert_runs_match``), differ by
    Adam's rounding noise; handed the same noise, the port's losses are
    the same (the draws themselves are held bit for bit in
    ``test_torch_growth.py``)."""
    pc, views = scene
    common = dict(iterations=ITERATIONS, capacity_factor=2.0, views_per_step=1,
                  checkpoint_every=ITERATIONS, seed=5)
    jcfg = js1.Stage1Config(renderer="pallas", binning=JBinningConfig(**CFG),
                            densify=JDensifyConfig(**SPLIT_SCHEDULE),
                            checkpoint_path=str(tmp_path / "j.msgpack"), **common)
    tcfg = ts1.Stage1Config(renderer="plain", binning=BinningConfig(**CFG),
                            densify=DensifyConfig(**SPLIT_SCHEDULE),
                            checkpoint_path=str(tmp_path / "t.msgpack"), **common)
    j_rec, t_rec = Recorder(), Recorder()
    j_cloud, _ = js1.fit(pc, views, RADIUS, jcfg, logger=j_rec)
    t_cloud, _ = ts1.fit(pc, views, RADIUS, tcfg, logger=t_rec, device="cpu")
    mutations = [m for _, m in j_rec.rows if "split" in m]
    assert len(mutations) == 3 and all(m["split"] > 0 for m in mutations)
    j_key = load_checkpoint(jcfg.checkpoint_path)["key"]
    t_key = load_checkpoint(tcfg.checkpoint_path)["key"]
    want = prng.key(5)
    for _ in range(3):
        want = prng.split(want)[0]
    np.testing.assert_array_equal(np.asarray(t_key, np.uint32), np.asarray(j_key, np.uint32))
    np.testing.assert_array_equal(np.asarray(t_key, np.uint32), want)
    assert_runs_match(j_rec.rows, t_rec.rows, j_cloud, t_cloud, initial_state(pc),
                      losses_until=3)


@pytest.fixture(scope="module")
def jax_fits(scene, tmp_path_factory):
    """JAX's fit at 1 and 2 views per step, and the checkpoint the 1-view
    fit wrote at iteration 5 (on_iteration runs before an iteration's
    checkpoint write, so at i = 11 the file still holds i = 5's)."""
    pc, views = scene
    tmp = tmp_path_factory.mktemp("jax_stage1")
    ckpt, kept = tmp / "s1.msgpack", tmp / "s1_i5.msgpack"
    out = {}
    for v in (1, 2):
        jcfg, _ = configs(v)
        keep = None
        if v == 1:
            jcfg = dataclasses.replace(jcfg, checkpoint_every=6, checkpoint_path=str(ckpt))
            keep = lambda i, c, m: shutil.copy(ckpt, kept) if i == 11 else None  # noqa: E731
        rec = Recorder()
        cloud, _ = js1.fit(pc, views, RADIUS, jcfg, logger=rec, on_iteration=keep,
                           on_iteration_every=6)
        out[v] = (cloud, rec.rows)
    assert int(load_checkpoint(kept)["i"]) == 5
    return out, kept


def assert_runs_match(j_rows, t_rows, j_cloud, t_cloud, start, losses_until=None):
    """Per-iteration losses 1e-5 relative (up to ``losses_until``), no
    overflow, the mutations' counts equal, alive masks identical, and each
    parameter within 2e-2 of how far it moved on the rows alive at
    ``start`` and at the end (1e-6 where it did not move)."""
    assert [s for s, _ in t_rows] == [s for s, _ in j_rows]
    for (step, jm), (_, tm) in zip(j_rows, t_rows):
        for k in LOSSES if losses_until is None or step <= losses_until else ():
            assert tm[k] == pytest.approx(jm[k], rel=1e-5), (step, k)
        assert tm["binning_overflow"] == jm["binning_overflow"] == 0.0
        for k in INFO:
            assert (k in tm) == (k in jm), (step, k)
            if k in jm:
                assert tm[k] == jm[k], (step, k)
    alive = np.asarray(j_cloud.alive)
    np.testing.assert_array_equal(np_of(t_cloud.alive), alive)
    kept = alive & start["alive"]
    j_params = {k: np.asarray(getattr(j_cloud, k)) for k in PARAMS}
    t_params = {k: np_of(getattr(t_cloud, k)) for k in PARAMS}
    start = {k: np.asarray(start[k]) for k in PARAMS}
    for k in PARAMS:
        want, got, start_k = (p[k] for p in (j_params, t_params, start))
        if k == "rotation_quaternions":
            # The fit starts from isotropic Gaussians, whose rotation has
            # an exact gradient of 0: Adam's first steps there are rounding
            # noise scaled up to lr, different in each package's arithmetic.
            # What the renderer reads of a rotation is the covariance
            # R diag(s^2) R^T, held instead.
            want, got, start_k = (covariance(p) for p in (j_params, t_params, start))
        moved = np.abs(want[kept] - start_k[kept]).max()
        np.testing.assert_allclose(got[alive], want[alive], rtol=0,
                                   atol=2e-2 * moved if moved > 0 else 1e-6, err_msg=k)


def covariance(params):
    """(N, 3, 3) R diag(exp(log_scales)^2) R^T, R of the normalised quaternion."""
    q = params["rotation_quaternions"].astype(np.float64)
    w, x, y, z = (q / np.linalg.norm(q, axis=-1, keepdims=True)).T
    R = np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)
    s2 = np.exp(2.0 * params["log_scales"].astype(np.float64))
    return np.einsum("nij,nj,nkj->nik", R, s2, R)


def initial_state(pc):
    c = js1.initialize_cloud(pc, 256)
    return {k: np.asarray(getattr(c, k)) for k in PARAMS + ("alive",)}


def test_initialize_cloud_matches_jax(scene):
    pc, _ = scene
    ref = js1.initialize_cloud(pc, 256)
    got = ts1.initialize_cloud(pc, 256, device="cpu")
    np.testing.assert_array_equal(np_of(got.alive), np.asarray(ref.alive))
    for k in PARAMS:
        np.testing.assert_allclose(np_of(getattr(got, k)), np.asarray(getattr(ref, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("views_per_step", [1, 2])
def test_fit_matches_jax(scene, jax_fits, views_per_step):
    pc, views = scene
    (fits, _) = jax_fits
    j_cloud, j_rows = fits[views_per_step]
    _, tcfg = configs(views_per_step)
    rec = Recorder()
    t_cloud, metrics = ts1.fit(pc, views, RADIUS, tcfg, logger=rec, device="cpu")
    assert_runs_match(j_rows, rec.rows, j_cloud, t_cloud, initial_state(pc))
    assert sum(1 for _, m in rec.rows if "cloned" in m) == 3
    assert all(m["cloned"] > 0 for _, m in rec.rows if "cloned" in m)
    assert any(m["pruned"] > 0 for _, m in rec.rows if "cloned" in m)
    assert rec.rows[-1][1]["total_loss"] < rec.rows[0][1]["total_loss"]
    assert float(metrics["total_loss"]) == rec.rows[-1][1]["total_loss"]


def test_resume_jax_checkpoint_matches_jax_resume(scene, jax_fits, tmp_path):
    pc, views = scene
    _, ckpt = jax_fits
    jcfg, tcfg = configs(1)
    j_rec, t_rec = Recorder(), Recorder()
    j_cloud, _ = js1.fit(pc, views, RADIUS, jcfg, logger=j_rec, resume_from=str(ckpt))
    t_cloud, _ = ts1.fit(pc, views, RADIUS, tcfg, logger=t_rec, resume_from=str(ckpt),
                         device="cpu")
    assert [s for s, _ in t_rec.rows][0] == 6
    start = msgpack_restore(ckpt.read_bytes())["cloud"]
    assert_runs_match(j_rec.rows, t_rec.rows, j_cloud, t_cloud, start)


def test_jax_checkpoint_round_trip_byte_identical():
    """The config-2 JAX checkpoint (240,128 slots) into the port's state and
    back: the same bytes."""
    data = JAX_CKPT.read_bytes()
    state = stage1_state_from_tree(msgpack_restore(data), device="cpu")
    cap = state["cloud"].capacity
    assert cap == 240_128 and state["i"] == 29_999
    adam = Stage1Adam(state["cloud"].param_dict())
    adam.load_state(**state["opt_state"])
    stats = DensifyStats(**state["stats"])
    tree = stage1_checkpoint_tree(state["cloud"], adam, stats, state["key"], state["i"],
                                  state["max_pairs"], state["max_span"], state["growths"])
    assert to_bytes(tree) == data


def small_fit(tmp_path, scene, **kw):
    pc, views = scene
    _, tcfg = configs(1)
    tcfg = dataclasses.replace(tcfg, iterations=4, checkpoint_every=2,
                               checkpoint_path=str(tmp_path / "s1.msgpack"), **kw)
    return ts1.fit(pc, views, RADIUS, tcfg, device="cpu"), tcfg


def test_port_checkpoint_is_flax_bytes(scene, tmp_path):
    _, tcfg = small_fit(tmp_path, scene)
    data = Path(tcfg.checkpoint_path).read_bytes()

    def as_jax(tree):  # jax.tree.map would sort the dicts' keys
        if isinstance(tree, dict):
            return {k: as_jax(v) for k, v in tree.items()}
        return jnp.asarray(tree)

    assert serialization.to_bytes(as_jax(load_checkpoint(tcfg.checkpoint_path))) == data
    assert int(load_checkpoint(tcfg.checkpoint_path)["i"]) == 3


def test_pre_budget_checkpoint_resumes(scene, tmp_path):
    _, tcfg = small_fit(tmp_path, scene)
    path = Path(tcfg.checkpoint_path)
    raw = load_checkpoint(path)
    old = {k: raw[k] for k in ("cloud", "opt_state", "stats", "key", "i")}
    path.write_bytes(to_bytes(old))
    rec = Recorder()
    pc, views = scene
    _, metrics = ts1.fit(pc, views, RADIUS, dataclasses.replace(tcfg, iterations=6), logger=rec,
                         resume_from=str(path), device="cpu")
    assert [s for s, _ in rec.rows] == [4, 5]
    assert np.isfinite(float(metrics["total_loss"]))


def test_resume_adopts_grown_budget(scene, tmp_path, monkeypatch):
    _, tcfg = small_fit(tmp_path, scene)
    path = Path(tcfg.checkpoint_path)
    raw = load_checkpoint(path)
    raw["max_pairs"] = np.int32(1 << 13)
    raw["max_span"] = np.int32(128)
    raw["growths"] = np.int32(1)
    save_checkpoint(path, raw)
    seen = []
    real = ts1.render_dual

    def spy(*a, config=None, **kw):
        seen.append((config.max_pairs, config.max_span))
        return real(*a, config=config, **kw)

    monkeypatch.setattr(ts1, "render_dual", spy)
    pc, views = scene
    ts1.fit(pc, views, RADIUS, dataclasses.replace(tcfg, iterations=5, checkpoint_every=0),
            resume_from=str(path), device="cpu")
    assert seen == [(1 << 13, 128)]


def test_budget_growth(scene):
    """A starved pair budget doubles (and training goes on); a span
    overflow grows the span and the big class, never the pairs."""
    pc, views = scene
    _, tcfg = configs(1)
    for binning, grows in ((BinningConfig(tile=16, max_span=4, max_pairs=32, chunk_pairs=32),
                            "pairs"),
                           (BinningConfig(tile=8, max_span=2, max_pairs=4096, chunk_pairs=128),
                            "span")):
        rec = Recorder()
        _, metrics = ts1.fit(pc, views, RADIUS, dataclasses.replace(
            tcfg, iterations=8, binning=binning, overflow_check_every=2, max_budget_growths=2,
            densify=DensifyConfig(window_end=0, mutate_start=100)), logger=rec, device="cpu")
        growth = [m for _, m in rec.rows if "budget_growth" in m]
        assert growth and [m["budget_growth"] for m in growth] == list(range(1, len(growth) + 1))
        if grows == "pairs":
            assert [m["max_pairs"] for m in growth] == [64.0, 128.0][:len(growth)]
            assert all(m["max_span"] == 4.0 for m in growth)
        else:
            assert all(m["max_pairs"] == 4096.0 for m in growth)
            assert [m["max_span"] for m in growth] == [4.0, 8.0][:len(growth)]
        assert np.isfinite(float(metrics["total_loss"]))


def test_split_noise_depends_on_key_and_iteration():
    """The noise is a function of the mutation's subkey alone; the
    iteration reaches it through the key, split once per mutation."""
    key = prng.key(7)
    key, sub = prng.split(key)
    a = ts1.split_normals(sub, 64, "cpu")
    b = ts1.split_normals(sub, 64, "cpu")
    _, sub_next = prng.split(key)
    c = ts1.split_normals(sub_next, 64, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert a[0].shape == (64, 3)


def test_mesh_tiles_refused(scene):
    """Tile strips take one view per step, as in the JAX package; the
    sharded fit itself is held in test_torch_dist_train.py."""
    pc, views = scene
    _, tcfg = configs(2, mesh_tiles=2)
    with pytest.raises(ValueError, match="views_per_step > 1 cannot be combined with mesh_tiles"):
        ts1.fit(pc, views, RADIUS, tcfg, device="cpu")


def test_cli_parser_matches_jax(monkeypatch, tmp_path):
    want = options(jax_parser(jcli.main, monkeypatch))
    got = options(tcli.parser())
    assert list(got) == list(want) + ["device"]
    assert {k: v for k, v in got.items() if k != "device"} == want
    assert got["device"][:2] == (("--device",), "cuda")
    with pytest.raises(SystemExit):
        tcli.main([str(tmp_path), "--device", "cpu", "--mesh-tiles", "2", "--views-per-step", "2"])


def test_cli_densify_on_cpu(scene, tmp_path):
    pc, views = scene
    seq = tmp_path / "seq"
    images = np.stack([v.image for v in views])[None]
    segs = (np.stack([v.segmentation[0] for v in views])[None] > 0.5).astype(np.float32)
    save_synthetic_sequence(seq, images, segs, np.stack([v.K for v in views])[None],
                            np.stack([v.w2c for v in views])[None], pc, image_suffix=".png")
    ckpt = tmp_path / "s1.msgpack"
    common = [str(seq), "--device", "cpu", "--renderer", "plain", "--tile", "16",
              "--capacity-factor", "2", "--checkpoint-path", str(ckpt)]
    tcli.main([*common, "--iterations", "4", "--checkpoint-every", "2"])
    assert int(load_checkpoint(ckpt)["i"]) == 3
    tcli.main([*common, "--iterations", "6", "--resume-from", str(ckpt)])
    rows = [json.loads(x) for x in (seq / "densify_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2, 3, 4, 5]
    assert all(np.isfinite(r["total_loss"]) for r in rows)
    out = seq / "densified_initial_gaussian_cloud_parameters.npz"
    cloud = load_cloud(out, device="cpu")
    jcloud = jckpt.load_cloud(out)
    assert cloud.capacity % 256 == 0 and int(cloud.n_alive()) == int(rows[-1]["n_alive"])
    for k in PARAMS:
        np.testing.assert_array_equal(np_of(getattr(cloud, k)), np.asarray(getattr(jcloud, k)))
