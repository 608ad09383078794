"""The port's acceptance runs (``splatpu_torch/tools/acceptance.py``)
against the JAX package's (``scripts/acceptance_full.py``,
``scripts/floor_psnr.py``), on the CPU.

- the committed truths (``runs/acceptance_truth/truth_n120000.npz``, and
  ``truth_n250000.npz`` of BASELINE config 4) equal the JAX package's
  ``make_random_cloud`` draw bit for bit, and
  ``scripts/export_acceptance_truth.py`` writes them again;
- the scene: the port's 27 rig cameras, its 40,000 initial-point picks and
  its moved means at t in {1, 75, 150} equal the JAX script's bit for bit
  (the script imported as ``floor_psnr.py`` imports it, its module constants
  overridden; its ``moved_cloud`` and initial points are inner code, copied
  here line for line);
- ``floor`` at 96x54, 3 cameras and a 3,000-Gaussian truth: every per-camera
  PSNR within 1e-3 dB of ``floor_psnr.py``'s (the JAX side renders with its
  own ``render`` on the CPU, the "stream" path);
- ``stage1`` (3 iterations) and ``stage2`` (1 sequence iteration x 2
  timesteps) write result files with the JAX results' keys and metrics rows
  with the TPU logs' keys;
- ``--stop-after`` then ``--resume-from`` ends where an unbroken run ends,
  bit for bit, on a one-camera rig (both packages' trainers draw a resumed
  run's views from ``default_rng(seed + start)``, so with several cameras a
  resumed run's view order differs from an unbroken run's by design);
- each of the card's committed runs (``runs/torch_h100/``, config 4's
  too) is present and passes every check of ``tools/compare_runs.py``
  against the TPU's.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import splatpu.obs.cache as jcache
from splatpu.data.synthetic import make_random_cloud
from splatpu_torch.io.checkpoint import CLOUD_KEYS, load_cloud
from splatpu_torch.tools import acceptance as tacc
from splatpu_torch.tools import compare_runs
from splatpu_torch.tools.train_scene import moved_means, rig_cameras, stage1_points

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import acceptance_full as jacc  # noqa: E402
import export_acceptance_truth  # noqa: E402
import floor_psnr  # noqa: E402

SMALL = dict(width=96, height=54, cameras=3, truth_n=3000)
FLOOR_TOL_DB = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_truth():
    """The JAX scripts' full-size truth and cameras."""
    return jacc.build_truth_and_cams(jax, np)


@pytest.fixture
def small_scene(tmp_path, monkeypatch):
    """The JAX script's constants at the small size, and the truth npz the
    export script writes at that size."""
    for k in ("width", "height", "cameras", "truth_n"):
        monkeypatch.setattr(jacc, k.upper(), SMALL[k])
    truth = tmp_path / "truth.npz"
    export_acceptance_truth.main(["--truth-n", str(SMALL["truth_n"]), "--out", str(truth)])
    return truth


def small_args(truth, out, *extra):
    return ["--device", "cpu", "--width", str(SMALL["width"]), "--height",
            str(SMALL["height"]), "--cameras", str(SMALL["cameras"]), "--truth", str(truth),
            "--out", str(out), *extra]


@pytest.mark.parametrize("n", [120_000, 250_000])
def test_committed_truth_is_the_jax_draw(tmp_path, monkeypatch, n):
    """Configs 2 and 3 (120,000 Gaussians) and config 4 (250,000,
    ``acceptance_full.py --truth-n 250000``)."""
    path = ROOT / "runs" / "acceptance_truth" / f"truth_n{n}.npz"
    committed = np.load(path)
    draw = make_random_cloud(jax.random.key(0), n, extent=1.0, scale_range=(0.004, 0.02))
    out = tmp_path / "truth.npz"
    monkeypatch.setattr(jacc, "TRUTH_N", jacc.TRUTH_N)  # the export sets it
    export_acceptance_truth.main(["--truth-n", str(n), "--out", str(out)])
    exported = np.load(out)
    truth, _ = jacc.build_truth_and_cams(jax, np)
    assert truth.means.shape[0] == n
    for k in CLOUD_KEYS:
        np.testing.assert_array_equal(committed[k], np.asarray(getattr(draw, k)))
        np.testing.assert_array_equal(exported[k], committed[k])
        np.testing.assert_array_equal(np.asarray(getattr(truth, k)), committed[k])
    assert bool(load_cloud(path, device="cpu").alive.all())
    assert (path == tacc.TRUTH) == (n == 120_000)


def test_rig_points_and_motion_match_the_jax_script(jax_truth):
    """Bit for bit (tolerance 0): the same numpy arithmetic on the same
    float32 inputs."""
    truth, cams = jax_truth
    rig = rig_cameras(jacc.WIDTH, jacc.HEIGHT, jacc.CAMERAS)
    assert len(rig) == len(cams) == 27
    for (w2c, K), cam in zip(rig, cams):
        np.testing.assert_array_equal(w2c, np.asarray(cam.w2c))
        np.testing.assert_array_equal(K, np.asarray(cam.K))
        assert (cam.width, cam.height) == (1280, 720)

    # acceptance_full.py:196-205
    pc = np.concatenate([
        np.asarray(truth.means),
        np.clip(np.asarray(truth.colors), 0.0, 1.0),
        (np.asarray(truth.segmentation_masks)[:, :1] > 0.5).astype(np.float32),
    ], axis=1)
    keep = np.random.default_rng(0).choice(len(pc), size=len(pc) // 3, replace=False)
    got = stage1_points(load_cloud(tacc.TRUTH, device="cpu"))
    assert got.shape == (40_000, 7)
    np.testing.assert_array_equal(got, pc[keep])

    # acceptance_full.py:387-407 (the flagship's rot_rate 0.003, bob_amp 0.1)
    fg = np.asarray(truth.segmentation_masks)[:, 0] > 0.5
    base = np.asarray(truth.means)
    center = base[fg].mean(0, keepdims=True)
    for t in (1, 75, 150):
        phase = 2 * np.pi * t / 50.0
        a = 0.003 * t
        rot = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]],
                       np.float32)
        m = base.copy()
        m[fg] = (base[fg] - center) @ rot.T + center
        m[fg, 1] += 0.1 * np.sin(phase)
        np.testing.assert_array_equal(moved_means(base, fg, t, 0.003, 0.1), m)


def test_floor_matches_the_jax_script(tmp_path, small_scene, monkeypatch):
    rng = np.random.default_rng(5)
    d = dict(np.load(small_scene))
    keep = rng.choice(SMALL["truth_n"], 2000, replace=False)
    fitted = {k: v[keep].copy() for k, v in d.items()}
    fitted["means"] += rng.normal(0.0, 0.01, fitted["means"].shape).astype(np.float32)
    cloud = tmp_path / "fitted.npz"
    np.savez(cloud, **fitted)

    got = tacc.main(["floor", *small_args(small_scene, tmp_path / "port", "--cloud", str(cloud))])
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", [
        "floor_psnr.py", "--cloud", str(cloud), "--width", str(SMALL["width"]), "--height",
        str(SMALL["height"]), "--cameras", str(SMALL["cameras"]), "--truth-n",
        str(SMALL["truth_n"]), "--cameras-eval", str(SMALL["cameras"]), "--out",
        str(tmp_path / "jax.json")])
    floor_psnr.main()
    ref = json.loads((tmp_path / "jax.json").read_text())
    assert set(ref) <= set(got)
    assert got["scene"] == ref["scene"] and got["motion"] == ref["motion"]
    assert list(got["floor_psnr"]) == list(ref["floor_psnr"]) == ["t0", "t1", "t75", "t150"]
    for t, row in ref["floor_psnr"].items():
        np.testing.assert_allclose(got["floor_psnr"][t]["per_cam"], row["per_cam"], rtol=0,
                                   atol=FLOOR_TOL_DB)
        assert abs(got["floor_psnr"][t]["mean"] - row["mean"]) < FLOOR_TOL_DB
    assert not any(got["overflowed"].values())
    assert json.loads((tmp_path / "port" / "floor.json").read_text()) == got


def jsonl_keys(path) -> set:
    return set().union(*(json.loads(line).keys() for line in open(path)))


def test_stage1_and_stage2_write_the_jax_keys(tmp_path, small_scene):
    s1 = tacc.main(["stage1", *small_args(small_scene, tmp_path / "s1", "--iters", "3",
                                          "--eval-psnr-at", "2")])
    ref1 = json.loads((ROOT / "runs" / "s1_ceiling_r4b" / "stage1_result.json").read_text())
    assert set(ref1) | {"psnr_series"} <= set(s1)
    assert s1["completed"] and s1["iterations"] == 3 and s1["gaussians_final"] == 1000
    assert [p["iteration"] for p in s1["psnr_series"]] == [2, 3]
    assert len(s1["psnr_first5_views"]) == 3 and np.isfinite(s1["psnr_mean"])
    assert json.loads((tmp_path / "s1" / "stage1_result.json").read_text()) == s1
    assert (tmp_path / "s1" / "densified_cloud.npz").is_file()
    tpu_keys = {"step", "binning_overflow", "image_loss", "n_alive", "segmentation_loss",
                "span_overflow", "total_loss"}
    assert tpu_keys <= jsonl_keys(tmp_path / "s1" / "stage1_metrics.jsonl")

    cloud = tmp_path / "s1" / "densified_cloud.npz"
    s2 = tacc.main(["stage2", *small_args(small_scene, tmp_path / "s2", "--cloud", str(cloud),
                                          "--iters", "1", "--timesteps", "2")])
    ref2 = json.loads((ROOT / "runs" / "config3_100k_r5" / "stage2_result.json").read_text())
    assert set(ref2) <= set(s2)
    assert set(ref2["binning"]) <= set(s2["binning"])
    assert s2["head"] == ref2["head"] and s2["schedule"] == ref2["schedule"]
    assert s2["motion"] == ref2["motion"]
    assert s2["completed"] and s2["total_steps_done"] == 2 and s2["binning"]["overflow_steps"] == 0
    assert set(s2["rollout_psnr"]) == {"seq_it", "t1", "t2"}
    assert np.isfinite([s2["loss_first_seqit"], s2["loss_last_seqit"]]).all()
    with open(ROOT / "runs" / "config3_100k_r5" / "stage2_metrics.jsonl") as f:
        tpu2 = set(json.loads(f.readline())) - {"ts"}
    assert tpu2 <= jsonl_keys(tmp_path / "s2" / "stage2_metrics.jsonl")


def metric_rows(path, key):
    return [(r["step"], r[key]) for r in map(json.loads, open(path)) if key in r]


def test_stop_and_resume_end_where_an_unbroken_run_ends(tmp_path, small_scene, monkeypatch):
    one = ["--cameras", "1"]
    monkeypatch.setattr(tacc, "STAGE2_CHECKPOINT_EVERY", 1)
    monkeypatch.setattr(tacc, "STAGE2_EVAL_EVERY", 1)
    s1 = lambda out, *x: tacc.main(["stage1", *small_args(small_scene, out), *one,  # noqa: E731
                                    "--iters", "4", "--checkpoint-every", "2",
                                    "--eval-psnr-at", "1,3", *x])
    whole = s1(tmp_path / "whole")
    part = s1(tmp_path / "part", "--stop-after", "1")
    assert not part["completed"] and part["iterations_done"] == 2
    resumed = s1(tmp_path / "part", "--resume-from", str(tmp_path / "part" / "stage1_ckpt.msgpack"))
    assert resumed["completed"] and [c["from"] for c in resumed["chunks"]] == [0, 2]
    for k in ("psnr_series", "psnr_first5_views", "gaussians_final", "last"):
        assert resumed[k] == whole[k]
    assert (metric_rows(tmp_path / "part" / "stage1_metrics.jsonl", "total_loss")
            == metric_rows(tmp_path / "whole" / "stage1_metrics.jsonl", "total_loss"))
    a, b = np.load(tmp_path / "whole" / "densified_cloud.npz"), np.load(
        tmp_path / "part" / "densified_cloud.npz")
    for k in CLOUD_KEYS:
        np.testing.assert_array_equal(a[k], b[k])

    cloud = tmp_path / "whole" / "densified_cloud.npz"
    s2 = lambda out, *x: tacc.main(["stage2", *small_args(small_scene, out), *one,  # noqa: E731
                                    "--cloud", str(cloud), "--iters", "2", "--timesteps", "1",
                                    *x])
    whole = s2(tmp_path / "whole2")
    part = s2(tmp_path / "part2", "--stop-after", "1")
    assert not part["completed"] and part["sequence_iterations_done"] == 1
    resumed = s2(tmp_path / "part2", "--resume-from",
                 str(tmp_path / "part2" / "stage2_ckpt.msgpack"))
    assert resumed["completed"] and [c["from"] for c in resumed["chunks"]] == [0, 1]
    for k in ("rollout_psnr_series", "loss_first_seqit", "loss_last_seqit", "binning"):
        assert resumed[k] == whole[k]
    assert (metric_rows(tmp_path / "part2" / "stage2_metrics.jsonl", "total")
            == metric_rows(tmp_path / "whole2" / "stage2_metrics.jsonl", "total"))


CARD_RUNS = ["floor", *compare_runs.STAGE1, *compare_runs.STAGE2]


@pytest.mark.parametrize("name", CARD_RUNS)
def test_committed_card_runs_are_within_their_tolerances(capsys, name):
    """``runs/torch_h100/<name>`` against the TPU's files: present, and
    every check of ``tools/compare_runs.py`` on it passes."""
    card, ok = ROOT / "runs" / "torch_h100", []
    if name == "floor":
        compare_runs.floor(card, ok)
    elif name in compare_runs.STAGE1:
        compare_runs.stage1(card, name, compare_runs.STAGE1[name], ok)
    else:
        compare_runs.stage2(card, name, compare_runs.STAGE2[name], ok)
    out = capsys.readouterr().out
    assert "missing" not in out and ok and all(ok), out
    assert len(ok) == {"floor": 2, "s2_flagship": 8, "s2_config4": 6,
                       "s2_config4_threefry": 6, "s2_flagship_threefry": 8}.get(name, 2)
