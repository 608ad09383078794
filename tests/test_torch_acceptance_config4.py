"""BASELINE config 4 in the port's acceptance tool
(``splatpu_torch/tools/acceptance.py``) against the JAX package's
(``scripts/acceptance_full.py --truth-n 250000``), on the CPU.

- the settings the port's ``stage2`` takes for the 250,000-Gaussian truth
  equal the JAX script's for ``runs/config4_250k``: the script's defaults
  (that run passed no head flag), the TPU result's head, motion, timesteps
  and sequence iterations, and its log's learning rate at every step (which
  fixes the schedule the result does not record); each of the JAX
  script's head flags, given to the port, sets its field;
- a small config-4 ``stage2`` (96x54, 3 cameras, a 3,000-Gaussian truth
  animated, the faithful quirk head, host staging, 1 sequence iteration x 2
  timesteps) writes the JAX script's result keys and equals the JAX
  script's run: per-step losses 1e-5 relative (each draws its network from
  the config's seed, nothing carried across), the rollout PSNR 1e-3 dB
  (the JAX side renders with its CPU "stream" path);
- ``runs/acceptance_truth/config4_tpu_reference.json``, the TPU rows that
  ``chip_smoke.py`` compares with on the card, equals the TPU runs' logs.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

import splatpu.obs.cache as jcache
from splatpu_torch.tools import acceptance as tacc
from splatpu_torch.train.optim import stage2_lr_at

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import acceptance_full as jacc  # noqa: E402
import export_acceptance_truth  # noqa: E402

CONFIG4 = ROOT / "runs" / "config4_250k"
SMALL = dict(width=96, height=54, cameras=3, truth_n=3000)
LOSS_RTOL = 1e-5
PSNR_TOL_DB = 1e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_script(monkeypatch):
    """Runs the JAX script's ``main`` on an argv, its module constants
    restored afterwards and its compilation cache left alone."""
    monkeypatch.setattr(jcache, "enable_compilation_cache", lambda *a, **k: None)
    for k in ("WIDTH", "HEIGHT", "CAMERAS", "TRUTH_N"):
        monkeypatch.setattr(jacc, k, getattr(jacc, k))

    def run(*argv):
        monkeypatch.setattr(sys, "argv", ["acceptance_full.py", *argv])
        jacc.main()

    return run


def script_args(jax_script, monkeypatch, *argv):
    """The JAX script's parsed arguments for ``stage2 argv``."""
    got = []
    monkeypatch.setattr(jacc, "run_stage2", got.append)
    jax_script("stage2", *argv)
    return got[0]


def test_config4_settings_are_the_jax_scripts(jax_script, monkeypatch):
    a = script_args(jax_script, monkeypatch, "--truth-n", "250000", "--iters", "30")
    got = tacc.stage2_settings(250_000)
    assert got["run"] == "config4_250k"
    assert got["config"] == dict(
        learning_rate=a.lr, delta_scale=a.delta_scale, double_residual=not a.no_double_residual,
        zero_init_head=a.zero_init_head, time_gate_head=a.time_gate_head,
        quirk_compat=not a.no_quirk, hidden_dim=a.hidden, residual_blocks=a.blocks,
        steps_per_timestep=a.steps_per_timestep, timestep_order=a.timestep_order,
        view_staging=a.view_staging)
    assert got["motion"] == {"rot_rate": a.rot_rate, "bob_amp": a.bob_amp}
    assert (got["iters"], got["timesteps"]) == (a.iters, a.timesteps) == (30, 150)

    ref = json.loads((CONFIG4 / "stage2_result.json").read_text())
    names = {"lr": "learning_rate", "delta_scale": "delta_scale",
             "double_residual": "double_residual", "zero_init_head": "zero_init_head",
             "quirk_compat": "quirk_compat"}
    assert set(ref["head"]) == set(names)  # no time_gate_head, no schedule: the defaults
    assert "schedule" not in ref
    for k, v in ref["head"].items():
        assert got["config"][names[k]] == v, k
    assert got["label"] == ref["config"] and got["motion"] == ref["motion"]

    # The schedule: warmup iters // 10 sequence iterations, one step per
    # timestep (stage 2's ``learning_rate`` row of every logged step).
    c, t = got["config"], got["timesteps"]
    k = c["steps_per_timestep"]
    with open(CONFIG4 / "stage2_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == list(range(1, 4501))
    for r in rows:
        want = stage2_lr_at(c["learning_rate"], max(1, got["iters"] // 10) * t * k,
                            got["iters"] * t * k, r["step"] * k - 1)
        assert r["learning_rate"] == pytest.approx(want, rel=1e-5, abs=1e-12), r["step"]


@pytest.mark.parametrize("flags,field,value", [
    (["--lr", "0.002"], "learning_rate", 0.002),
    (["--hidden", "64"], "hidden_dim", 64),
    (["--blocks", "2"], "residual_blocks", 2),
    (["--delta-scale", "1.0"], "delta_scale", 1.0),
    (["--no-quirk"], "quirk_compat", False),
    (["--no-double-residual"], "double_residual", False),
    (["--zero-init-head"], "zero_init_head", True),
    (["--time-gate-head"], "time_gate_head", True),
], ids=lambda x: x[0] if isinstance(x, list) else None)
def test_config4_head_flags_set_their_field(flags, field, value, jax_script, monkeypatch):
    """Each head flag is the JAX script's (the same name, the same field)
    and overrides the TPU run's value; the other fields stay the run's."""
    a = script_args(jax_script, monkeypatch, "--truth-n", "250000", *flags)
    args = tacc.parser().parse_args(["stage2", *flags])
    base = tacc.stage2_settings(250_000)["config"]
    got = tacc.stage2_settings(250_000, args)["config"]
    assert got == dict(base, **{field: value})
    script = {"learning_rate": a.lr, "hidden_dim": a.hidden, "residual_blocks": a.blocks,
              "delta_scale": a.delta_scale, "quirk_compat": not a.no_quirk,
              "double_residual": not a.no_double_residual,
              "zero_init_head": a.zero_init_head, "time_gate_head": a.time_gate_head}
    assert script[field] == value


def test_config4_stage2_matches_the_jax_script(tmp_path, jax_script, monkeypatch):
    truth = tmp_path / "truth.npz"
    monkeypatch.setattr(jacc, "TRUTH_N", SMALL["truth_n"])
    export_acceptance_truth.main(["--truth-n", str(SMALL["truth_n"]), "--out", str(truth)])
    size = ["--width", str(SMALL["width"]), "--height", str(SMALL["height"]), "--cameras",
            str(SMALL["cameras"])]
    run = ["--cloud", str(truth), "--iters", "1", "--timesteps", "2"]

    jax_script("stage2", "--truth-n", str(SMALL["truth_n"]), *size, *run, "--out",
               str(tmp_path / "jax"))
    ref = json.loads((tmp_path / "jax" / "stage2_result.json").read_text())

    # The small truth takes config 4's run; the port draws its own network
    # from the config's seed, as the JAX script does.
    monkeypatch.setattr(tacc, "STAGE2_RUNS", {SMALL["truth_n"]: tacc.STAGE2_RUNS[250_000]})
    got = tacc.main(["stage2", "--device", "cpu", "--truth", str(truth), *size, *run,
                     "--out", str(tmp_path / "port")])

    assert set(ref) <= set(got) and set(ref["binning"]) <= set(got["binning"])
    for k in ("head", "schedule", "motion", "timesteps", "sequence_iterations_total",
              "resolution", "cameras", "gaussians", "total_steps_done"):
        assert got[k] == ref[k], k
    assert got["reference_run"] == "runs/config4_250k"
    assert got["head"]["quirk_compat"] and not got["head"]["zero_init_head"]
    assert got["staging"]["view_staging"] == "host"
    assert got["binning"]["overflow_steps"] == ref["binning"]["overflow_steps"] == 0

    def totals(d):
        with open(tmp_path / d / "stage2_metrics.jsonl") as f:
            return [(r["step"], r["total"], r["learning_rate"])
                    for r in map(json.loads, f) if "total" in r]

    j_rows, t_rows = totals("jax"), totals("port")
    assert [r[0] for r in t_rows] == [r[0] for r in j_rows] == [1, 2]
    for (_, jl, jlr), (_, tl, tlr) in zip(j_rows, t_rows):
        assert tl == pytest.approx(jl, rel=LOSS_RTOL)
        assert tlr == pytest.approx(jlr, rel=1e-6)
    for k in ("loss_first_seqit", "loss_last_seqit"):
        assert got[k] == pytest.approx(ref[k], rel=LOSS_RTOL), k
    assert set(got["rollout_psnr"]) == set(ref["rollout_psnr"]) == {"seq_it", "t1", "t2"}
    for k in ("t1", "t2"):
        assert abs(got["rollout_psnr"][k] - ref["rollout_psnr"][k]) <= PSNR_TOL_DB, k


@pytest.mark.parametrize("stage", ["stage1", "stage2"])
def test_card_reference_is_the_tpu_logs(stage):
    """The TPU rows ``chip_smoke.py``'s acceptance_config4 phase reads:
    stage 1's first 120 iterations of ``runs/config4_s1``, stage 2's first
    4 steps of ``runs/config4_250k``."""
    ref = json.loads((ROOT / "runs" / "acceptance_truth" / "config4_tpu_reference.json")
                     .read_text())[stage]
    log = ROOT / "runs" / ("config4_s1/stage1_metrics.jsonl" if stage == "stage1"
                           else "config4_250k/stage2_metrics.jsonl")
    with open(log) as f:
        rows = [json.loads(line) for line in f]
    if stage == "stage1":
        n = len(ref["total_loss"])
        steps = [r for r in rows if "total_loss" in r and r["step"] < n]
        assert n == 120 and [r["step"] for r in steps] == list(range(n))
        for k in ("total_loss", "binning_overflow", "n_alive"):
            assert ref[k] == [r[k] for r in steps], k
        assert ref["budget_growths"] == [{k: v for k, v in r.items() if k != "ts"}
                                         for r in rows if "budget_growth" in r and r["step"] < n]
    else:
        first = rows[:len(ref["step"])]
        assert ref["step"] == [r["step"] for r in first] == [1, 2, 3, 4]
        assert ref["total"] == [r["total"] for r in first]
        assert ref["learning_rate"] == [r["learning_rate"] for r in first]
