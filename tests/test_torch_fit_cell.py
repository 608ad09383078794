"""The benchmark's stage-1 cell, ``fit.scene250k``, driven end to end on the
CPU at a tiny size (``splatbench/tests/tiny_fit.py``: 1,000 initial points
in 6,144 slots, 3 cameras at 128x72, ``max_span`` 4, the first mutation at
iteration 6) through the port's plain versions: set-up, the checked call,
the window, the record through the mutation, the reference, the per-layer
readers and the check.  The program as it was before its exact binning
(``faults_fit``'s ``span_clamp``) reads ``correct`` false there."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from splatbench import faults_fit, run  # noqa: E402
from splatbench.tests import tiny_fit  # noqa: E402

FIT_METRICS = {"wide_pair_share.fit", "wide_emit_host_ms.fit", "mutation_host_ms.fit",
               "fit_idle.fit", "fit_launches.fit", "fit_mfu.fit", "fit_projection_share.fit"}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_fit.make(tmp_path_factory.mktemp("fitbench"))


def run_fit(root, seed: int, trace: int):
    torch.set_num_threads(4)
    args = run.parse(["--workload", "fit.scene250k", "--seed", str(seed), "--seconds", "1",
                      "--trace", str(trace)])
    return run.run_cell(args, device="cpu", bench_dir=root / "splatbench", root=root,
                        limits=tiny_fit.LIMITS, cache_dir=root / "cache")


def test_fit_cell_traced_run_is_correct_and_reads_its_metrics(root):
    code, res = run_fit(root, 2**31 + 77, 1)
    assert code == 0 and res["correct"], res["checks"]
    assert list(res)[-1] == "checks" and res["attempted"] > 0 and res["failed"] == 0
    # The fit's own readers, and no stage-2 metric (their lists name the
    # train cells only); the CPU launches no kernel.
    assert set(res["metrics"]) == FIT_METRICS
    assert 0 < res["metrics"]["wide_pair_share.fit"]["value"] <= 100
    assert res["metrics"]["mutation_host_ms.fit"]["value"] > 0
    assert res["metrics"]["fit_launches.fit"]["value"] == 0
    # The plain versions project each view with preprocess: no kernel view.
    assert res["metrics"]["fit_projection_share.fit"]["value"] == 0
    assert 0 < res["metrics"]["fit_mfu.fit"]["value"] < 100
    assert {"busy_s", "window_s"} <= set(res["device"])


def test_fit_cell_fails_the_span_clamp(root):
    """Dropping the tiles past ``max_span``, as the program did before,
    fails the comparison."""
    with faults_fit.plant("span_clamp"):
        code, res = run_fit(root, 2**31 + 78, 0)
    assert code == 0 and res["correct"] is False, res["checks"]
    assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
