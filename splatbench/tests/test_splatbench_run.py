"""A whole run of each kind of cell on the CPU at a tiny size, through the
port's plain versions: the result line's keys, the metrics each reports,
and the comparison with the reference inside its limits."""

from __future__ import annotations

import pytest
import torch

from splatbench import faults, run
from splatbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["train.scene120k", "train.scene250k"])
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_and_is_correct(root, workload, trace):
    torch.set_num_threads(4)
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 77), "--seconds", "1",
                      "--trace", str(trace)])
    code, res = run.run_cell(args, device="cpu", bench_dir=root / "splatbench", root=root,
                             limits=tiny.LIMITS, cache_dir=root / "cache")
    assert code == 0
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    if trace:
        # mfu counts the profiled steps' own clouds and cameras; the CPU has
        # no kernels, so no roofline.
        assert {"render_host_ms.train", "mfu.train"} <= set(res["metrics"])
        assert "kernel_load_s" in res["metrics"]
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {"train_step_ms", "setup_s"}
        assert res["metrics"]["train_step_ms"]["value"] > 0


def test_no_card_no_result(monkeypatch, capsys):
    """Without a CUDA card the run prints no result and exits non-zero."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "train.scene120k", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("workload", ["train.scene120k", "train.scene250k"])
@pytest.mark.parametrize("fault", faults.FAULTS)
def test_run_with_a_broken_path_is_not_correct(root, workload, fault):
    """The rest of a run, the timed path broken underneath: ``correct`` false."""
    torch.set_num_threads(4)
    args = run.parse(["--workload", workload, "--seed", str(2**31 + 78), "--seconds", "1"])
    with faults.plant(fault):
        code, res = run.run_cell(args, device="cpu", bench_dir=root / "splatbench", root=root,
                                 limits=tiny.LIMITS, cache_dir=root / "cache")
    assert code == 0 and res["correct"] is False, res["checks"]
