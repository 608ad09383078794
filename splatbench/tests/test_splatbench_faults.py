"""The comparison fails the control and every fault a training cell can
have, at a tiny size on the CPU; the program as configured passes."""

from __future__ import annotations

import pytest
import torch

from splatbench import calibrate, check, faults
from splatbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["train.scene120k", "train.scene250k"])
def test_control_and_faults_fail(root, workload):
    torch.set_num_threads(4)
    modes = ["program", "control", *faults.FAULTS]
    rows = {r["mode"]: r for r in calibrate.readings(
        workload, [2**31 + 5], modes, device="cpu", bench_dir=root / "splatbench", root=root,
        cache_dir=root / "cache")}
    verdict = {m: check.judge(rows[m], tiny.LIMITS)[0] for m in modes}
    assert verdict == {"program": True, **{m: False for m in modes[1:]}}, rows
    assert rows["unchanged"]["change"] == 1.0
