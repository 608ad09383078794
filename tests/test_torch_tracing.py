"""The port's spans and counters inside the stage-2 step, on the CPU:

- a profiled step has ``preprocess`` and ``binning`` once per view and
  ``composite`` once inside ``render``, and ``loss_bwd``, ``render_bwd`` and
  ``deform_bwd`` once each, in that order, inside ``backward``; every hook
  is gone after it;
- with no profiler the step registers no hook and counts nothing;
- the step's loss, gradients and updated parameters are bitwise the same
  with the profiler on and off;
- ``take_counts`` sums the binned views' pairs kept, lane slots and budget
  slots, and empties its store;
- ``train``'s logger gets every visit's ``step_ms`` row in step order
  before ``on_iteration``; on a card (events faked here) it waits once per
  sequence iteration;
- a traced tiny run of the benchmark's ``train.scene120k`` reports the
  metrics read from these spans and counters.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import splatpu_torch.train.stage2 as ts2
from splatpu_torch.core.types import activate_cloud
from splatpu_torch.obs import profiling
from splatpu_torch.render import exact
from splatpu_torch.render.binning import BinningConfig
from test_torch_step_paths import tiny_config, tiny_views
from _torch_scenes import np_cloud, np_lookat, torch_camera, torch_cloud

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from splatbench import run  # noqa: E402
from splatbench.tests import tiny  # noqa: E402

torch.set_num_threads(1)

W, H, V = 40, 32, 3
BINNING = BinningConfig(tile=16, max_span=16, max_pairs=1 << 12)
FORWARD = ("render", "preprocess", "binning", "composite")
BACKWARD = ("backward", "loss_bwd", "render_bwd", "deform_bwd")


def make_state():
    """A fresh stage-2 state (the network drawn from the config's seed) and
    one step's inputs: V views of a 256-Gaussian cloud, noise targets."""
    config = dataclasses.replace(tiny_config(renderer="plain"), views_per_step=V, binning=BINNING)
    state = ts2.setup(torch_cloud(np_cloud(7, 256)), config, device="cpu")
    cams = [np_lookat((3.5 * np.sin(a), 0.3, -3.5 * np.cos(a)), W, H) for a in (0.0, 0.9, 2.0)]
    w2c = torch.from_numpy(np.stack([c[0] for c in cams]))
    K = torch.from_numpy(np.stack([c[1] for c in cams]))
    images = torch.from_numpy(np.random.default_rng(3).uniform(0, 1, (V, 3, H, W))
                              .astype(np.float32))
    enc, fg = ts2.snapshot_previous(state.cloud, state.fg_idx, state.neighbor_info)
    step = ts2.make_step(config, state, W, H)
    return state, lambda: step(enc, fg, 1.0, w2c, K, images, BINNING)


def run_step(profiled: bool):
    state, step = make_state()
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, _, metrics = step()
    else:
        prof = None
        _, _, metrics = step()
    return state, metrics, prof


def ranges(prof, names):
    """name -> [(start, end)] of the profiled ranges, by start."""
    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out:
            out[e.name].append((e.time_range.start, e.time_range.end))
    return {n: sorted(v) for n, v in out.items()}


def inside(inner, outer):
    return outer[0] <= inner[0] <= inner[1] <= outer[1]


def test_profiled_step_has_each_range_once_in_place():
    profiling.take_counts()
    state, _, prof = run_step(profiled=True)
    fwd = ranges(prof, FORWARD)
    assert len(fwd["render"]) == 1 and len(fwd["composite"]) == 1
    assert len(fwd["preprocess"]) == len(fwd["binning"]) == V
    for name in FORWARD[1:]:
        assert all(inside(r, fwd["render"][0]) for r in fwd[name]), name
    bwd = ranges(prof, BACKWARD)
    assert [len(bwd[n]) for n in BACKWARD] == [1, 1, 1, 1]
    phases = [bwd[n][0] for n in BACKWARD[1:]]
    for a, b in zip(phases, phases[1:]):
        assert a[0] < a[1] <= b[0] < b[1]
    assert all(inside(p, bwd["backward"][0]) for p in phases)
    # Nothing stays open or registered.
    assert profiling.BackwardPhases.current is None
    assert not any(p._backward_hooks for p in state.net.parameters())
    assert profiling.take_counts()["views"] == V


def test_no_profiler_no_hook(monkeypatch):
    profiling.take_counts()
    calls = []
    real = torch.autograd.graph.register_multi_grad_hook
    monkeypatch.setattr(torch.autograd.graph, "register_multi_grad_hook",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    state, _, _ = run_step(profiled=False)
    assert calls == []
    assert profiling.BackwardPhases.current is None
    assert not any(p._backward_hooks for p in state.net.parameters())
    assert profiling.take_counts() == {}


def test_profiler_changes_no_bit_of_the_step():
    off_state, off, _ = run_step(profiled=False)
    on_state, on, _ = run_step(profiled=True)
    profiling.take_counts()
    for key in ("total", "l1", "ssim", "rigidity", "grad_norm"):
        assert torch.equal(on[key], off[key]), key
    for (name, p_on), p_off in zip(on_state.net.named_parameters(), off_state.net.parameters()):
        assert torch.equal(p_on.grad, p_off.grad), name
        assert torch.equal(p_on, p_off), name


@pytest.mark.parametrize("binning", [
    BinningConfig(tile=16, max_span=16, max_pairs=1 << 12),
    BinningConfig(tile=16, max_span=16, span_small=4, max_pairs=300),
], ids=["one_class_roomy", "two_class_clipped"])
def test_take_counts_sums_the_profiled_views(binning):
    """Pairs kept (each view's clipped to its budget), lane slots sorted
    and budget slots over the views binned while profiling; then empty."""
    profiling.take_counts()
    args = activate_cloud(torch_cloud(np_cloud(9, 200)))
    cam = torch_camera(*[np.stack(x) for x in zip(*[
        np_lookat((3.0 * np.sin(a), 0.2, -3.0 * np.cos(a)), W, H) for a in (0.0, 1.3)])], W, H)
    exact.bin_views(args, cam, binning)  # outside a profiler: not counted
    with profile(activities=[ProfilerActivity.CPU]):
        streams = exact.bin_views(args, cam, binning)
    got = profiling.take_counts()
    n, span_small = args.n, min(binning.span_small, binning.max_span)
    lanes = n * span_small
    if span_small < binning.max_span:
        lanes += binning.resolved_big_capacity(n) * binning.max_span
    pairs = [int(s.total_pairs) for s in streams]
    assert got == {"views": 2, "views_projected": 0,
                   "pairs_kept": sum(min(p, binning.max_pairs) for p in pairs),
                   "lane_slots": 2 * lanes, "budget_slots": 2 * binning.max_pairs}
    assert 0 < got["pairs_kept"] <= got["lane_slots"]
    if binning.max_pairs == 300:
        assert max(pairs) > 300  # the clipping is exercised
    assert profiling.take_counts() == {}


class Rows:
    def __init__(self, events):
        self.events = events

    def log(self, metrics, step):
        self.events.append(("row", step, "step_ms" in metrics, "budget_growth" in metrics))

    def flush(self):
        pass


def test_train_logs_every_visit_before_on_iteration():
    events = []
    cfg = dataclasses.replace(tiny_config(renderer="plain"), total_iterations=2, timestep_count=3,
                              timestep_order="shuffled")
    views = tiny_views() * 3
    ts2.train(torch_cloud(np_cloud(41, 48)), views, cfg, logger=Rows(events), device="cpu",
              on_iteration=lambda seq_it, *_: events.append(("end", seq_it)))
    assert events == ([("row", s, True, False) for s in (1, 2, 3)] + [("end", 0)]
                      + [("row", s, True, False) for s in (4, 5, 6)] + [("end", 1)])


class FakeEvent:
    """A CUDA event on the CPU, completed in the order recorded, as far as
    the test says (``completed``)."""

    made, completed, waits = [], 0, 0

    def __init__(self, enable_timing=False):
        self.i = len(FakeEvent.made)
        FakeEvent.made.append(self)

    def record(self, stream=None):
        pass

    def query(self):
        return self.i < FakeEvent.completed

    def synchronize(self):
        FakeEvent.waits += 1
        FakeEvent.completed = max(FakeEvent.completed, self.i + 1)

    def elapsed_time(self, end):
        assert self.query() and end.query()
        return float(end.i - self.i)


def test_visit_log_on_a_card_waits_once_and_keeps_order(monkeypatch):
    """``VisitLog`` with events: a visit is logged once its end event has
    completed, rows in step order (a budget-growth row after its visit's),
    and ``flush`` waits once for the rest."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made, FakeEvent.completed, FakeEvent.waits = [], 0, 0
    events = []
    log = ts2.VisitLog(Rows(events), on_card=True)
    for step in (1, 2, 3):
        start = log.start()  # events 0, 2, 4; the visits' ends 1, 3, 5
        if step == 3:
            FakeEvent.completed = 4  # visit 2 has completed when visit 3 is enqueued
        log.visit(step, {"total": 0.0}, start)
        if step == 2:
            log.note(step, {"budget_growth": 1})
        FakeEvent.completed = max(FakeEvent.completed, 2)  # visit 1 completes later
    assert events == [("row", 1, True, False), ("row", 2, True, False),
                      ("row", 2, False, True)]
    assert FakeEvent.waits == 0
    log.flush()
    assert events[-1] == ("row", 3, True, False) and FakeEvent.waits == 1
    assert log.last is not None and log.last["step_ms"] == 1.0


def test_traced_tiny_run_reports_the_new_metrics(tmp_path):
    profiling.take_counts()
    root = tiny.make(tmp_path, n=600, width=64, height=48)
    args = run.parse(["--workload", "train.scene120k", "--seed", str(2**31 + 91),
                      "--seconds", "1", "--trace", "1"])
    code, res = run.run_cell(args, device="cpu", bench_dir=root / "splatbench", root=root,
                             limits=tiny.LIMITS, cache_dir=root / "cache")
    assert code == 0 and res["correct"], res["checks"]
    m = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("preprocess", "binning", "composite", "loss_bwd", "render_bwd", "deform_bwd"):
        assert m[f"{name}_host_ms.train"] > 0, name
    assert m["preprocess_host_ms.train"] + m["binning_host_ms.train"] \
        + m["composite_host_ms.train"] <= m["render_host_ms.train"]
    assert m["loss_bwd_host_ms.train"] + m["render_bwd_host_ms.train"] \
        + m["deform_bwd_host_ms.train"] <= m["backward_host_ms.train"]
    for name in ("lane_fill.train", "pair_budget_fill.train"):
        assert 0 < m[name] <= 100, name
    assert profiling.take_counts() == {}
