"""Cells, configurations, traffic and per-layer metrics are found by name:
a new one is new files and entries, and no file of the harness changes."""

from __future__ import annotations

import json
import sys

from splatbench import harness, run
from splatbench.tests import tiny


def test_new_cell_config_and_metric_are_found(tmp_path):
    root = tiny.make(tmp_path)
    bd = root / "splatbench"
    cfg = json.loads((bd / "configs" / "scene120k.json").read_text())
    (bd / "configs" / "scene_new.json").write_text(json.dumps(dict(cfg, name="scene_new")))
    (bd / "traffic" / "train_long.json").write_text(json.dumps(
        {"driver": "train", "profile_sequence_iterations": 2}))
    (bd / "metrics" / "new_reading.py").write_text(
        "def read(reading, part):\n    return 42.0 if part == 'train' else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "scene_new", "source": "test", "reduced": [],
                             "file": "splatbench/configs/scene_new.json", "why": "test"})
    bench["workloads"].append({"name": "train.scene_new", "config": "scene_new",
                               "traffic": "train_long", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "new_reading.train", "unit": "x", "better": "lower",
                               "source": "program_counter", "layer": "test",
                               "moves": "train_step_ms", "workloads": ["train.scene_new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell, cfg2, traffic, bench2 = run.load_cell("train.scene_new", bd, root)
    assert cfg2["name"] == "scene_new" and traffic["profile_sequence_iterations"] == 2
    names = [m["name"] for m in run.metric_names(bench2, cell, {"train_step_ms", "setup_s"})]
    assert "new_reading.train" in names and "kernel_load_s" in names
    # Metrics listed for other cells only are not this cell's.
    assert "k1_roofline.train" not in names
    reading = {"e2e": {"train_step_ms": 110.0, "setup_s": 10.0}, "build_seconds": 0.5}
    got = run.read_metrics(bench2, cell, reading, bd)
    assert got == {"new_reading.train": {"value": 42.0, "unit": "x"},
                   "kernel_load_s": {"value": 0.5, "unit": "s"}}


def test_jax_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "splatpu_torch_fake.sub", object())
    assert "splatpu" not in harness.jax_modules_loaded()
    monkeypatch.setitem(sys.modules, "splatpu.render", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert {"splatpu", "jax"} <= set(harness.jax_modules_loaded())


def test_benchmark_json_meets_the_contract_shape():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", [])) <= names
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (tiny.ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        assert (tiny.BENCH / "limits" / f"{w['name']}.json").is_file()
        assert (tiny.BENCH / "traffic" / f"{w['traffic']}.json").is_file()
