#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch and CUDA port.

    python3 splatbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The cell
(``BENCHMARK.json``'s ``workloads``) names a configuration
(``splatbench/configs/<config>.json``) and a traffic mix
(``splatbench/traffic/<traffic>.json``), whose ``driver`` names the module
under ``splatbench/drivers/`` that runs it; each per-layer metric is read by
``splatbench/metrics/<name before the first dot>.py``.  So a configuration, a
mix or a metric is added by adding files and entries.

The run sets up (the kernels from ``splatbench/.cache/kernels``, the inputs
from the seed, the targets from ``splatbench/.cache/targets``), runs the
checked first steps (which run every shape), times the window, then judges
the first steps against the plain reference and prints one JSON line last on
standard output, the numbers compared last on standard error.  ``--trace 1`` times
a shorter stretch unprofiled and profiles one beside it (the drivers say
which), and reports the per-layer metrics.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def set_cache_dirs(bench_dir: Path) -> None:
    """The program's kernel cache inside the checkout, at a fixed path."""
    os.environ["SPLATPU_TORCH_COMPILE_CACHE"] = str(bench_dir / ".cache" / "kernels")


def load_cell(name: str, bench_dir: Path = BENCH_DIR, root: Path = ROOT):
    """(cell, configuration, traffic, BENCHMARK.json) of a workload, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: one of {sorted(cells)}")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / entry["file"]).read_text())
    traffic = json.loads((bench_dir / "traffic" / f"{cell['traffic']}.json").read_text())
    return cell, cfg, traffic, bench


def metric_names(bench: dict, cell: dict, e2e: set[str]) -> list[dict]:
    """The per-layer metrics this cell reports."""
    out = []
    for m in bench["per_layer"]:
        if "workloads" in m:
            if cell["name"] in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out


def read_metrics(bench: dict, cell: dict, reading: dict, bench_dir: Path) -> dict:
    """Each per-layer metric from its reader ``metrics/<family>.py``; a
    reader that finds nothing returns None and the metric is left out."""
    from splatbench import harness

    e2e = set(reading["e2e"])
    out = {}
    for m in metric_names(bench, cell, e2e):
        family, _, part = m["name"].partition(".")
        mod = harness.load_module(bench_dir / "metrics" / f"{family}.py",
                                  f"splatbench_metric_{family}")
        value = mod.read(reading, part)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run_cell(args, device: str = "cuda", bench_dir: Path = BENCH_DIR, root: Path = ROOT,
             limits: dict | None = None, cache_dir: Path | None = None
             ) -> tuple[int, dict | None]:
    """(exit code, result) of one run.  ``device`` "cpu" is for the tests,
    which drive the rest of a run with the port's plain versions."""
    import torch

    from splatbench import check, harness

    cell, cfg, traffic, bench = load_cell(args.workload, bench_dir, root)
    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < cell["chips"]):
        harness.log(f"no result: {cell['chips']} CUDA card(s) needed, "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
        return 3, None
    if device == "cuda":
        from splatpu_torch.obs.cache import enable_compilation_cache

        enable_compilation_cache(os.environ["SPLATPU_TORCH_COMPILE_CACHE"])
    card = harness.card_line(device)
    harness.log(f"card: {json.dumps(card)}")
    driver = harness.load_module(bench_dir / "drivers" / f"{traffic['driver']}.py",
                                 f"splatbench_driver_{traffic['driver']}")
    ctx = types.SimpleNamespace(args=args, cfg=cfg, traffic=traffic, cell=cell, device=device,
                                config_name=cell["config"], tmpdir=tempfile.gettempdir(),
                                root=root, cache_dir=bench_dir / ".cache" if cache_dir is None
                                else cache_dir, t_start=T_START, setup_end=None)
    out = driver.run(ctx)
    from splatpu_torch import _build

    setup_s = ctx.setup_end - ctx.t_start
    harness.log(f"set-up: {setup_s:.3f} s to the window (kernels loaded in "
                f"{_build.build_seconds:.3f} s, cached {_build.build_cached})")
    harness.log(f"window: {json.dumps(out['window'])}")
    peak = torch.cuda.max_memory_allocated(device) if device == "cuda" else 0
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": card["kind"], "count": 1, "memory_peak_bytes": int(peak)}
    reading = {"e2e": dict(out["e2e"], setup_s=setup_s), "build_seconds": _build.build_seconds}
    breakdown = None
    if args.trace:
        prof = out["profile"]
        if prof is None:
            raise RuntimeError("the run ended before its profiled stretch")
        t0 = time.perf_counter()
        red = harness.reduce_trace(prof.events(ctx.tmpdir), prof.t1 - prof.t0, out["prof_units"])
        t1 = time.perf_counter()
        reading.update(trace=red, work=driver.work(ctx, out), units=out["prof_units"])
        harness.log(f"trace: {out['prof_units']} units, {red['launches']} launches, read in "
                    f"{t1 - t0:.2f} s; counts in {time.perf_counter() - t1:.2f} s")
        dev_info.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    # The program's state goes before the reference runs.
    record = out.pop("record")
    out.pop("profile", None)
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = driver.reference(ctx, out)
    numbers = check.training_numbers(record, ref)
    harness.log(f"reference: {time.perf_counter() - t0:.2f} s; "
                f"{json.dumps(numbers['_detail'], default=str)}")
    if limits is None:
        limits = json.loads((bench_dir / "limits" / f"{cell['name']}.json").read_text())["limits"]
    correct, checks = check.judge(numbers, limits)
    metrics = ({k: {"value": v, "unit": u["unit"]} for k, v in reading["e2e"].items()
                for u in bench["end_to_end"] if u["name"] == k}
               if not args.trace else read_metrics(bench, cell, reading, bench_dir))
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    for k, c in checks.items():
        harness.log(f"check {k}: {c['value']!r} limit {c['limit']!r}")
    return 0, result


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs(BENCH_DIR)
    from splatbench import harness

    code, result = run_cell(args)
    found = harness.jax_modules_loaded()
    if found:
        harness.log(f"no result: modules of JAX or the JAX package were loaded: {found}")
        return 4
    if result is None:
        return code
    print(json.dumps(result), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
