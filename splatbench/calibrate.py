#!/usr/bin/env python3
"""Readings behind a cell's limits: the compared numbers of the program's
checked first steps against the reference's, on many seeds in one process.

    python3 splatbench/calibrate.py --workload <name> --seeds 1,2,3 \\
        --modes program,control,half_batch,rows [--out <file.jsonl>]

``program`` is the run as configured (the lower readings), ``control`` the
nearest lower precision (the upper reading), and the names of
``faults.FAULTS`` plant that fault in the program.  One JSON line per seed
and mode, on standard output and appended to ``--out``.  The benchmark's
runs do not run this; ``tests/test_splatbench_faults.py`` runs it at a small
size on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
import types
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(workload: str, seeds, modes, device="cuda", bench_dir: Path = BENCH_DIR,
             root: Path = ROOT, cache_dir: Path | None = None, out=None):
    """Yield {workload, seed, mode, loss, grad, change, change_median, detail}
    per seed and mode."""
    from splatbench import check, harness
    from splatbench.run import load_cell, set_cache_dirs

    set_cache_dirs(bench_dir)
    cell, cfg, traffic, _ = load_cell(workload, bench_dir, root)
    if device == "cuda":
        import os

        from splatpu_torch.obs.cache import enable_compilation_cache

        enable_compilation_cache(os.environ["SPLATPU_TORCH_COMPILE_CACHE"])
    driver = harness.load_module(bench_dir / "drivers" / f"{traffic['driver']}.py",
                                 f"splatbench_driver_{traffic['driver']}")
    ctx = types.SimpleNamespace(args=types.SimpleNamespace(seed=seeds[0], seconds=0.0, trace=0),
                                cfg=cfg, traffic=traffic, cell=cell, device=device,
                                config_name=cell["config"], tmpdir=tempfile.gettempdir(),
                                root=root, cache_dir=cache_dir or bench_dir / ".cache",
                                t_start=time.perf_counter(), setup_end=None)
    inputs = driver.Inputs(ctx)
    for seed in seeds:
        ctx.args.seed = seed
        t0 = time.perf_counter()
        ref = driver.reference_of(ctx, inputs, seed)
        t_ref = time.perf_counter() - t0
        for mode in modes:
            t0 = time.perf_counter()
            nums = check.training_numbers(driver.checked(ctx, inputs, seed, mode), ref)
            row = {"workload": workload, "seed": seed, "mode": mode,
                   **{k: nums[k] for k in ("loss", "grad", "change", "change_median")},
                   "detail": nums["_detail"], "reference_s": t_ref,
                   "program_s": time.perf_counter() - t0}
            if out is not None:
                with open(out, "a") as f:
                    f.write(json.dumps(row, default=str) + "\n")
            yield row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="program")
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    for row in readings(a.workload, seeds, a.modes.split(","), out=a.out):
        print(json.dumps(row, default=str), flush=True)
    from splatbench.harness import jax_modules_loaded

    return 1 if jax_modules_loaded() else 0


if __name__ == "__main__":
    sys.exit(main())
