"""A tiny copy of the benchmark for the CPU tests: 1,500 Gaussians of the
120,000-Gaussian truth, 9 cameras at 96x64, 3 timesteps, 2 views per step,
the real drivers and metric readers, short traffic."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
TRUTH = ROOT / "runs" / "acceptance_truth" / "truth_n120000.npz"
LIMITS = {"loss": 1e-4, "grad": 1e-3, "change": 1e-3}


def make(root: Path, n: int = 1500, width: int = 96, height: int = 64) -> Path:
    """A root with BENCHMARK.json, ``splatbench/`` (drivers and metrics
    copied, tiny configs and traffic) and a sampled truth."""
    bd = root / "splatbench"
    for d in ("drivers", "metrics"):
        shutil.copytree(BENCH / d, bd / d)
    for d in ("traffic", "configs", "limits"):
        (bd / d).mkdir(parents=True)
    z = np.load(TRUTH)
    idx = np.random.default_rng(0).choice(z["means"].shape[0], n, replace=False)
    np.savez(root / "truth.npz", **{k: z[k][idx] for k in z.files})
    entry = {"path": "truth.npz",
             "sha256": hashlib.sha256((root / "truth.npz").read_bytes()).hexdigest()}
    for name in ("scene120k", "scene250k"):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg["truth"] = entry
        cfg["stage2"]["cloud"] = entry
        cfg["rig"].update(cameras=9, width=width, height=height)
        cfg["timesteps"] = 3
        cfg["stage2"].update(views_per_step=2, resident_cameras=3)
        (bd / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (bd / "traffic" / "train.json").write_text(json.dumps(
        {"driver": "train", "profile_sequence_iterations": 1}))
    (root / "BENCHMARK.json").write_text((ROOT / "BENCHMARK.json").read_text())
    return root
