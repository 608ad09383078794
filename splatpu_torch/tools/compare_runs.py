"""Hold the card's acceptance runs against the TPU's, from their committed
result files and per-step logs (no device needed).

    python -m splatpu_torch.tools.compare_runs [--card runs/torch_h100]

For each pair of runs it prints the results beside each other with the
tolerances they are held to, and walks the two metrics logs window by
window (stage 1: 100 iterations; stage 2: one sequence iteration) to the
first window whose mean loss parts by more than 2%, and says whether it
lies after a resume that the TPU log shows (a step logged again), which
re-seeds the view sampler: the windows are reported, not held to a
tolerance.
Card runs, under ``--card``:

- ``floor/floor.json``: each timestep's mean against ``runs/floor_100k.json``
  (the TPU's), each camera against the JAX package's floor script run on
  a CPU (``runs/acceptance_truth/floor_jax_cpu.json``);
- ``s1_8000/`` against ``runs/s1_ceiling_r4b/``;
- ``s1_30000/`` against ``runs/acceptance_s1/``;
- ``s2_flagship/`` against ``runs/config3_100k_r5/`` (its rollout also
  above the floor at t75 and t150);
- BASELINE config 4, the 250,000-Gaussian truth: ``s1_config4_15000/``
  against ``runs/config4_s1/`` and ``s2_config4/`` against
  ``runs/config4_250k/``;
- the same runs again with the JAX package's random draws (threefry, the
  network and the split noise), each against the TPU run of its name
  without the suffix: ``s1_8000_threefry/``, ``s1_30000_threefry/``,
  ``s1_config4_15000_threefry/``, ``s2_flagship_threefry/`` and
  ``s2_config4_threefry/``.

Stage 2's first step is printed beside the TPU's (it follows from the
initial network alone).

A run missing on the card side is reported as missing.  Exits 1 if a
present run misses a tolerance.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
WINDOW_RTOL = 0.02
FLOOR_DB = 0.05
S1_PSNR_DB = 0.5
S1_GAUSSIANS_RTOL = 0.05
S2_PSNR_DB = 1.0
S2_LOSS_RTOL = 0.05
FLOOR_CPU = ROOT / "runs" / "acceptance_truth" / "floor_jax_cpu.json"
STAGE1 = {"s1_8000": "s1_ceiling_r4b", "s1_30000": "acceptance_s1",
          "s1_config4_15000": "config4_s1", "s1_8000_threefry": "s1_ceiling_r4b",
          "s1_30000_threefry": "acceptance_s1", "s1_config4_15000_threefry": "config4_s1"}
STAGE2 = {"s2_flagship": "config3_100k_r5", "s2_config4": "config4_250k",
          "s2_config4_threefry": "config4_250k", "s2_flagship_threefry": "config3_100k_r5"}
# The floor of each flagship run's scene.
FLOORED = {name: ROOT / "runs" / "floor_100k.json"
           for name in ("s2_flagship", "s2_flagship_threefry")}


def rows(path: Path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def windows(log: list, key: str, size: int, first_step: int = 0) -> dict:
    """{window index: mean of ``key``} over steps first_step + w * size ...
    A step logged twice (a run resumed from a checkpoint before it) counts
    once, as its last row: the run went on from that one."""
    last = {r["step"]: r[key] for r in log if key in r}
    out: dict[int, list] = {}
    for step, v in last.items():
        out.setdefault((step - first_step) // size, []).append(v)
    return {w: float(np.mean(v)) for w, v in sorted(out.items())}


def first_parting(card: dict, tpu: dict) -> tuple:
    """(first window whose means part by more than WINDOW_RTOL or None,
    the largest relative difference, windows compared)."""
    common = [w for w in card if w in tpu]
    rel = {w: abs(card[w] - tpu[w]) / abs(tpu[w]) for w in common}
    first = next((w for w in common if rel[w] > WINDOW_RTOL), None)
    return first, max(rel.values(), default=0.0), len(common)


def resumes(log: list) -> list:
    """The steps at which a run went on from an earlier checkpoint: a step
    logged below the row before it."""
    steps = [r["step"] for r in log]
    return [b for a, b in zip(steps, steps[1:]) if b < a]


def report_windows(what: str, card: dict, tpu: dict, label, tpu_resumes: list,
                   first_step: int = 0, size: int = 1) -> None:
    """The first window parting by more than WINDOW_RTOL, and where it lies
    against the TPU run's resumes (``tpu_resumes``, steps)."""
    first, worst, n = first_parting(card, tpu)
    where = "none"
    if first is not None:
        before = [s for s in tpu_resumes if s <= first_step + first * size]
        where = label(first) + (f", after the TPU run's resume at step {before[-1]}"
                                if before else "")
    print(f"  {what} ({n} windows): first parting by > {WINDOW_RTOL:.0%}: {where}; largest"
          f" {worst:.2%}")
    if tpu_resumes:
        pre = {w: v for w, v in card.items()
               if first_step + (w + 1) * size - 1 < min(tpu_resumes)}
        _, worst_pre, n_pre = first_parting(pre, tpu)
        print(f"    before the TPU run's first resume ({n_pre} windows): largest {worst_pre:.2%}")


def growths(log: list) -> list:
    return [(r["step"], int(r["max_pairs"]), int(r.get("max_span", 0)))
            for r in log if "budget_growth" in r]


def check(ok: list, name: str, got, ref, limit, rel: bool = False) -> None:
    d = abs(got - ref) / abs(ref) if rel else abs(got - ref)
    passed = d <= limit
    ok.append(passed)
    unit = "relative" if rel else "abs"
    print(f"  {name}: card {got:.6g}, TPU {ref:.6g}, {unit} diff {d:.4g} (limit {limit})"
          f" {'ok' if passed else 'MISSED'}")


def floor(card_dir: Path, ok: list) -> None:
    """Per camera against the JAX package's floor script run on a CPU, each
    timestep's mean against the TPU's (whose per-camera values the JAX
    package itself misses off the TPU)."""
    path = card_dir / "floor" / "floor.json"
    if not path.exists():
        print(f"floor: missing ({path})")
        return
    got = json.loads(path.read_text())["floor_psnr"]
    tpu = json.loads((ROOT / "runs" / "floor_100k.json").read_text())["floor_psnr"]
    cpu = json.loads(FLOOR_CPU.read_text())["floor_psnr"]

    def per_cam(a, b):
        return max(abs(x - y) for t in a for x, y in zip(a[t]["per_cam"], b[t]["per_cam"]))

    print(f"floor: {len(tpu)} timesteps x {len(tpu['t0']['per_cam'])} cameras")
    for t in tpu:
        print(f"  {t}: card mean {got[t]['mean']:.4f}, JAX on a CPU {cpu[t]['mean']:.4f}, TPU"
              f" {tpu[t]['mean']:.4f}")
    worst_cpu = per_cam(got, cpu)
    worst_mean = max(abs(got[t]["mean"] - tpu[t]["mean"]) for t in tpu)
    ok += [worst_cpu <= FLOOR_DB, worst_mean <= FLOOR_DB]
    print(f"  per camera against JAX on a CPU: largest |d| {worst_cpu:.5f} dB (limit"
          f" {FLOOR_DB}) {'ok' if worst_cpu <= FLOOR_DB else 'MISSED'}")
    print(f"  means against the TPU's: largest |d| {worst_mean:.5f} dB (limit {FLOOR_DB})"
          f" {'ok' if worst_mean <= FLOOR_DB else 'MISSED'}")
    print(f"  (per camera against the TPU's: {per_cam(got, tpu):.5f} dB; JAX on a CPU against"
          f" the TPU's: {per_cam(cpu, tpu):.5f} dB)")


def stage1(card_dir: Path, name: str, tpu_name: str, ok: list) -> None:
    cdir, tdir = card_dir / name, ROOT / "runs" / tpu_name
    if not (cdir / "stage1_result.json").exists():
        print(f"{name}: missing ({cdir})")
        return
    got = json.loads((cdir / "stage1_result.json").read_text())
    ref = json.loads((tdir / "stage1_result.json").read_text())
    print(f"{name} against runs/{tpu_name}: {got['iterations_done']} of"
          f" {got['iterations_total']} iterations, completed {got['completed']}")
    if got["completed"]:
        check(ok, "psnr_mean", got["psnr_mean"], ref["psnr_mean"], S1_PSNR_DB)
        check(ok, "gaussians_final", got["gaussians_final"], ref["gaussians_final"],
              S1_GAUSSIANS_RTOL, rel=True)
    for c in got.get("chunks", []):
        print(f"  chunk {c['from']}..{c['to']}: {c['ms_per_iteration']:.3f} ms per iteration,"
              f" fit {c['fit_seconds']:.1f} s, peak RSS {c['peak_rss_gb']:.2f} GiB")
    for p in got.get("psnr_series", []):
        print(f"  psnr@{p['iteration']}: {p['psnr_mean']:.4f} dB, {p['gaussians']} Gaussians")
    clog, tlog = rows(cdir / "stage1_metrics.jsonl"), rows(tdir / "stage1_metrics.jsonl")
    print(f"  budget growths: card {growths(clog)}, TPU {growths(tlog)}")
    print(f"  resumed at: card {resumes(clog)}, TPU {resumes(tlog)}")
    for key in ("total_loss", "n_alive"):
        report_windows(f"{key} per 100 iterations", windows(clog, key, 100),
                       windows(tlog, key, 100), lambda w: f"iterations {100 * w}-{100 * w + 99}",
                       resumes(tlog), size=100)
    muts = {r["step"]: r for r in tlog if "cloned" in r}
    for r in clog:
        if "cloned" in r and r["step"] in muts and r["step"] % 1000 == 0:
            m = muts[r["step"]]
            print(f"  mutation {r['step']}: n_alive card {int(r['n_alive'])}, TPU"
                  f" {int(m['n_alive'])}")


def stage2(card_dir: Path, name: str, tpu_name: str, ok: list) -> None:
    cdir, tdir = card_dir / name, ROOT / "runs" / tpu_name
    if not (cdir / "stage2_result.json").exists():
        print(f"{name}: missing ({cdir})")
        return
    got = json.loads((cdir / "stage2_result.json").read_text())
    ref = json.loads((tdir / "stage2_result.json").read_text())
    t = ref["timesteps"]
    print(f"{name} against runs/{tpu_name}: {got['sequence_iterations_done']} of"
          f" {got['sequence_iterations_total']} sequence iterations, completed"
          f" {got['completed']}; budget card {got.get('max_pairs')}, TPU {ref['max_pairs']}")
    if got["completed"]:
        for k in ("t1", "t75", "t150"):
            check(ok, f"rollout {k}", got["rollout_psnr"][k], ref["rollout_psnr"][k], S2_PSNR_DB)
        if name in FLOORED:
            floor_ref = json.loads(FLOORED[name].read_text())["floor_psnr"]
            for k in ("t75", "t150"):
                above = got["rollout_psnr"][k] > floor_ref[k]["mean"]
                ok.append(above)
                print(f"  rollout {k} above the floor {floor_ref[k]['mean']:.4f}:"
                      f" {'ok' if above else 'MISSED'}")
        for k in ("loss_first_seqit", "loss_last_seqit"):
            check(ok, k, got[k], ref[k], S2_LOSS_RTOL, rel=True)
        zero = got["binning"]["overflow_steps"] == 0
        ok.append(zero)
        print(f"  overflow steps {got['binning']['overflow_steps']} {'ok' if zero else 'MISSED'}")
    for p_got in got.get("rollout_psnr_series", []):
        p_ref = next((p for p in ref["rollout_psnr_series"] if p["seq_it"] == p_got["seq_it"]),
                     {})
        print(f"  rollout @{p_got['seq_it']}: card "
              + " / ".join(f"{p_got[k]:.3f}" for k in ("t1", "t75", "t150"))
              + "; TPU " + " / ".join(f"{p_ref.get(k, float('nan')):.3f}"
                                      for k in ("t1", "t75", "t150")))
    for c in got.get("chunks", []):
        print(f"  chunk {c['from']}..{c['to']}: median step {c['ms_per_step_median']:.2f} ms,"
              f" wall {c['wall_ms_per_step']:.2f} ms per step, staging"
              f" {c['staging_seconds']:.1f} s, rollout evaluations {c['eval_seconds']:.1f} s,"
              f" peak RSS {c['peak_rss_gb']:.2f} GiB")
    # Steps 1..T are sequence iteration 0.
    clog, tlog = rows(cdir / "stage2_metrics.jsonl"), rows(tdir / "stage2_metrics.jsonl")
    c1, t1 = (next(r["total"] for r in log if r.get("step") == 1 and "total" in r)
              for log in (clog, tlog))
    print(f"  first step: card {c1:.5f}, TPU {t1:.5f}, relative {abs(c1 - t1) / abs(t1):.2%}")
    print(f"  resumed at: card {resumes(clog)}, TPU {resumes(tlog)} (a run stopped at a"
          " checkpoint and resumed from it logs no step twice)")
    report_windows("mean total per sequence iteration", windows(clog, "total", t, 1),
                   windows(tlog, "total", t, 1), lambda w: f"sequence iteration {w}",
                   resumes(tlog), first_step=1, size=t)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--card", type=Path, default=ROOT / "runs" / "torch_h100")
    args = p.parse_args(argv)
    ok: list = []
    floor(args.card, ok)
    for name, tpu_name in STAGE1.items():
        stage1(args.card, name, tpu_name, ok)
    for name, tpu_name in STAGE2.items():
        stage2(args.card, name, tpu_name, ok)
    print(f"{sum(ok)} of {len(ok)} checks within their tolerances")
    return 0 if all(ok) else 1


if __name__ == "__main__":
    sys.exit(main())
