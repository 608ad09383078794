"""What every cell's run shares: the run's context, the window's clock, the
device trace and its reduction, and the lookup of files by name.

The run prints its set-up phases and the card on standard error, the
numbers it compared last there, and one JSON line last on standard output.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import torch

JAX_MODULES = ("jax", "jaxlib", "flax", "splatpu")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    """A module of the benchmark found by its file's name."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def jax_modules_loaded() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(JAX_MODULES))


def find_instance(class_name: str, where: str, test=lambda o: True):
    """The one live object of the program's class ``class_name`` (its module
    ``where``) that passes ``test``: how the benchmark reads an optimizer's
    state that the program keeps inside a call."""
    gc.collect()
    found = [o for o in gc.get_objects()
             if type(o).__name__ == class_name and type(o).__module__ == where and test(o)]
    if len(found) != 1:
        raise RuntimeError(f"expected one {where}.{class_name}, found {len(found)}")
    return found[0]


def card_line(device) -> dict:
    """The card's name and power limit."""
    if torch.device(device).type != "cuda":
        return {"kind": "cpu"}
    info = {"kind": torch.cuda.get_device_name(device)}
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        info["nvidia_smi"] = out[torch.device(device).index or 0] if out else None
    except (OSError, subprocess.SubprocessError):
        info["nvidia_smi"] = None
    return info


def host_counters() -> dict:
    """The clock, the calling (main) thread's CPU seconds and the process's."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return {"t": time.perf_counter(), "thread_cpu_s": time.thread_time(),
            "process_cpu_s": ru.ru_utime + ru.ru_stime}


def host_delta(a: dict, b: dict) -> dict:
    """Seconds, and CPU seconds of the main thread and of the process,
    between two ``host_counters``: how much of a window the host computed."""
    return {"seconds": b["t"] - a["t"], "thread_cpu_s": b["thread_cpu_s"] - a["thread_cpu_s"],
            "process_cpu_s": b["process_cpu_s"] - a["process_cpu_s"]}


class Profile:
    """``torch.profiler`` over a stretch of the run, started and stopped from
    the program's callbacks; its trace is reduced in memory."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts, record_shapes=False)
        self.t0 = self.t1 = None

    def start(self):
        sync(self.device)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.stop()

    def events(self, tmpdir) -> list:
        path = Path(tmpdir) / f"splatbench_trace_{os.getpid()}.json"
        self.prof.export_chrome_trace(str(path))
        try:
            data = json.loads(path.read_text())
        finally:
            path.unlink(missing_ok=True)
        return [e for e in data.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]


def union_length(intervals) -> tuple[float, list]:
    """(total covered length, merged intervals) of (start, end) pairs."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def short_name(name: str) -> str:
    for noise in ("void ", "(anonymous namespace)::", "at::native::", "at_cuda_detail::cub::",
                  "at::cuda::", "(anonymous namespace)"):
        name = name.replace(noise, "")
    return name[:120]


def reduce_trace(events: list, window_s: float, units: int) -> dict:
    """Per-unit (step or iteration) readings of a profiled stretch: device
    busy seconds, kernels, the host's ranges, the idle gaps by the host range
    open at their start, and the top device operations."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    kernels = [e for e in dev if e["cat"] == "kernel"]
    busy_us, merged = union_length((e["ts"], e["ts"] + e["dur"]) for e in dev)
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    host_ms = {}
    for e in ranges:
        host_ms[e["name"]] = host_ms.get(e["name"], 0.0) + e["dur"] / 1e3
    by_kernel = {}
    for e in kernels:
        k = short_name(e["name"])
        t, n = by_kernel.get(k, (0.0, 0))
        by_kernel[k] = (t + e["dur"] / 1e6, n + 1)
    gaps = {}
    ranges.sort(key=lambda e: e["ts"])
    active, j = [], 0
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        while j < len(ranges) and ranges[j]["ts"] <= e0:
            active.append(ranges[j])
            j += 1
        active = [r for r in active if r["ts"] + r["dur"] >= e0]
        label = min(active, key=lambda r: r["dur"])["name"] if active else "none"
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) / 1e6
    return {
        "units": units,
        "busy_s": busy_us / 1e6,
        "window_s": window_s,
        "kernels": kernels,
        "launches": len(kernels),
        "host_ms": host_ms,
        "by_kernel": by_kernel,
        "device_ops": sorted(([k, t] for k, (t, _) in by_kernel.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in gaps.items()), key=lambda x: -x[1])[:10],
    }


def kernel_ms_per_launch(reduced: dict, marker: str, exclude=("manual", "padded")):
    """Mean ms per launch of the kernels whose name holds ``marker``."""
    ks = [e for e in reduced["kernels"] if marker in e["name"]
          and not any(x in e["name"] for x in exclude)]
    if not ks:
        return None
    return sum(e["dur"] for e in ks) / 1e3 / len(ks)


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
