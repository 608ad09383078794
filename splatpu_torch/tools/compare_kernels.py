"""This tree's composite kernels beside an earlier tree's, on one card, in
one process: the forwards (K1, K4's forward, K5's forward) and the
backwards (K2, K4's backward), each held against its plain version, and
both trees' kernels timed by one method in turns.

    python -m splatpu_torch.tools.compare_kernels OTHER_ROOT

``OTHER_ROOT`` holds a checkout of an earlier commit (``git archive``)
whose ``splatpu_torch/csrc/`` has the sources of ``KERNELS`` with this
tree's C entry points.  Those sources (with their own
``composite_common.cuh``) are built into ``OTHER_ROOT/splatpu_torch/_build/``
and loaded with ctypes; this tree's same sources are built too, the same
way, into ``_build/compare_this/``.  The tool prints both builds' wall
times and, for every kernel instance both trees compile, whether ptxas
gave it the same registers, shared memory and spills.

The inputs are config 3's 100,585-Gaussian cloud at rest and 3 colour
channels.  The forwards run at the served shapes (the five 1280x720 orbit
cameras) and at the training shapes (the first five 1280x720 rig cameras,
the budget of all 27), each at its demand budget: 32 px exact streams for
K1 and K4, 16 px padded streams for K5, as ``chip_smoke.py`` measures
them.  Each forward is held against its plain version: image, depth and
final T errors, and the pixels whose ``last`` differs.  For each such
pixel (at most ``EXPLAIN``) the tool walks the pixel's segment again:
alpha by the plain version's operations on the card, T on the host in
float32 and in float64; it prints the first pair where the two stop
decisions part, with the value T (1 - alpha) in each precision beside
1e-4.  The backwards run at the training shapes at 32, 16, 24 and 8 px
tiles (``TILES``, the tiles both trees take), from this tree's forward's final T
and ``last``, on cotangents drawn from ``default_rng(0)``: whether the two
trees' rows are bitwise equal, and each one's error against the plain
version (scaled per row).  Then both trees' kernels are timed by
``measure.cuda_ms`` in ``ROUNDS`` rounds whose order turns (other, this,
then backwards), and every time and each one's median is printed.  The
exit code is 1 where two trees' backward rows differ.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

from splatpu_torch import _build
from splatpu_torch.core.types import Camera, activate_cloud, stack_cameras
from splatpu_torch.io.checkpoint import load_cloud
from splatpu_torch.render import composite, padded
from splatpu_torch.render.api import demand_binning, measure_binning_demand
from splatpu_torch.render.binning import build_pair_stream, tile_grid
from splatpu_torch.render.exact import composite_inputs
from splatpu_torch.tools.measure import cuda_ms, row_scaled_err
from splatpu_torch.tools.train_scene import rig_cameras
from splatpu_torch.train.inference import create_orbit_cameras
from splatpu_torch.train.stage2 import compact_cloud

ROOT = Path(__file__).resolve().parents[2]
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
SIZE = (1280, 720)
VIEWS = 5
TILES = (32, 16, 24, 8)  # the backwards' tiles
ROUNDS = 4
EXPLAIN = 5
# name -> (source, C entry point, this tree's wrapper, plain version, kind,
# and for a backward its forward and the binning's kernel); kind "exact" or
# "padded" for a forward, "bwd" for a backward.
KERNELS = {
    "K1": ("composite_fwd.cu", "splatpu_composite_fwd", composite.composite_fwd_cuda,
           composite.composite_fwd_plain, "exact", None, None),
    "K4 fwd": ("composite_manual_fwd.cu", "splatpu_composite_manual_fwd",
               composite.composite_manual_fwd_cuda, composite.composite_manual_fwd_plain,
               "exact", None, None),
    "K5 fwd": ("padded_fwd.cu", "splatpu_padded_fwd", padded.padded_fwd_cuda,
               padded.padded_fwd_plain, "padded", None, None),
    "K2": ("composite_bwd.cu", "splatpu_composite_bwd", composite.composite_bwd_cuda,
           composite.composite_bwd_plain, "bwd", composite.composite_fwd_cuda, "grid"),
    "K4 bwd": ("composite_manual_bwd.cu", "splatpu_composite_manual_bwd",
               composite.composite_manual_bwd_cuda, composite.composite_manual_bwd_plain,
               "bwd", composite.composite_manual_fwd_cuda, "manual"),
}


def exact_inputs(args, cams, budget_cams):
    """K1's and K4's inputs: the 32 px exact stream at the demand budget of
    ``budget_cams``."""
    _, k = composite_inputs(args, cams, demand_binning(*measure_binning_demand(args, budget_cams)))
    return (k["table"], k["gid"], k["start"], k["end"], torch.zeros(3, device=cams.w2c.device)), \
        k["geometry"]


def padded_inputs(args, cams, budget_cams):
    """K5's inputs: the 16 px padded streams, records gathered by gid."""
    binning = demand_binning(*measure_binning_demand(args, budget_cams, tile=16), tile=16)
    streams = [build_pair_stream(args, cams.view(i), binning) for i in range(cams.num_views)]
    records = torch.stack([
        composite.pack_table(s.splats.mean2d, s.splats.conic, s.g_opacity, s.splats.depth,
                             s.g_colors)[s.gid.long()] for s in streams]).contiguous()
    tiles_x, tiles_y = tile_grid(cams.width, cams.height, 16)
    kin = (records, torch.stack([s.start for s in streams]), torch.stack([s.end for s in streams]),
           torch.zeros(3, device=records.device))
    return kin, dict(tiles_x=tiles_x, tiles_y=tiles_y, width=cams.width, height=cams.height)


def other_forward(lib, entry, kin, geo, is_padded):
    """A call of the other tree's kernel ``entry`` on these inputs."""
    fn = getattr(lib, entry)
    n_ptr, n_int = (8, 7) if is_padded else (9, 9)
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    v, rows, rec = kin[0].shape
    w, h, dev = geo["width"], geo["height"], kin[0].device
    ints = ((v, rows, rec - 7, geo["tiles_x"], geo["tiles_y"], w, h) if is_padded else
            (v, rows, kin[1].shape[1], rec - 7, geo["tiles_x"], geo["tiles_y"], geo["tile"], w, h))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def call():
        out = (torch.empty((v, rec - 7, h, w), device=dev), torch.empty((v, h, w), device=dev),
               torch.empty((v, h, w), device=dev),
               torch.empty((v, h, w), dtype=torch.int32, device=dev))
        code = fn(*(x.data_ptr() for x in kin), *(x.data_ptr() for x in out), *ints, stream)
        if code:
            raise RuntimeError(f"the other tree's {entry} launch: CUDA error {code}")
        return out

    return call


def other_backward(lib, entry, kin, bwd_in, geo):
    """A call of the other tree's kernel ``entry`` on these inputs."""
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    v, n, rec = kin[0].shape
    p = kin[1].shape[1]
    ints = (v, n, p, rec - 7, geo["tiles_x"], geo["tiles_y"], geo["tile"], geo["width"],
            geo["height"])
    stream = torch.cuda.current_stream(kin[0].device).cuda_stream

    def call():
        rows = torch.zeros((v, p, rec), device=kin[0].device)
        code = fn(*(x.data_ptr() for x in kin + bwd_in), rows.data_ptr(), *ints, stream)
        if code:
            raise RuntimeError(f"the other tree's {entry} launch: CUDA error {code}")
        return rows

    return call


def explain(kin, geo, is_padded, view: int, y: int, x: int) -> str:
    """The pixel's walk again: power and alpha by the plain version's own
    operations on the card, in the kernel's frame, then T carried on the
    host in float32 and in float64; the first pair where their stop
    decisions differ, or that none does."""
    tile = 16 if is_padded else geo["tile"]
    t = (y // tile) * geo["tiles_x"] + x // tile
    start, end = kin[-3:-1]
    lo, hi = int(start[view, t]), int(end[view, t])
    if is_padded:  # absolute pixel coordinates
        rec = kin[0][view, lo:hi]
        dx, dy = float(x) - rec[:, 0], float(y) - rec[:, 1]
    else:          # tile-local: means minus the tile origin
        rec = kin[0][view, kin[1][view, lo:hi].long()]
        dx = float(x % tile) - (rec[:, 0] - float(x // tile * tile))
        dy = float(y % tile) - (rec[:, 1] - float(y // tile * tile))
    ca, cb, cc, op = rec[:, 2], rec[:, 3], rec[:, 4], rec[:, 5]
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(op * torch.exp(power), max=composite.ALPHA_MAX)
    keep = ((power <= 0.0) & (alpha >= composite.ALPHA_MIN)).cpu().numpy()
    one_m = (1.0 - alpha).cpu().numpy()
    t32, t64 = np.float32(1.0), 1.0
    for i in np.flatnonzero(keep):
        test32, test64 = t32 * one_m[i], t64 * float(one_m[i])
        stop32, stop64 = bool(test32 < np.float32(1e-4)), test64 < 1e-4
        if stop32 != stop64:
            return (f"pair {lo + i}: T (1 - alpha) = {float(test32):.9e} in float32,"
                    f" {test64:.9e} in float64, beside 1e-4: float32"
                    f" {'stops' if stop32 else 'goes on'}, float64"
                    f" {'stops' if stop64 else 'goes on'}")
        if stop32:
            return f"both stop at pair {lo + i}; the decisions agree along the walk"
        t32, t64 = test32, test64
    return "no stop in either precision; the decisions agree along the walk"


def report(name, got, ref, kin, geo, is_padded) -> None:
    err = [float((a - b).abs().max()) for a, b in zip(got[:3], ref[:3])]
    diff = (got[3] != ref[3]).nonzero().tolist()
    print(f"  {name}: image {err[0]:.3e}, depth {err[1]:.3e}, final T {err[2]:.3e}; last differs"
          f" on {len(diff)} pixels", flush=True)
    for view, y, x in diff[:EXPLAIN]:
        print(f"    view {view}, pixel (x {x}, y {y}): last {int(got[3][view, y, x])}, plain"
              f" {int(ref[3][view, y, x])}; {explain(kin, geo, is_padded, view, y, x)}",
              flush=True)


def ptxas_lines(log: str) -> dict:
    """Kernel instance -> its ptxas resource lines (registers, shared
    memory, spills), from nvcc's -Xptxas -v output.  An instance is named
    from its kernel's name on (``composite_fwd_kernelILi3ELi32E...``): the
    mangled prefix of the anonymous namespace differs between trees."""
    out, name = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            m = re.search(r"[a-z_]+_kernelI\w+", mangled)
            name = m.group(0) if m else mangled
            out[name] = []
        elif name and ("spill" in line or "Used" in line):
            out[name].append(line.split(":", 1)[-1].strip())
    return out


def compare_builds(other_csrc: Path, other_lib: Path):
    """Both trees' ``KERNELS`` sources built the same way, timed; the
    kernel instances both compile, with ptxas lines equal or not.  Returns
    the other tree's library."""
    logs, secs = {}, {}
    for who, csrc, lib_path in (
        ("other", other_csrc, other_lib),
        ("this", _build.CSRC_DIR, _build.BUILD_DIR / "compare_this" / "libthis.so"),
    ):
        t0 = time.perf_counter()
        lib, logs[who] = _build.build_library([csrc / k[0] for k in KERNELS.values()], lib_path)
        secs[who] = time.perf_counter() - t0
        if who == "other":
            other = lib
    print(f"nvcc of the {len(KERNELS)} composite sources, one process each: other"
          f" {secs['other']:.2f} s, this {secs['this']:.2f} s", flush=True)
    lines = {who: ptxas_lines(log) for who, log in logs.items()}
    both = sorted(set(lines["other"]) & set(lines["this"]))
    differ = [k for k in both if lines["other"][k] != lines["this"][k]]
    print(f"ptxas: {len(lines['other'])} kernel instances in other, {len(lines['this'])} in this;"
          f" of the {len(both)} in both, {len(differ)} with other resource lines", flush=True)
    for k in differ:
        print(f"  {k}: other {lines['other'][k]}; this {lines['this'][k]}", flush=True)
    return other


def in_turns(calls) -> None:
    """Both trees' calls timed in ``ROUNDS`` turned rounds; every time and
    each median printed."""
    times = {who: [] for who in calls}
    order = list(calls)
    for i in range(ROUNDS):
        for who in order if i % 2 == 0 else order[::-1]:
            times[who].append(cuda_ms(calls[who], reps=20, warmup=3))
    for who, ts in times.items():
        print(f"  {who}: {' / '.join(f'{t:.4f}' for t in ts)} ms per call, median"
              f" {statistics.median(ts):.4f}", flush=True)


def compare_forwards(lib, names, args, shapes) -> None:
    for shape, (cams, budget_cams) in shapes.items():
        exact = exact_inputs(args, cams, budget_cams)
        pad = padded_inputs(args, cams, budget_cams)
        for name in names:
            _, entry, this, plain, kind, _, _ = KERNELS[name]
            is_padded = kind == "padded"
            kin, geo = pad if is_padded else exact
            calls = {"other": other_forward(lib, entry, kin, geo, is_padded),
                     "this": lambda: this(*kin, **geo)}
            ref = plain(*kin, **geo)
            print(f"{name}, {shape} shapes:", flush=True)
            for who, call in calls.items():
                report(who, call(), ref, kin, geo, is_padded)
            in_turns(calls)
        del exact, pad


def compare_backwards(lib, names, args, cams, budget_cams) -> bool:
    """The backwards at each of ``TILES``: True where the two trees' rows
    were bitwise equal everywhere."""
    dev = cams.w2c.device
    rng = np.random.default_rng(0)
    ok = True
    for tile in TILES:
        binning = demand_binning(*measure_binning_demand(args, budget_cams, tile=tile), tile=tile)
        for name in names:
            _, entry, this, plain, _, fwd, kernel = KERNELS[name]
            _, k = composite_inputs(args, cams, dataclasses.replace(binning, kernel=kernel))
            kin = (k["table"], k["gid"], k["start"], k["end"], torch.zeros(3, device=dev))
            geo = k["geometry"]
            _, _, tfin, last = fwd(*kin, **geo)
            v, h, w = tfin.shape
            t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(dev)  # noqa: E731
            bwd_in = (tfin, last, t(v, 3, h, w), t(v, h, w), t(v, h, w))
            calls = {"other": other_backward(lib, entry, kin, bwd_in, geo),
                     "this": lambda: this(*kin, *bwd_in, **geo)}
            rows = {who: call() for who, call in calls.items()}
            ref = plain(*kin, *bwd_in, **geo)
            same = torch.equal(rows["other"], rows["this"])
            ok = ok and same
            print(f"{name}, tile {tile}, pairs {int(kin[3][:, -1].sum())}: rows of the two trees"
                  f" {'bitwise equal' if same else 'DIFFER'}; scaled error against the plain"
                  f" version: other {row_scaled_err(rows['other'], ref):.3e}, this"
                  f" {row_scaled_err(rows['this'], ref):.3e}", flush=True)
            del ref, rows
            in_turns(calls)
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root", type=Path)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 1
    dev = torch.device("cuda")
    lib = compare_builds(a.other_root / "splatpu_torch" / "csrc",
                         a.other_root / "splatpu_torch" / "_build" / "libcompare.so")
    args = activate_cloud(compact_cloud(load_cloud(CLOUD, device=dev)))
    rig = rig_cameras(*SIZE)
    rig_cams = lambda n=None: Camera(  # noqa: E731
        w2c=torch.stack([torch.from_numpy(c[0]) for c in rig[:n]]).to(dev),
        K=torch.stack([torch.from_numpy(c[1]) for c in rig[:n]]).to(dev),
        width=SIZE[0], height=SIZE[1])
    orbit = stack_cameras(list(create_orbit_cameras(*SIZE, device=dev).values()))
    print(f"{torch.cuda.get_device_name(0)}; {VIEWS} x {SIZE[0]}x{SIZE[1]}, 3 channels",
          flush=True)
    compare_forwards(lib, [n for n, k in KERNELS.items() if k[4] != "bwd"], args,
                     {"served": (orbit, orbit), "training": (rig_cams(VIEWS), rig_cams())})
    ok = compare_backwards(lib, [n for n, k in KERNELS.items() if k[4] == "bwd"], args,
                           rig_cams(VIEWS), rig_cams())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
