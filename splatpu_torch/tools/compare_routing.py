"""This tree's routing kernel beside an earlier tree's, on one card, in one
process, timed by one method.

    python -m splatpu_torch.tools.compare_routing OTHER_ROOT

``OTHER_ROOT`` holds a checkout of an earlier commit (``git archive``)
whose ``splatpu_torch/csrc/route_pairs.cu`` has the one-mode C entry point
``splatpu_route_pairs(rows, pos_of_slot, offsets, counts, table, V, N, P, R,
stream)``, as it was before the padded slot mode.  That source alone is
built into ``OTHER_ROOT/splatpu_torch/_build/`` and loaded with ctypes.

The inputs are the exact pair stream of the training shapes: config 3's
100,585-Gaussian cloud at t = 0, the first five 1280x720 rig cameras, the
demand budget of all 27, per-pair rows (V, P, 10) from a seeded generator
(the routing's time does not depend on their values).  The other tree's
kernel, this tree's ``route_pairs_cuda`` and one ``index_add_`` of the
kept rows by (view, gid) (its yardstick, index and rows gathered
beforehand) are each held against ``route_pairs_plain`` (1e-4 scaled per
row), then timed by ``measure.cuda_ms`` in ``ROUNDS`` rounds whose order
turns (other, this, index_add_, then backwards).  Prints every time and
each one's median.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import sys
from pathlib import Path

import torch

from splatpu_torch import _build
from splatpu_torch.core.types import Camera, activate_cloud
from splatpu_torch.io.checkpoint import load_cloud
from splatpu_torch.render import route
from splatpu_torch.render.api import demand_binning, measure_binning_demand
from splatpu_torch.render.exact import composite_inputs
from splatpu_torch.tools.measure import cuda_ms, row_scaled_err
from splatpu_torch.tools.train_scene import rig_cameras
from splatpu_torch.train.stage2 import compact_cloud

ROOT = Path(__file__).resolve().parents[2]
CLOUD = ROOT / "runs" / "s1_ceiling_r4b" / "densified_cloud.npz"
SIZE = (1280, 720)
VIEWS = 5
ROWS = 10      # 7 geometry rows + 3 colours
ROUNDS = 3
TOL = 1e-4     # scaled per row by the reference's largest value


def cameras(dev, n=None) -> Camera:
    cams = rig_cameras(*SIZE)[:n]
    return Camera(w2c=torch.stack([torch.from_numpy(c[0]) for c in cams]).to(dev),
                  K=torch.stack([torch.from_numpy(c[1]) for c in cams]).to(dev),
                  width=SIZE[0], height=SIZE[1])


def other_routing(other_root: Path, rows, pos, offsets, counts):
    """A call of the other tree's routing kernel on these inputs."""
    lib, _ = _build.build_library([other_root / "splatpu_torch" / "csrc" / "route_pairs.cu"],
                                  other_root / "splatpu_torch" / "_build" / "libroute_pairs.so")
    fn = lib.splatpu_route_pairs
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    v, p, r = rows.shape
    n = offsets.shape[1]
    stream = torch.cuda.current_stream(rows.device).cuda_stream

    def call():
        out = torch.empty((v, n, r), dtype=torch.float32, device=rows.device)
        code = fn(rows.data_ptr(), pos.data_ptr(), offsets.data_ptr(), counts.data_ptr(),
                  out.data_ptr(), v, n, p, r, stream)
        if code:
            raise RuntimeError(f"the other tree's route_pairs launch: CUDA error {code}")
        return out

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other_root", type=Path)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 1
    dev = torch.device("cuda")
    args = activate_cloud(compact_cloud(load_cloud(CLOUD, device=dev)))
    binning = demand_binning(*measure_binning_demand(args, cameras(dev)))
    streams, k = composite_inputs(args, cameras(dev, VIEWS), binning)
    offsets, counts, lane = (torch.stack([getattr(s, f) for s in streams])
                             for f in ("offsets", "counts", "lane"))
    gid = k["gid"]
    pos = route.pos_of_slot_of(offsets, gid, lane)
    v, p = gid.shape
    n = offsets.shape[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn((v, p, ROWS), generator=gen, device=dev)
    kept = lane >= 0
    index = (gid.long() + n * torch.arange(v, device=dev)[:, None])[kept]
    kept_rows = rows[kept]
    calls = {
        "other": other_routing(a.other_root, rows, pos, offsets, counts),
        "this": lambda: route.route_pairs_cuda(rows, pos, offsets, counts),
        "index_add_": lambda: torch.zeros((v * n, ROWS), device=dev).index_add_(
            0, index, kept_rows).reshape(v, n, ROWS),
    }
    ref = route.route_pairs_plain(rows, pos, offsets, counts)
    print(f"V={v} N={n} P={p} R={ROWS} kept={int(kept.sum())}; "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    for name, call in calls.items():
        err = row_scaled_err(call(), ref)
        print(f"  {name}: {err:.3e} scaled per row against route_pairs_plain", flush=True)
        if not err <= TOL:
            print(f"FAIL: {name} differs from route_pairs_plain by {err:.3e} > {TOL}")
            return 1
    times = {name: [] for name in calls}
    order = list(calls)
    for i in range(ROUNDS):
        for name in order if i % 2 == 0 else order[::-1]:
            times[name].append(cuda_ms(calls[name], reps=50, warmup=5))
    for name, ts in times.items():
        print(f"  {name}: {' / '.join(f'{t:.4f}' for t in ts)} ms per call, median"
              f" {statistics.median(ts):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
