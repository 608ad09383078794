"""Frozen counts of the work a cell's inputs need, and the chip's peaks.

The composites' operations and bytes come from the cell's Gaussians and
cameras under the binning and termination rules of ``reference/render.py``,
never from the program's launch arguments, budgets or plain versions:

- forward (K1), per evaluated (pixel, pair) step 16 FP32 operations (the
  offsets, the quadratic form, one exp, the clamp and the tests; each pixel
  up to and including the pair that stops it) and 4 + 2 (C + 1) per
  contribution (the weight, T, the colour and depth sums); bytes: the
  records of the Gaussians that have pairs, one index per pair, each tile's
  start and end, read once, and C + 3 values per pixel written once;
- backward (K2), per walked (pixel, pair) step (from the tile's first pair
  to the pixel's last contributor) the forward's 16, and per contribution
  30 + 3C + 7 + C (the division of T, the cotangent's dot product, dalpha,
  the suffix, dpower, the 7 + C rows and their sums over the pixels);
  bytes: the forward's inputs, the per-pixel inputs and cotangents (C + 4)
  read once, and one row of 7 + C per pair emitted (not per slot of a
  budget) written once;
- the network: 2 x rows x (192 D + 2 R D^2 + 7 D) operations forward, twice
  that backward;
- SSIM: 8 separable 11-tap blurs per channel (5 forward, 3 backward), 44
  operations per pixel each.
Everything else (projection, binning, the routing, losses, Adam) is left
out, so a share of the peak computed from these counts is a lower bound.
"""

from __future__ import annotations

import torch

from splatbench.reference import render as ref

PEAK_FP32_FLOPS = 67e12   # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
OPS_PER_EVAL = 16
NET_INPUT, NET_OUTPUT = 192, 7


def ops_per_contribution(c: int) -> int:
    return 4 + 2 * (c + 1)


def ops_bwd_per_live(c: int) -> int:
    return 30 + 3 * c + 7 + c


@torch.no_grad()
def view_work(args, colors, w2c, K, width: int, height: int, tile: int) -> dict:
    """Mean over the cameras of one view's work: evaluations, contributions,
    backward walked steps, pairs, Gaussians with pairs, tiles, pixels."""
    means, rot, scales, op = args
    tot = dict(evals=0, contribs=0, bwd_evals=0, pairs=0, rows=0)
    for i in range(w2c.shape[0]):
        p = ref.project(means, rot, scales, op, w2c[i], K[i], width, height)
        bins = ref.bin_view(p, width, height, tile)
        w = ref.walk_counts(ref.pack_table(p, colors), bins)
        for k in ("evals", "contribs", "bwd_evals"):
            tot[k] += w[k]
        tot["pairs"] += int(bins.gid.numel())
        tot["rows"] += int(torch.unique(bins.gid).numel())
    n = w2c.shape[0]
    out = {k: v / n for k, v in tot.items()}
    out.update(tiles=bins.tiles_x * bins.tiles_y, pixels=width * height)
    return out


def composite_bounds(work: dict, views: int, c: int) -> dict:
    """Operations, bytes and bound ms of one forward and one backward launch
    over ``views`` views of the mean ``work``."""
    v, rec = views, 6 + c + 1
    fwd_ops = v * (OPS_PER_EVAL * work["evals"] + ops_per_contribution(c) * work["contribs"])
    inputs = 4 * v * (work["rows"] * rec + work["pairs"] + 2 * work["tiles"])
    fwd_bytes = inputs + 4 * (c + v * work["pixels"] * (c + 3))
    bwd_ops = v * (OPS_PER_EVAL * work["bwd_evals"] + ops_bwd_per_live(c) * work["contribs"])
    bwd_bytes = inputs + 4 * (c + v * work["pixels"] * (c + 4) + v * work["pairs"] * rec)
    ms = lambda ops, b: 1e3 * max(ops / PEAK_FP32_FLOPS, b / PEAK_BYTES_S)  # noqa: E731
    return {"fwd_ops": fwd_ops, "fwd_bytes": fwd_bytes, "fwd_ms": ms(fwd_ops, fwd_bytes),
            "bwd_ops": bwd_ops, "bwd_bytes": bwd_bytes, "bwd_ms": ms(bwd_ops, bwd_bytes)}


def network_ops(rows: int, hidden: int, blocks: int) -> int:
    """Forward and backward matmul operations of the deformation network."""
    fwd = 2 * rows * (NET_INPUT * hidden + 2 * blocks * hidden * hidden + hidden * NET_OUTPUT)
    return 3 * fwd


def ssim_ops(views: int, c: int, pixels: int) -> int:
    return views * 8 * 44 * c * pixels
