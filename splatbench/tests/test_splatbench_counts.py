"""The frozen counts against hand counts on a two-tile scene."""

from __future__ import annotations

import torch

from splatbench import counts
from splatbench.reference import render as ref


def two_tile_scene():
    """Two 8 px tiles side by side (16x8 image).  Gaussian 0 (sigma 2 px,
    radius 6) sits in tile 0, nearest; Gaussian 1 (sigma 22 px) covers both
    tiles, behind it; both of opacity 0.5."""
    p = ref.Projected(
        mean2d=torch.tensor([[1.5, 3.5], [8.0, 3.5]]),
        depth=torch.tensor([1.0, 2.0]),
        conic=torch.tensor([[0.25, 0.0, 0.25], [0.002, 0.0, 0.002]]),
        radius=torch.tensor([6.0, 30.0]),
        visible=torch.tensor([True, True]),
        opacity=torch.tensor([0.5, 0.5]),
    )
    return p, ref.bin_view(p, 16, 8, 8)


def test_binning_and_walk_hand_counts():
    p, bins = two_tile_scene()
    # Tile 0: Gaussians 0 then 1 (depth order); tile 1: Gaussian 1 only.
    assert bins.count.tolist() == [2, 1]
    assert bins.gid.tolist() == [0, 1, 1]
    w = ref.walk_counts(ref.pack_table(p, torch.ones(2, 3)), bins)
    # Nothing stops a pixel (T stays above 1e-4 with two alphas <= 0.5):
    # every pixel evaluates every pair of its tile, 64 x 2 + 64 x 1.
    assert w["evals"] == 192
    # A pair contributes where its alpha >= 1/255: the wide Gaussian at all
    # 128 pixels; the narrow one where (dx^2 + dy^2) / 8 <= ln(127.5), i.e.
    # d^2 <= 38.8, which leaves out tile 0's two corners at x = 7 (dx 5.5,
    # dy 3.5: 42.5).
    assert w["contribs"] == 128 + 62
    # The backward walks from each tile's first pair to the pixel's last.
    # Tile 0's last contributor is its second pair (2 steps per pixel), tile
    # 1's its first.
    assert w["bwd_evals"] == 64 * 2 + 64 * 1


def test_bounds_count_pairs_emitted_not_budget():
    work = dict(evals=192, contribs=192, bwd_evals=192, pairs=3, rows=2, tiles=2, pixels=128)
    b = counts.composite_bounds(work, views=1, c=3)
    assert b["fwd_ops"] == 16 * 192 + (4 + 2 * 4) * 192
    assert b["bwd_ops"] == 16 * 192 + (30 + 9 + 7 + 3) * 192
    inputs = 4 * (2 * 10 + 3 + 2 * 2)
    assert b["fwd_bytes"] == inputs + 4 * (3 + 128 * 6)
    # One written row of 7 + C per pair emitted: 3 pairs, whatever the budget.
    assert b["bwd_bytes"] == inputs + 4 * (3 + 128 * 7 + 3 * 10)
    assert b["fwd_ms"] == 1e3 * max(b["fwd_ops"] / counts.PEAK_FP32_FLOPS,
                                    b["fwd_bytes"] / counts.PEAK_BYTES_S)


def test_network_and_ssim_ops():
    assert counts.network_ops(10, 128, 3) == 3 * 2 * 10 * (192 * 128 + 6 * 128 * 128 + 128 * 7)
    assert counts.ssim_ops(5, 3, 100) == 5 * 8 * 44 * 3 * 100
