"""Stage-1 command line (port of ``splatpu/cli/densify.py``): for now the
binning-budget flags that ``cli/train.py`` shares with it.  Stage 1 itself
and its ``main`` are not ported yet (ROADMAP A.4)."""

from __future__ import annotations

import argparse

BINNING_FLAGS = ("tile", "max_pairs", "max_span", "span_small", "chunk_pairs", "big_capacity")


def add_binning_flags(p: argparse.ArgumentParser) -> None:
    """The binning-budget flags; a flag left out keeps the sized default."""
    g = p.add_argument_group("binning budgets")
    g.add_argument("--tile", type=int, default=None,
                   help="pixels per tile side (8, 16, 24 or 32)")
    g.add_argument("--max-pairs", type=int, default=None,
                   help="total (tile, gaussian) pair budget per render")
    g.add_argument("--max-span", type=int, default=None,
                   help="max tiles a single Gaussian may cover")
    g.add_argument("--span-small", type=int, default=None,
                   help="emission lanes for every Gaussian (two-class split)")
    g.add_argument("--chunk-pairs", type=int, default=None,
                   help="pair-stream chunk size (multiple of 128)")
    g.add_argument("--big-capacity", type=int, default=None,
                   help="static big-Gaussian emission slots")


def binning_from_args(args) -> dict | None:
    """The flags given, as field overrides applied on top of the sized
    budget (a single flag such as --tile keeps the sizing of the others)."""
    overrides = {k: getattr(args, k) for k in BINNING_FLAGS if getattr(args, k) is not None}
    return overrides or None
