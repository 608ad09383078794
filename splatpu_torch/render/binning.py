"""Binning budgets and tile-grid helpers (port of ``splatpu/render/binning.py``).

Only what the exact path reads is carried over.  The JAX config's TPU
mechanism knobs (``kernel``, ``scan``, ``subchunks``) have no counterpart:
the Hopper composite walks each tile's pairs serially.  Nor has
``exact_tie_order``: the port always breaks (tile, depth) ties by gaussian
id, the reference's default, and nothing in the port turns that off.  ``chunk_pairs``
stays because it is the unit budgets are rounded to, so that the port sizes
the same buffers as the reference.
"""

from __future__ import annotations

import dataclasses

DEFAULT_TILE = 32


@dataclasses.dataclass(frozen=True)
class BinningConfig:
    tile: int = 16              # pixels per tile side
    max_span: int = 32          # max tiles one Gaussian may cover
    span_small: int = 16        # lanes every Gaussian emits; wider ones go
                                # through the compacted big class
    big_capacity: int | None = None  # big-class rows; None = heuristic
    max_pairs: int = 2**20      # total pair budget
    chunk_pairs: int = 128      # budget rounding unit
    cull_tiles: bool = True     # drop pairs whose alpha bound is < 1/255

    def resolved_big_capacity(self, n: int) -> int:
        cap = self.big_capacity
        if cap is None:
            cap = min(max(1024, n // 16), 65536)
        return max(1, min(cap, n))


def grow_for_span_overflow(config: BinningConfig, n: int) -> BinningConfig:
    """Double max_span and the resolved big-class capacity: a span overflow
    is either exhaustion, and doubling both clears whichever fired."""
    return dataclasses.replace(
        config,
        max_span=config.max_span * 2,
        big_capacity=min(config.resolved_big_capacity(n) * 2, n),
    )


def tile_grid(width: int, height: int, tile: int) -> tuple[int, int]:
    return -(-width // tile), -(-height // tile)


def _depth_bits_for(num_tiles: int) -> int:
    """Depth bits left in a u32 key after the tile field (which must hold
    num_tiles inclusive, the invalid sentinel); capped at 24."""
    tile_bits = max(1, (num_tiles + 1).bit_length())
    bits = min(32 - tile_bits, 24)
    if bits < 8:
        raise ValueError(f"image too large: {num_tiles} tiles leaves {bits} depth bits")
    return bits
