"""The least time the card could take for the tiles a search scanned.

The count follows what a search has to do, not what the port's kernels
happen to read, so that no later design (fused, split or removed launches)
can read above 100 %: every tile's genome bytes are read once, two bases a
byte on a nibble plane and one on a raw-byte plane, and every hit leaves the
card once as the three numbers its line needs (pos1, pos2, entry: 12
bytes). The pairs and anchors between the stages, and the table words they
gather, are left out: a design may keep them on chip, and which words it
reads is its own layout's business. No operation count is made: a position,
a pair or a rank can be tested many to an instruction, so none bounds the
time from below, and the bound is the memory's alone.

Peak: NVIDIA H100 SXM5 data sheet, HBM3 3.35 TB/s, at the card's full power
limit (700 W); the run prints the card's own limit beside it.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
HIT_BYTES = 12


def tile_bytes(packed: bool, n_scan: int, hit_total: int) -> int:
    """The least bytes one tile moves: its scan positions' bases read once
    and its hits written once."""
    genome = (n_scan + 1) // 2 if packed else n_scan
    return genome + HIT_BYTES * hit_total


def least_seconds(tiles) -> float:
    """The memory bound of ``tiles``: (packed, n_scan, hit_total) each."""
    return sum(tile_bytes(*t) for t in tiles) / HBM_BYTES_PER_S
