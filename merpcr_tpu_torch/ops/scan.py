"""The strict (N=0) tile scan: tile geometry and the drivers that run the
four kernels over one tile and over the tiles of one record.

Counterpart of ``merpcr_tpu/ops/scan.py`` for the default configuration
(packed nibble planes, strict unit-projection front end, exact phase table,
t16 filter, dense W <= 11 CSR, margin cap <= 128). The JAX program runs
fixed-capacity stages inside one compiled function per tile and reports
overflow through its stage totals; here every stage sizes its output from
its own count pass, so a tile never overflows and carries no capacities.

Per tile, in order (each stage replaces the JAX lines its module names):

  front_end  -> flag words, c_total              (K1)
  expand     -> (entry, ppos) pairs, pos_total,  (K2-K5)
                pair_total
  verify_p1  -> anchor pair indices, anch_total  (K6)
  margin_p2  -> hit rows, hit_total              (K7)

Scan positions are partitioned across tiles (each position belongs to one
tile) and every coordinate is computed in record coordinates, so tiling is
invisible in the output. The host sorts hits by (pos1, tile, pair_order,
rank) to reproduce the reference's emission order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import torch

from .expand import expand
from .front_end import front_end
from .margin_p2 import margin_p2
from .table import Table
from .verify_p1 import verify_p1


@dataclass(frozen=True)
class ScanConfig:
    """Tile geometry of the strict N=0 scan (the shape-setting fields of
    the JAX package's ScanConfig; the port has no capacities)."""

    wordsize: int
    margin: int  # margin CAP: sets the halos; the runtime -M is <= it
    tile_len: int  # scan positions per tile (L)
    lead: int  # left halo in positions (multiple of 32)
    tail: int  # right halo in positions (multiple of 256)
    p1_max: int
    p2_max: int
    stride: int = 4
    exact_group: bool = True
    strict: bool = True
    t16_bits: int = 0

    @property
    def tile_buf(self) -> int:
        """Tile buffer length in POSITIONS (bases)."""
        return self.lead + self.tile_len + self.tail

    @property
    def tile_buf_in(self) -> int:
        """Tile buffer length in plane BYTES (2 bases per byte)."""
        return self.tile_buf // 2


class ScanOut(NamedTuple):
    """One tile's results: the five stage totals and the hit rows.

    Unlike the JAX ScanOut the row columns hold exactly ``hit_total``
    entries (int32 tensors on the scan's device)."""

    c_total: int  # flagged units
    pos_total: int  # (unit, phase) positions, before the t16 filter
    pair_total: int  # (position, bucket slot) pairs, after it
    anch_total: int  # primer-1-passing pairs
    hit_total: int  # hits
    pos1: torch.Tensor  # record-local anchor position
    pos2: torch.Tensor  # record-local amplicon end (inclusive)
    entry: torch.Tensor  # table entry
    pair_order: torch.Tensor  # within-tile emission key (major)
    rank: torch.Tensor  # within-anchor emission key (minor)
    rec: torch.Tensor  # record index (0: single-record scan)


def margin_cap(margin: int) -> int:
    """Halo cap for a runtime margin: the next multiple of 64 (the JAX
    package's bucketing, kept so both packages pick the same halos)."""
    return max(64, -(-margin // 64) * 64)


def default_config(
    wordsize: int,
    margin: int,
    lead: int,
    max_pcr_size: int,
    p1_max: int,
    p2_max: int,
    tile_len: int,
    stride: int = 4,
    t16_bits: int = 0,
) -> ScanConfig:
    """Halo geometry of the JAX package's ``default_config``.

    The left halo covers every primer read plus the margin window's low
    edge: the window starts mcap + len_p2 before an anchor, which itself
    sits up to the largest hash offset (``lead``) before a scan position.
    The right halo covers the longest product plus the window past the
    last scan position. Both are rounded as the JAX package rounds them
    (lead to 32 positions, tail to 256), so tiles of both packages see the
    same bytes."""
    mcap = margin_cap(margin)
    return ScanConfig(
        wordsize=wordsize,
        margin=mcap,
        tile_len=tile_len,
        lead=-(-(lead + mcap + p2_max) // 32) * 32,
        tail=-(-(max_pcr_size + 2 * mcap + p2_max + 64) // 256) * 256,
        p1_max=p1_max,
        p2_max=p2_max,
        stride=stride,
        t16_bits=t16_bits,
    )


def scan_tile(cfg: ScanConfig, table: Table, tile: torch.Tensor,
              tile_start: int, n_scan: int, record_len: int, rt) -> ScanOut:
    """Scan one halo-padded tile (``get_scan_fn``'s contract).

    ``tile``: uint8[cfg.tile_buf_in] plane; ``tile_start``: record
    position of local scan position 0; ``n_scan``: valid scan positions
    (<= tile_len); ``rt``: runtime (-M, -N, -X)."""
    if not (cfg.strict and cfg.exact_group and cfg.stride == 4):
        raise NotImplementedError(
            "only the strict front end over the exact stride-4 phase table "
            "(W <= 11) is ported; see ROADMAP queue B"
        )
    margin, nmm, x = (int(v) for v in rt)
    if margin > cfg.margin:
        raise ValueError(f"runtime margin {margin} exceeds the cap {cfg.margin}")
    n_scan = max(0, min(int(n_scan), cfg.tile_len))
    W, lead = cfg.wordsize, cfg.lead
    words, c_total = front_end(tile, table.qbloom_s, table.gq, W, lead,
                               cfg.tile_len, n_scan)
    entry, ppos, pos_total, pair_total = expand(
        tile, words, table.ptab, table.pf_bits, table.t16, table.t16_bits,
        table.bsc, table.emeta.shape[0], W, lead, cfg.tile_len, n_scan,
    )
    a_idx = verify_p1(tile, entry, ppos, table.emeta, table.p1_codes,
                      tile_start, record_len, lead, nmm, x)
    rows = margin_p2(tile, a_idx, entry, ppos, table.emeta, table.p2_codes,
                     tile_start, record_len, lead, margin, nmm, x)
    cols = rows.unbind(dim=1)
    return ScanOut(int(c_total.item()), pos_total, pair_total,
                   a_idx.numel(), rows.shape[0], *cols)


def scan_record(cfg: ScanConfig, table: Table, padded: torch.Tensor,
                start0: int, total_scan: int, record_len: int, rt,
                n_tiles: int) -> List[ScanOut]:
    """Scan ``n_tiles`` tiles of one record plane (``get_record_scan_fn``'s
    contract): tile t is the view padded[t*L/2 : t*L/2 + tile_buf_in] of
    the plane laid out as [lead zeros][record][zeros], and owns scan
    positions [start0 + t*L, start0 + (t+1)*L)."""
    L = cfg.tile_len
    if padded.numel() < (n_tiles - 1) * L // 2 + cfg.tile_buf_in:
        raise ValueError("record plane shorter than its tiles")
    outs = []
    for t in range(n_tiles):
        gstart = start0 + t * L
        tile = padded[t * L // 2 : t * L // 2 + cfg.tile_buf_in]
        outs.append(scan_tile(cfg, table, tile, gstart,
                              total_scan - gstart, record_len, rt))
    return outs
