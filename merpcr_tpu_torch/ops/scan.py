"""The tile scan: tile geometry and the drivers that run the kernels over
one tile and over the tiles of one plane.

Counterpart of ``merpcr_tpu/ops/scan.py`` at every word size 3..16 and
every margin 0..10000. A packed nibble plane scans in one of three
front-end modes:

* strict, -N 0: the unit-projection front end over ``qbloom_s`` and the
  t16 position filter (K1, K4);
* strict, -N 1 (``strict_n=1``): the same kernels over the strict1 tables
  ``qbloom_s1``/``t16_1``, when ``build_strict1`` armed them;
* loose: the stride-group front end over the group table ``qbloom``
  (K8) and the group expansion, for -N >= 2, for -N 1 when strict1 did
  not arm, and for STS sets that disarm strict;

the word size choosing the tables as the table compiler built them
(``stride``, ``exact_group``, ``qbloom_bits`` and ``Table.csr``; K12):
stride-4 exact span tables and ``bsc`` rows at W <= 11, stride-2 exact
tables at W = 12 (``bstart``) and 13 (binary search), and at W >= 14 a
mult-hash group bloom, no phase table and the binary search;

with the dirty-span phase filter (K10, ``dirty_bloom``, strict only), the
IUPAC verify (K11, ``iupac``) and stream mode (K14): a plane holds one
record or many records laid end to end, and ``rmeta``/``recmap`` tell each
candidate its record; and a fourth mode for raw-byte planes (K9,
``packed`` False: a record with bytes outside the 16-letter alphabet, one
byte per position, one record per plane), which scans loose at every -N
without K10. The JAX program runs fixed-capacity stages inside
one compiled function per tile and reports overflow through its stage
totals. Here a tile runs in one of two ways: count first (``scan_tile``,
``scan_stream``), each stage's output sized from the count the host read
after the stage before, so a tile never overflows; or deferred
(``dispatch_stream`` / ``collect_stream``, the engine's path), every tile
of a plane enqueued with each stage reading the count before it from
device memory into buffers of fixed capacity, the host reading once per
plane and rerunning count first the rare tile that passed a buffer.

Per tile, in order (each stage replaces the JAX lines its module names):

  front_end / front_end_loose  -> flag words, c_total        (K1 / K8)
  expand / expand_loose        -> (entry, ppos) pairs,       (K2-K5, K10)
                                  pos_total, pair_total
  verify_p1                    -> anchor pair indices,       (K6, K11, K14)
                                  anch_total
  margin_p2                    -> hit rows, hit_total        (K7, K11, K14)

and on a raw-byte plane (``scan.py`` with ``cfg.packed`` False):

  front_end_raw                -> flag words (one bit per position), c_total (K9a)
  expand_raw                   -> (entry, ppos) pairs, pos_total 0, pair_total (K9b)
  verify_p1_raw, margin_p2_raw -> anchors, hit rows (byte verifies, K9c)

Scan positions are partitioned across tiles (each position belongs to one
tile) and every bound and output coordinate is computed in the
coordinates of the candidate's record, so tiling is invisible in the
output. The host sorts hits by (pos1, tile, pair_order, rank) to
reproduce the reference's emission order.

The single-record scan is the stream scan of a plane that holds one
record: ``rmeta = [(0, record_len)]`` and no ``recmap`` (``record_rmeta``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import torch

from .. import trace
from . import expand as expand_mod
from . import kernels
from . import margin_p2 as margin_p2_mod
from .expand import expand, expand_loose, expand_raw
from .front_end import flag_count, front_end, front_end_loose, front_end_raw
from .margin_p2 import margin_p2, margin_p2_raw
from .table import Table
from .verify_p1 import verify_p1, verify_p1_raw


@dataclass(frozen=True)
class ScanConfig:
    """Tile geometry and front-end mode of the scan (the shape-setting
    fields of the JAX package's ScanConfig; the port has no capacities)."""

    wordsize: int
    margin: int  # margin CAP: sets the halos; the runtime -M is <= it
    tile_len: int  # scan positions per tile (L)
    lead: int  # left halo in positions (multiple of 32)
    tail: int  # right halo in positions (multiple of 256)
    p1_max: int
    p2_max: int
    stride: int = 4  # scan positions per group-table lookup (2 at W >= 12)
    exact_group: bool = True  # exact span tables qbloom/ptab (W <= 13)
    qbloom_bits: int = 0  # log2 bits of the mult-hash group bloom (W >= 14)
    strict: bool = True  # strict unit front end (K1); False: loose (K8)
    strict_n: int = 0  # mismatch budget of the strict tables: 0 qbloom_s/t16,
    #                    1 qbloom_s1/t16_1 (strict1); 0 when loose
    t16_bits: int = 0  # log2 bits of the 16-base filter; 0: none (loose)
    bloom_bits: int = 0  # log2 bits of the table's W-mer bloom
    # K10 (strict only): dirty-span phases are kept only if the bloom holds
    # their W-mer (armed when the dirty-in-16/clean-in-11 position rate
    # reaches 1/256)
    dirty_bloom: bool = False
    iupac: bool = False  # K11: -I 1 expansion-set verify
    stream: bool = False  # K14: many records per plane (recmap given)
    # False: a raw-byte plane, one byte per position (K9: records with bytes
    # outside the 16-letter alphabet; loose, no K10)
    packed: bool = True

    @property
    def tile_buf(self) -> int:
        """Tile buffer length in POSITIONS (bases)."""
        return self.lead + self.tile_len + self.tail

    @property
    def tile_buf_in(self) -> int:
        """Tile buffer length in plane BYTES (2 bases per byte when
        packed, 1 on a raw plane)."""
        return self.tile_buf // 2 if self.packed else self.tile_buf

    @property
    def tile_step_in(self) -> int:
        """Plane bytes from one tile's start to the next's."""
        return self.tile_len // 2 if self.packed else self.tile_len


class ScanOut(NamedTuple):
    """One tile's results: the five stage totals and the hit rows.

    Unlike the JAX ScanOut the row columns hold exactly ``hit_total``
    entries (int32 tensors on the scan's device)."""

    c_total: int  # flagged units (strict) or stride groups (loose)
    pos_total: int  # (unit/group, phase) positions, before the t16 filter
    pair_total: int  # (position, bucket slot) pairs, after it
    anch_total: int  # primer-1-passing pairs
    hit_total: int  # hits
    pos1: torch.Tensor  # record-local anchor position
    pos2: torch.Tensor  # record-local amplicon end (inclusive)
    entry: torch.Tensor  # table entry
    pair_order: torch.Tensor  # within-tile emission key (major)
    rank: torch.Tensor  # within-anchor emission key (minor)
    rec: torch.Tensor  # rmeta row of the hit (0: single-record scan)


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
    exact_group: bool = True,
    qbloom_bits: int = 0,
    strict: bool = True,
    strict_n: int = 0,
    t16_bits: int = 0,
    bloom_bits: int = 0,
    iupac: bool = False,
    stream: bool = False,
    dirty_pos_rate: float = 0.0,
    packed: bool = True,
) -> ScanConfig:
    """Halo geometry and filter choice of the JAX package's
    ``default_config`` (``scan.py:1415-1634``).

    The left halo covers every primer read plus the margin window's low
    edge: the window starts mcap + len_p2 before an anchor, which itself
    sits up to the largest hash offset (``lead``) before a scan position.
    The right halo covers the longest product plus the window past the
    last scan position. Both are rounded as the JAX package rounds them
    (lead to 32 positions, tail to 256), so tiles of both packages see the
    same bytes.

    ``dirty_pos_rate`` is the quantized rate of positions dirty in their
    16-base window but clean in their W-mer; at 1/256 and above the
    dirty-span phase filter is armed in strict mode, as in the JAX package
    (``scan.py:1542-1543``); the loose path never arms it. ``strict_n``
    and ``t16_bits`` are the strict tables' (the caller passes
    ``t16_1_bits`` at strict_n 1) and are 0 on the loose path.

    ``packed`` False configures a raw-byte plane (K9), which the strict
    front end and the dirty-span filter do not exist for: it forces the
    loose path (``scan.py:1502``, ``:1542-1543``). Its halos are the
    packed ones, counted in positions."""
    mcap = margin_cap(margin)
    strict = strict and packed
    dirty_pos = min(max(dirty_pos_rate, 0.0), 1.0)
    return ScanConfig(
        wordsize=wordsize,
        margin=mcap,
        tile_len=tile_len,
        lead=-(-(lead + mcap + p2_max) // 32) * 32,
        tail=-(-(max_pcr_size + 2 * mcap + p2_max + 64) // 256) * 256,
        p1_max=p1_max,
        p2_max=p2_max,
        stride=stride,
        exact_group=exact_group,
        qbloom_bits=0 if exact_group else qbloom_bits,
        strict=strict,
        strict_n=strict_n if strict else 0,
        t16_bits=t16_bits if strict else 0,
        bloom_bits=bloom_bits,
        dirty_bloom=strict and dirty_pos >= 1.0 / 256,
        iupac=iupac,
        stream=stream,
        packed=packed,
    )


def record_rmeta(record_len: int, device) -> torch.Tensor:
    """``rmeta`` of a plane that holds one record: [(0, record_len)]."""
    return torch.tensor([[0, record_len]], dtype=torch.int32, device=device)


def _check(cfg: ScanConfig, table: Table, rt) -> None:
    if (cfg.wordsize, cfg.stride, cfg.exact_group) != (
            table.wordsize, table.stride, table.exact_group):
        raise ValueError("the config's word size, stride or group-table kind "
                         "is not the table's")
    if cfg.dirty_bloom and (cfg.bloom_bits != table.bloom_bits or not cfg.strict):
        raise ValueError("the dirty-span filter needs the strict front end and "
                         f"the table's bloom ({cfg.bloom_bits} != {table.bloom_bits} bits)")
    if int(rt[0]) > cfg.margin:
        raise ValueError(f"runtime margin {int(rt[0])} exceeds the cap {cfg.margin}")


def _front_and_expand(cfg: ScanConfig, table: Table, tile: torch.Tensor,
                      n_scan: int, totals=None):
    """The tile's front end and expansion in the config's mode: strict
    (K1 + K2-K5, K10), loose (K8) or raw (K9a/b). Count-first (``totals``
    None): (c_total, (entry, ppos, pos_total, pair_total)); deferred: the
    expansion's (entry, ppos) buffers, its totals in ``totals``."""
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    n_entries = table.emeta.shape[0]
    if not cfg.packed:
        words, c_total = front_end_raw(tile, table.bloom, table.bloom_bits, W,
                                       lead, L, n_scan, table.raw_prefilter)
        fn = expand_raw
        args = (tile, words, table.csr, n_entries, W, lead, L, n_scan)
    elif not cfg.strict:
        words, c_total = front_end_loose(tile, table.qbloom, table.q_bits, W,
                                         lead, L, n_scan, cfg.stride,
                                         cfg.qbloom_bits, table.loose_prefilter)
        fn = expand_loose
        args = (tile, words, table.ptab, table.pf_bits, table.csr, n_entries, W,
                lead, L, n_scan, cfg.stride, cfg.exact_group)
    else:
        if cfg.strict_n == 1:
            if not table.strict1:
                raise ValueError("strict_n 1 needs a table whose strict1 variant armed")
            qb, gq, t16, t16_bits = table.qbloom_s1, table.gq1, table.t16_1, table.t16_1_bits
        else:
            qb, gq, t16, t16_bits = table.qbloom_s, table.gq, table.t16, table.t16_bits
        if cfg.t16_bits != t16_bits:
            raise ValueError(f"config t16_bits {cfg.t16_bits} != table's {t16_bits}")
        words, c_total = front_end(tile, qb, gq, W, lead, L, n_scan)
        fn = expand
        args = (tile, words, table.ptab, table.pf_bits, t16, t16_bits, table.csr,
                n_entries, W, lead, L, n_scan, cfg.stride, cfg.exact_group,
                table.bloom if cfg.dirty_bloom else None, cfg.bloom_bits)
    if totals is None:
        return c_total, fn(*args)
    return fn(*args, totals=totals, c_total=c_total)


def _primers(cfg: ScanConfig, table: Table) -> tuple:
    """(p1, p1 -I 1 table, p2, p2 -I 1 table) of the verifies: codes and
    expansion masks on a nibble plane, bytes and the match table on a raw
    one (K9c); the -I 1 tables are None at -I 0."""
    if not cfg.packed:
        match = table.match if cfg.iupac else None
        return table.p1_bytes, match, table.p2_bytes, match
    if cfg.iupac:
        return table.p1_codes, table.p1_exp, table.p2_codes, table.p2_exp
    return table.p1_codes, None, table.p2_codes, None


def scan_tile(cfg: ScanConfig, table: Table, tile: torch.Tensor,
              tile_start: int, n_scan: int, rmeta: torch.Tensor, recmap,
              rt) -> ScanOut:
    """Scan one halo-padded tile (``get_scan_fn``'s contract, and with
    ``cfg.stream`` the tile body of ``get_stream_scan_fn``): count first,
    each stage's buffer sized from the count the host read after the stage
    before.

    ``tile``: uint8[cfg.tile_buf_in] plane (nibbles, or with
    ``cfg.packed`` False one byte per position); ``tile_start``: plane position
    of local scan position 0; ``n_scan``: valid scan positions (<=
    tile_len); ``rmeta``: int32[R, 2] (start, length) of the plane's
    records; ``recmap``: int32[ceil(plane length / 8)] block -> record for
    a stream plane, None for one record; ``rt``: runtime (-M, -N, -X)."""
    _check(cfg, table, rt)
    margin, nmm, x = (int(v) for v in rt)
    n_scan = max(0, min(int(n_scan), cfg.tile_len))
    c_total, (entry, ppos, pos_total, pair_total) = _front_and_expand(
        cfg, table, tile, n_scan)
    p1, p1x, p2, p2x = _primers(cfg, table)
    vf, mf = (verify_p1, margin_p2) if cfg.packed else (verify_p1_raw, margin_p2_raw)
    a_idx = vf(tile, entry, ppos, table.emeta, p1, p1x, tile_start, rmeta, recmap,
               cfg.lead, nmm, x)
    rows = mf(tile, a_idx, entry, ppos, table.emeta, p2, p2x, tile_start, rmeta,
              recmap, cfg.lead, margin, nmm, x)
    # the front end's c_total came to the host with expand's totals
    return ScanOut(flag_count(c_total), pos_total, pair_total, a_idx.numel(),
                   rows.shape[0], *rows.unbind(dim=1))


def _tiles(cfg: ScanConfig, plane: torch.Tensor, total_scan: int,
           stream_len: int, recmap, n_tiles: int, start: int):
    """(tile view, first scan position, scan positions) of each of the
    plane's ``n_tiles`` tiles."""
    L, S = cfg.tile_len, cfg.tile_step_in
    if plane.numel() < (n_tiles - 1) * S + cfg.tile_buf_in:
        raise ValueError("plane shorter than its tiles")
    if recmap is not None and recmap.numel() != -(-stream_len // 8):
        raise ValueError(f"recmap of {recmap.numel()} blocks for {stream_len} positions")
    for t in range(n_tiles):
        t0 = start + t * L
        yield plane[t * S : t * S + cfg.tile_buf_in], t0, min(max(total_scan - t0, 0), L)


def scan_stream(cfg: ScanConfig, table: Table, plane: torch.Tensor,
                total_scan: int, stream_len: int, rmeta: torch.Tensor,
                recmap, rt, n_tiles: int, start: int = 0) -> List[ScanOut]:
    """Scan ``n_tiles`` tiles of one plane (``get_stream_scan_fn``'s
    contract, and ``get_record_scan_fn``'s for a one-record plane), count
    first, tile by tile: tile t
    is the view plane[t*S : t*S + tile_buf_in] (S = ``tile_step_in``: L/2
    bytes of a nibble plane, L of a raw one) of the plane laid out as
    [lead][records][tail], and owns scan positions [start + t*L, start +
    (t+1)*L) of the ``total_scan`` positions; ``stream_len`` is the
    laid-out length (the last record's end). ``start`` is the first scan
    position of ``plane``: 0 for a whole plane, the shard's first position
    for one shard's slice (``parallel.sharded``), whose tiles past
    ``total_scan`` own no position (``n_scan`` 0)."""
    return [scan_tile(cfg, table, tile, t0, n_scan, rmeta, recmap, rt)
            for tile, t0, n_scan in _tiles(cfg, plane, total_scan, stream_len,
                                            recmap, n_tiles, start)]


class PendingScan(NamedTuple):
    """A plane whose tiles ``dispatch_stream`` enqueued (``collect_stream``
    reads it): the scan's inputs, kept for the reruns, and ``buf``, the
    plane's totals (int32[n_tiles, 5] in ScanOut order) followed by its
    rows (int32[n_tiles, row_cap, 6]), with ``host``, the pinned copy of
    ``buf`` that ``event`` follows (None on the CPU)."""

    cfg: ScanConfig
    table: Table
    plane: torch.Tensor
    total_scan: int
    stream_len: int
    rmeta: torch.Tensor
    recmap: object
    rt: tuple
    n_tiles: int
    start: int
    pair_cap: int
    row_cap: int
    buf: torch.Tensor
    host: object
    event: object


def dispatch_stream(cfg: ScanConfig, table: Table, plane: torch.Tensor,
                    total_scan: int, stream_len: int, rmeta: torch.Tensor,
                    recmap, rt, n_tiles: int, start: int = 0) -> PendingScan:
    """Enqueue the scan of ``n_tiles`` tiles of one plane (``scan_stream``'s
    arguments) without a host read: the deferred tile scan, the
    counterpart of the JAX package's one program per tile group
    (``get_record_scan_fn`` / ``get_stream_scan_fn``, dispatched without
    blocking). Per tile the front end, then ``expand``, ``verify_p1`` and
    ``margin_p2`` (or their loose or raw forms) in their deferred mode
    (given ``totals``), each taking the stage before's count from device
    memory and writing into buffers of fixed
    capacity: ``expand.pair_cap(tile_len)`` pairs (and as many anchors) and
    ``margin_p2.ROW_CAP`` rows; every tile's five totals go into one device
    int32[n_tiles, 5]. On the card the plane's totals and rows are then
    copied to pinned host memory behind an event, so the host waits once per
    plane, in ``collect_stream``. On the CPU the same stages run their plain
    versions at once, with the same buffer contract."""
    _check(cfg, table, rt)
    margin, nmm, x = (int(v) for v in rt)
    row_cap = margin_p2_mod.ROW_CAP
    dev = plane.device
    buf = torch.empty(n_tiles * (5 + 6 * row_cap), dtype=torch.int32, device=dev)
    totals = buf[: 5 * n_tiles].view(n_tiles, 5)
    rows = buf[5 * n_tiles :].view(n_tiles, row_cap, 6)
    p1, p1x, p2, p2x = _primers(cfg, table)
    vf, mf = (verify_p1, margin_p2) if cfg.packed else (verify_p1_raw, margin_p2_raw)
    host = event = None
    with trace.span("dispatch.enqueue"):
        for t, (tile, t0, n_scan) in enumerate(_tiles(cfg, plane, total_scan, stream_len,
                                                      recmap, n_tiles, start)):
            tot = totals[t]
            entry, ppos = _front_and_expand(cfg, table, tile, n_scan, tot)
            a_idx = vf(tile, entry, ppos, table.emeta, p1, p1x, t0, rmeta, recmap,
                       cfg.lead, nmm, x, totals=tot)
            mf(tile, a_idx, entry, ppos, table.emeta, p2, p2x, t0, rmeta, recmap,
               cfg.lead, margin, nmm, x, totals=tot, rows=rows[t])
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                host = torch.empty(buf.shape, dtype=buf.dtype, pin_memory=True)
                host.copy_(buf, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
    return PendingScan(cfg, table, plane, total_scan, stream_len, rmeta, recmap,
                       tuple(rt), n_tiles, start, expand_mod.pair_cap(cfg.tile_len),
                       row_cap, buf, host, event)


def collect_stream(p: PendingScan) -> tuple:
    """The tiles of a dispatched plane: (list of ScanOut, the indices of the
    tiles rerun). One host read (``ScanState.wait``) brings every tile's
    totals and rows; a tile whose pair_total passed the pair buffer or whose
    hit_total passed the row buffer is rerun through the count-first path
    (``scan_tile``), so no hit is dropped. The other tiles' rows are host
    tensors."""
    if p.event is not None:
        with trace.span("collect.wait"):
            kernels.scan_state(p.plane).wait(p.event)
        got = p.host
    else:
        got = p.buf
    n = p.n_tiles
    totals = got[: 5 * n].view(n, 5).tolist()
    rows = got[5 * n :].view(n, p.row_cap, 6)
    outs, reruns = [], {}
    tiles = _tiles(p.cfg, p.plane, p.total_scan, p.stream_len, p.recmap, n, p.start)
    for t, (tile, tot) in enumerate(zip(tiles, totals)):
        if tot[2] > p.pair_cap or tot[4] > p.row_cap:
            reruns[t] = tile
            outs.append(None)
        else:
            outs.append(ScanOut(*tot, *rows[t, : tot[4]].unbind(dim=1)))
    if reruns:
        with trace.span("collect.rerun"):
            for t, (tile, t0, n_scan) in reruns.items():
                outs[t] = scan_tile(p.cfg, p.table, tile, t0, n_scan, p.rmeta, p.recmap,
                                    p.rt)
    search_trace = trace.active()
    if search_trace is not None:
        search_trace.add("flagged", sum(o.c_total for o in outs))
        search_trace.add("positions", sum(o.pos_total for o in outs))
        search_trace.add("pairs", sum(o.pair_total for o in outs))
    return outs, list(reruns)
