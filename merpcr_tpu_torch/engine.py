"""MerPCR engine on PyTorch and CUDA: the user-facing orchestration class.

API parity with the reference ``src/merpcr/core/engine.py`` class
``MerPCR`` (engine.py:44-97), as in the JAX package ``merpcr_tpu``: the same
constructor parameters, bounds validation, ``load_sts_file`` /
``load_fasta_file`` / ``search`` methods and output format. The search runs
the tile scan (``ops.scan``) as hand-written CUDA kernels on an NVIDIA
GPU; its output is byte-identical to ``merpcr_tpu`` run on its
device path (``MERPCR_TPU_HOST_MAX=0``), which is itself held to the
reference CLI's T=1 output.

What this engine scans: every -W (3 to 16), -M (0 to 10000), -N (0 to 10)
and -I (0 or 1) the reference accepts, on any record. The word size picks
the lookup tables as the table compiler built them (stride-4 exact tables
and dense CSR rows at
W <= 11; stride 2 above, with bucket starts at W = 12, a binary search at
W >= 13 and a mult-hash group bloom without a phase table at W >= 14),
and the margin only sizes the tile halos and the ranks per anchor. The front
end follows the JAX package's choice (``merpcr_tpu/engine.py:346-368``):
-N 0 scans strict over the N=0 tables; -N 1 builds the strict1 tables on
its first search and scans strict over them when they arm; every other
search (-N >= 2, -N 1 without strict1, an STS set that disarms strict)
scans loose (K8). The dirty-span phase filter arms itself in strict mode
as in the JAX package. A record in the 16-letter FASTA alphabet is scanned
as a nibble plane; one with other bytes (only the API can pass one: the
FASTA loader drops them) as a raw-byte plane, one byte per position, with
the reference's byte semantics (K9: loose at every -N, no strict1 build,
no dirty-span filter), as the JAX package's raw-byte path does.

Multi-record FASTA takes the stream path (``merpcr_tpu/engine.py``
``_dispatch_stream``/``_collect_stream``): every run of two or more
consecutive packable records is laid end to end in one plane, separated by
0xFF gaps, and scanned as tiles of up to 2^21 positions, so the kernels
launch once per tile, not once per record. A lone record takes the record
path (one record per plane).

Small inputs skip the card: when all records together hold at most
``MERPCR_TPU_HOST_MAX`` bases (default 2,000,000), no mesh or second
process is set and the table is not yet on the engine's device, every
record is scanned in NumPy (``ops.host_scan``, the JAX package's host fast
path, ``merpcr_tpu/engine.py:1436-1509``), with no table upload and no
kernel; a record whose candidates or window work pass that path's caps is
scanned on the record path instead. Once a search has put the table on the
device, small inputs run on the kernels too: the host path saves the
upload and the first launches, and a warm card scans faster than NumPy.
The bytes are the same either way.

Several devices (``use_mesh``) and several processes (``enable_multihost``)
take the sharded scan of ``parallel`` (K15, the JAX package's
``shard_map`` path): each plane's scan positions are cut into one span of
whole tiles per shard, every shard tile runs the same kernels on its
shard's device, and the tiles keep their global index, so the output bytes
are the single-device bytes for any shard count.
"""

from __future__ import annotations

import itertools
import logging
import math
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from .io.fasta import FASTALoader, record_packed, record_seq_bytes
from .io.sts import STSLoader
from .models import FASTARecord
from .ops.encoding import AMBIG, SCODE
from .ops.host_scan import host_scan_record
from .ops.scan import ScanConfig, default_config, scan_stream
from .ops.table import build_strict1, compile_table, table_from_numpy
from .parallel import distributed
from .parallel.sharded import make_mesh, sharded_scan_record, sharded_scan_stream

# Constants (reference engine.py:17-39)
DEFAULT_MARGIN = 50
DEFAULT_WORDSIZE = 11
DEFAULT_MISMATCHES = 0
DEFAULT_THREE_PRIME_MATCH = 1
DEFAULT_IUPAC_MODE = 0
DEFAULT_THREADS = 1
DEFAULT_PCR_SIZE = 240

MIN_WORDSIZE = 3
MAX_WORDSIZE = 16
MIN_MISMATCHES = 0
MAX_MISMATCHES = 10
MIN_MARGIN = 0
MAX_MARGIN = 10000
MIN_THREE_PRIME_MATCH = 0
MIN_PCR_SIZE = 1
MAX_PCR_SIZE = 10000

# Tile-length buckets (the JAX package's): the smallest bucket covering the
# record is used, large genomes scan 2^23-position tiles; a stream plane's
# tiles stop at STREAM_MAX_TILE.
TILE_LEN_BUCKETS = (1 << 15, 1 << 17, 1 << 19, 1 << 21, 1 << 23)
STREAM_MAX_TILE = 1 << 21

logger = logging.getLogger(__name__)
# per-process number of a search's trace file (MERPCR_TPU_TRACE)
_TRACE_SEQ = itertools.count()


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card. Asking for CUDA without one raises:
    the engine never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions of the kernels"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class PlaneScan(tuple):
    """(cfg, tiles, records) of one scanned plane, with ``shards``: the
    mesh's shard count (1 without a mesh). ``tiles`` counts the plane's
    real tiles; a mesh of n shards scans n * ceil(tiles / n) global tiles,
    the rest padding."""

    def __new__(cls, cfg, tiles: int, records: int, shards: int = 1):
        self = super().__new__(cls, (cfg, tiles, records))
        self.shards = shards
        return self

    cfg = property(lambda self: self[0])
    tiles = property(lambda self: self[1])
    records = property(lambda self: self[2])


class MerPCR:
    """e-PCR engine on PyTorch/CUDA (API parity: reference engine.py:44-97)."""

    def __init__(
        self,
        wordsize: int = DEFAULT_WORDSIZE,
        margin: int = DEFAULT_MARGIN,
        mismatches: int = DEFAULT_MISMATCHES,
        three_prime_match: int = DEFAULT_THREE_PRIME_MATCH,
        iupac_mode: int = DEFAULT_IUPAC_MODE,
        default_pcr_size: int = DEFAULT_PCR_SIZE,
        threads: int = DEFAULT_THREADS,
        max_sts_line_length: int = 1022,
        device=None,
    ):
        self.wordsize = wordsize
        self.margin = margin
        self.mismatches = mismatches
        self.three_prime_match = three_prime_match
        self.iupac_mode = iupac_mode
        self.default_pcr_size = default_pcr_size
        self.threads = threads
        # Accepted-but-unused in the reference too (SURVEY.md §2.1, cli.py:202-208)
        self.max_sts_line_length = max_sts_line_length
        self.device = resolve_device(device)

        self.sts_records = []
        self.max_pcr_size = 0
        self.total_hits = 0

        # PlaneScan (ScanConfig, tiles, records; .shards) of every plane
        # the last search scanned, in order
        self.last_scans: list = []
        self._table_host = None  # HostTable of NumPy arrays
        self._tables: dict = {}  # device -> Table (see _table)
        # 1-D device mesh of the sharded scan (use_mesh), None: one device
        self.mesh: Optional[tuple] = None
        # several processes (enable_multihost): every rank scans its shard
        # of every plane and only rank 0 writes
        self._multihost = False
        self._meta = None  # TableMeta
        self._strict1_tried = False  # build_strict1 ran for this table
        # Test hook: force a specific tile length (exercises multi-tile
        # paths on small inputs). None -> TILE_LEN_BUCKETS heuristic.
        self._tile_len_override: Optional[int] = None

        self._validate_parameters()

    def _validate_parameters(self):
        """Bounds validation (reference engine.py:80-97)."""
        if not (MIN_WORDSIZE <= self.wordsize <= MAX_WORDSIZE):
            raise ValueError(
                f"Word size must be between {MIN_WORDSIZE} and {MAX_WORDSIZE}"
            )
        if not (MIN_MISMATCHES <= self.mismatches <= MAX_MISMATCHES):
            raise ValueError(
                f"Number of mismatches must be between {MIN_MISMATCHES} and {MAX_MISMATCHES}"
            )
        if not (MIN_MARGIN <= self.margin <= MAX_MARGIN):
            raise ValueError(f"Margin must be between {MIN_MARGIN} and {MAX_MARGIN}")
        if self.three_prime_match < MIN_THREE_PRIME_MATCH:
            raise ValueError(
                f"Three prime match must be at least {MIN_THREE_PRIME_MATCH}"
            )
        if not (MIN_PCR_SIZE <= self.default_pcr_size <= MAX_PCR_SIZE):
            raise ValueError(
                f"Default PCR size must be between {MIN_PCR_SIZE} and {MAX_PCR_SIZE}"
            )

    def use_mesh(self, mesh) -> "MerPCR":
        """Shard the scan across a 1-D mesh (``parallel.make_mesh``: a
        tuple of devices, one per shard; None: one device again). Tiles
        are partitioned by scan position and the table replicated; the
        output is byte-identical to the single-device path
        (``merpcr_tpu/engine.py:185-190``)."""
        self.mesh = None if mesh is None else make_mesh(mesh)
        return self

    def enable_multihost(
        self,
        coordinator_address: Optional[str] = None,
        num_processes: Optional[int] = None,
        process_id: Optional[int] = None,
    ) -> "MerPCR":
        """Run the search over every process of a ``torch.distributed``
        group (``merpcr_tpu/engine.py:192-213``): starts the gloo group
        (``parallel.distributed.initialize``: a no-op in one process or
        when a group exists), scans on this rank's device, one shard per
        rank (``global_mesh``), and gates emission in :meth:`search` so
        that rank 0 alone writes. The rows are gathered to every rank, so
        every rank returns the same ``total_hits``."""
        distributed.initialize(coordinator_address, num_processes, process_id)
        self._multihost = True
        self.device = distributed.rank_device(self.device)
        return self.use_mesh(distributed.global_mesh(self.device))

    @property
    def _table(self):
        """The compiled table on the engine's device (moved on first use)."""
        if self._table_host is None:
            return None
        if self.device not in self._tables:
            self._tables[self.device] = table_from_numpy(
                self._table_host, self._meta, self.device
            )
        return self._tables[self.device]

    # ------------------------------------------------------------------ load
    def load_sts_file(self, filename: str) -> bool:
        """Load + compile the STS set (reference engine.py:193-302)."""
        res = STSLoader.load_file(filename, self.wordsize, self.default_pcr_size)
        if not res.ok:
            return False
        self.sts_records = res.records
        self.max_pcr_size = res.max_pcr_size
        self._table_host, self._meta = compile_table(
            res, self.wordsize, bool(self.iupac_mode)
        )
        self._tables = {}
        self._strict1_tried = False
        return True

    def load_fasta_file(self, filename: str) -> List[FASTARecord]:
        """Reference engine.py:361-363."""
        return FASTALoader.load_file(filename)

    # ---------------------------------------------------------------- search
    @staticmethod
    def _quantize_dirty(d: float) -> float:
        """Quantize a measured dirty rate to log2 buckets (the JAX
        package's quantization, so both decide the same way whether a
        genome needs the dirty-span filter)."""
        if d < 1e-3:
            return 0.0
        return min(0.5, 2.0 ** round(math.log2(d)))

    @staticmethod
    def _dirty_of(seq: np.ndarray, packed_rec) -> tuple:
        """(w_unit, w_pos) WINDOW dirty rates of one record, measured
        with the scan's unit structure (never derived from the base
        rate — derivations are wrong by an order of magnitude for
        run-clustered dirt):

        * ``w_unit`` — fraction of u32-unit windows whose KEYED bases
          (~7..19) contain a non-ACGT base while SOME phase's W-mer
          window is clean: exactly the units the strict front end flags
          for table bypass (``flag = pvU & (hitu | ~vq)``).
        * ``w_pos`` — fraction of positions dirty-in-16 but
          clean-in-~11: the ones that expand phases through the exact
          CSR with no table filter.
        """
        if packed_rec is not None and len(packed_rec):
            b = packed_rec
            db = (((b & 0xF) >= 4) | ((b >> 4) >= 4)).astype(np.int32)
            cs = np.concatenate(([0], np.cumsum(db)))
            if len(cs) <= 13:
                any_d = bool(db.any())
                return (float(any_d), 0.0)
            # byte granularity: 1 byte = 2 bases. Unit key bases 7..19
            # ~ bytes 3..9; phase W-mer windows ~ 6-byte windows at byte
            # offsets 0..4; position windows: 8 B = 16 bases, 6 B ~ 11.
            idx = np.arange(0, len(cs) - 13, max(1, len(cs) >> 14))
            key_d = (cs[idx + 10] - cs[idx + 3]) > 0
            phase_c = np.zeros(len(idx), dtype=bool)
            for d in range(5):
                phase_c |= (cs[idx + d + 6] - cs[idx + d]) == 0
            w_unit = float((key_d & phase_c).mean())
            w16 = (cs[idx + 8] - cs[idx]) > 0
            w11 = (cs[idx + 6] - cs[idx]) > 0
            return (w_unit, float((w16 & ~w11).mean()))
        if seq is None or not len(seq):
            return (0.0, 0.0)
        db = (SCODE[seq] == AMBIG).astype(np.int32)
        cs = np.concatenate(([0], np.cumsum(db)))
        if len(cs) <= 27:
            return (float(db.any()), 0.0)
        idx = np.arange(0, len(cs) - 27, max(1, len(cs) >> 15))
        key_d = (cs[idx + 20] - cs[idx + 7]) > 0
        phase_c = np.zeros(len(idx), dtype=bool)
        for d in range(8):
            phase_c |= (cs[idx + d + 11] - cs[idx + d]) == 0
        w_unit = float((key_d & phase_c).mean())
        w16 = (cs[idx + 16] - cs[idx]) > 0
        w11 = (cs[idx + 11] - cs[idx]) > 0
        return (w_unit, float((w16 & ~w11).mean()))

    def _front_end(self) -> tuple:
        """(strict, strict_n) of the next scan, as the JAX engine decides
        (``merpcr_tpu/engine.py:346-368``). The strict tables bake in a
        mismatch budget, so the choice follows the runtime -N, read at
        every search: -N 0 scans strict over the N=0 tables; -N 1 builds
        the strict1 tables on its first search (dropping the device copy,
        so the table is uploaded again with them) and scans strict over
        them if they armed; anything else scans loose."""
        m = self._meta
        if self.mismatches == 0 and m.strict:
            return True, 0
        if self.mismatches == 1 and m.strict:
            if not self._strict1_tried:
                self._table_host, self._meta = build_strict1(
                    self._table_host, m, bool(self.iupac_mode))
                self._tables = {}
                self._strict1_tried = True
            return (True, 1) if self._meta.strict1 else (False, 0)
        return False, 0

    def _base_config(self, tile_len: int, stream: bool = False,
                     dirty_pos: float = 0.0, packed: bool = True) -> ScanConfig:
        """Tile geometry, front end and filters of the scan for the loaded
        table; ``dirty_pos`` is the quantized dirty-position rate that
        arms the dirty-span filter (K10, strict only). A raw-byte plane
        (``packed`` False) scans loose without asking ``_front_end``, which
        would build the strict1 tables at -N 1 (the JAX engine builds them
        for packed records only, ``merpcr_tpu/engine.py:351-353``)."""
        strict, strict_n = self._front_end() if packed else (False, 0)
        m = self._meta
        return default_config(
            wordsize=self.wordsize,
            margin=self.margin,
            lead=m.lead,
            max_pcr_size=self.max_pcr_size,
            p1_max=m.p1_max,
            p2_max=m.p2_max,
            tile_len=tile_len,
            stride=m.stride,
            exact_group=m.exact_group,
            qbloom_bits=m.qbloom_bits,
            strict=strict,
            strict_n=strict_n,
            t16_bits=m.t16_1_bits if strict_n == 1 else m.t16_bits,
            bloom_bits=m.bloom_bits,
            iupac=bool(self.iupac_mode),
            stream=stream,
            dirty_pos_rate=dirty_pos,
            packed=packed,
        )

    @staticmethod
    def _plane(data: np.ndarray, pos_len: int, lead: int, *, packed: bool) -> np.ndarray:
        """Host-side input plane of ``pos_len`` positions: ``data`` copied
        into a zero-padded buffer after ``lead`` positions. ``data`` is the
        nibble-packed record, two positions per byte (lead is even, so the
        record stays byte-aligned), or with ``packed`` False the raw bytes,
        one per position (zero bytes are ambiguous: no window reaching into
        the padding hashes)."""
        per_byte = 2 if packed else 1
        buf = np.zeros(pos_len // per_byte, dtype=np.uint8)
        buf[lead // per_byte : lead // per_byte + len(data)] = data
        return buf

    def _runtime_params(self) -> tuple:
        """Runtime (-M, -N, -X)."""
        return (self.margin, self.mismatches, self.three_prime_match)

    @staticmethod
    def _pick_tile_len(total_scan: int, max_tile: Optional[int] = None) -> int:
        buckets = [b for b in TILE_LEN_BUCKETS if max_tile is None or b <= max_tile]
        for b in buckets:
            if total_scan <= b:
                return b
        return buckets[-1]

    def _scan_plane(self, cfg: ScanConfig, plane_np: np.ndarray,
                    total_scan: int, stream_len: int, rmeta: np.ndarray,
                    recmap) -> np.ndarray:
        """Upload a plane and its record tables, run the kernels over its
        tiles, and download every tile's hits in one copy; with a mesh, cut
        the plane into shards first (``sharded_scan_stream``).

        Returns an int64 array of shape (n_hits, 7) with columns
        (pos1, pos2, entry, tile_idx, pair_order, rank, rec), pos1/pos2
        0-based in the coordinates of record ``rec`` (an rmeta row)."""
        n_tiles = -(-total_scan // cfg.tile_len)
        rt = self._runtime_params()
        if self.mesh is not None:
            outs = sharded_scan_stream(cfg, self._table, plane_np, rmeta, total_scan,
                                       stream_len, self.mesh, rt, recmap=recmap,
                                       tables=self._tables)
            return self._rows(cfg, n_tiles, len(rmeta), outs)
        dev = self.device
        outs = scan_stream(
            cfg, self._table, torch.from_numpy(plane_np).to(dev), total_scan,
            stream_len, torch.from_numpy(rmeta).to(dev),
            None if recmap is None else torch.from_numpy(recmap).to(dev),
            rt, n_tiles,
        )
        return self._rows(cfg, n_tiles, len(rmeta), outs)

    def _rows(self, cfg: ScanConfig, n_tiles: int, n_records: int, outs) -> np.ndarray:
        """Record the plane in ``last_scans`` and stack its tiles' hits as
        (n_hits, 7) int64 rows; the tile column is the index in ``outs``,
        the global tile index ``shard * tiles_per_shard + t`` under a mesh."""
        shards = 1 if self.mesh is None else len(self.mesh)
        self.last_scans.append(PlaneScan(cfg, n_tiles, n_records, shards))
        parts = []
        for t, o in enumerate(outs):
            if o.hit_total:
                tile = torch.full_like(o.rank, t)
                parts.append(torch.stack(
                    [o.pos1, o.pos2, o.entry, tile, o.pair_order, o.rank, o.rec],
                    dim=1))
        if not parts:
            return np.zeros((0, 7), dtype=np.int64)
        if len({p.device for p in parts}) > 1:  # shards on several devices
            parts = [p.cpu() for p in parts]
        return torch.cat(parts).cpu().numpy().astype(np.int64)

    def _scan_record(self, seq: np.ndarray, packed_rec) -> np.ndarray:
        """Run the kernels over one record (the record path: a plane of
        [lead zeros][record][zeros], nibble-packed, or raw bytes when
        ``packed_rec`` is None); in strict mode the dirty-span filter is
        armed from this record's own dirty rate
        (``merpcr_tpu/engine.py:497-504``). The loose and raw paths never
        arm it, so they skip the dirty-rate sample.

        Returns an int64 array of shape (n_hits, 6) with columns
        (pos1, pos2, entry, tile_idx, pair_order, rank), 0-based."""
        n = len(seq)
        if n <= self.wordsize:  # reference engine.py:458-459 (note <=)
            return np.zeros((0, 6), dtype=np.int64)
        packed = packed_rec is not None
        total_scan = n - self.wordsize + 1
        tile_len = self._tile_len_override or self._pick_tile_len(total_scan)
        dirty_pos = 0.0
        if packed and self._front_end()[0]:
            dirty_pos = self._quantize_dirty(self._dirty_of(seq, packed_rec)[1])
        cfg = self._base_config(tile_len, dirty_pos=dirty_pos, packed=packed)
        n_tiles = -(-total_scan // cfg.tile_len)
        if self.mesh is not None:
            outs = sharded_scan_record(cfg, self._table, seq, self.wordsize, self.mesh,
                                       self._runtime_params(), packed_rec=packed_rec,
                                       tables=self._tables)
            return self._rows(cfg, n_tiles, 1, outs)[:, :6]
        plane = self._plane(packed_rec if packed else seq,
                            cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead,
                            packed=packed)
        rmeta = np.asarray([[0, n]], dtype=np.int32)
        return self._scan_plane(cfg, plane, total_scan, n, rmeta, None)[:, :6]

    # ---------------------------------------------------------- stream path
    # Limits of one stream plane (the JAX package's): records per run and
    # laid-out positions per run.
    STREAM_MAX_RECORDS = 1 << 16
    STREAM_MAX_POSITIONS = 1 << 28

    @staticmethod
    def _stream_layout(items):
        """Records laid end to end (``merpcr_tpu/engine.py:887-902``): each
        starts at a multiple of 8 positions (u32-unit and nibble-byte
        aligned) with at least one gap position after its predecessor.
        ``items``: (seq_bytes, packed) pairs. Returns (rmeta int32[R, 2] of
        (start, length), stream_len)."""
        rmeta = np.empty((len(items), 2), dtype=np.int32)
        cur = 0
        for i, (seq, _p) in enumerate(items):
            start = -(-(cur + 1) // 8) * 8 if i else 0
            rmeta[i] = (start, len(seq))
            cur = start + len(seq)
        return rmeta, cur

    @staticmethod
    def _recmap(rmeta: np.ndarray, stream_len: int) -> np.ndarray:
        """Block -> record map (``merpcr_tpu/engine.py:942-948``): record
        starts are 8-aligned, so the 8-position block b belongs to one
        record (gap blocks to the record before them)."""
        n_blocks = -(-stream_len // 8)
        counts = np.diff(rmeta[:, 0].astype(np.int64) // 8, append=n_blocks)
        return np.repeat(np.arange(len(rmeta), dtype=np.int32), counts)

    def _plan(self, fasta_records) -> list:
        """Dispatch plan in FASTA order (``merpcr_tpu/engine.py:1448-1491``):
        ("stream", record indices, items) for every run of >= 2
        consecutive packable records, ("single", index) otherwise. An empty
        or unpackable record breaks a run; a run is cut at
        STREAM_MAX_RECORDS records or STREAM_MAX_POSITIONS positions."""
        plan, run, items = [], [], []
        run_pos = 0

        def flush():
            nonlocal run_pos
            if len(run) >= 2:
                plan.append(("stream", run.copy(), items.copy()))
            else:
                plan.extend(("single", j) for j in run)
            run.clear()
            items.clear()
            run_pos = 0

        for i, rec in enumerate(fasta_records):
            n = len(rec.sequence)
            packed = record_packed(rec) if n > 0 else None
            if packed is None:
                flush()
                plan.append(("single", i))
                continue
            if (run_pos + n + 8 > self.STREAM_MAX_POSITIONS
                    or len(run) >= self.STREAM_MAX_RECORDS):
                flush()
            run.append(i)
            items.append((record_seq_bytes(rec), packed))
            run_pos += n + 8
        flush()
        return plan

    def _stream_plane(self, items):
        """Lay a run of records out as one stream plane
        (``merpcr_tpu/engine.py:904-1001``). Returns (cfg, plane uint8,
        total_scan, stream_len, rmeta, recmap), or None when no position
        of the run can be scanned (every record shorter than a word)."""
        rmeta, stream_len = self._stream_layout(items)
        total_scan = stream_len - self.wordsize + 1
        if total_scan <= 0:
            return None
        # length-weighted mean of the records' dirty rates (:953-962), which
        # only the strict path reads (K10)
        w_pos = 0.0
        if self._front_end()[0]:
            for seq, packed in items:
                w_pos += self._dirty_of(seq, packed)[1] * len(seq)
            w_pos /= sum(len(seq) for seq, _p in items)
        tile_len = self._tile_len_override or self._pick_tile_len(
            total_scan, max_tile=STREAM_MAX_TILE)
        cfg = self._base_config(tile_len, stream=True,
                                dirty_pos=self._quantize_dirty(w_pos))
        L = cfg.tile_len
        n_tiles = -(-total_scan // L)
        # gaps, lead and tail are 0xFF (dirty nibbles), so no scan window
        # crosses a record boundary; record starts are byte-aligned
        plane = np.full((cfg.lead + n_tiles * L + cfg.tail) // 2, 0xFF, np.uint8)
        lead_b = cfg.lead // 2
        for (_seq, packed), start in zip(items, rmeta[:, 0]):
            b0 = lead_b + int(start) // 2
            plane[b0 : b0 + len(packed)] = packed
        return cfg, plane, total_scan, stream_len, rmeta, self._recmap(rmeta, stream_len)

    def _scan_stream(self, items) -> List[np.ndarray]:
        """Scan a run of records as one plane (``merpcr_tpu/engine.py``
        ``_dispatch_stream``/``_collect_stream``, without capacities,
        rescans or caches). Returns one (n_hits, 6) row array per item."""
        laid = self._stream_plane(items)
        if laid is None:
            return [np.zeros((0, 6), dtype=np.int64)] * len(items)
        rows = self._scan_plane(*laid)
        # split by record with one stable argsort (:1163-1168); the
        # emitter re-sorts each record's rows by their unique keys
        rows = rows[np.argsort(rows[:, 6], kind="stable")]
        bounds = np.searchsorted(rows[:, 6], np.arange(len(items) + 1))
        return [rows[bounds[i] : bounds[i + 1], :6] for i in range(len(items))]

    def _search_record(self, rec: FASTARecord, host: bool) -> np.ndarray:
        """(n_hits, 6) rows of one record: on the host (``ops.host_scan``)
        when ``host`` is set and the record stays within its caps, else on
        the record path's kernels (``merpcr_tpu/engine.py:1493-1509``). A
        host-path record touches no device table, no front-end choice and
        no dirty-rate sample, and adds nothing to ``last_scans``."""
        seq = record_seq_bytes(rec)
        if host:
            rows = host_scan_record(self._table_host, self._meta, seq, self.margin,
                                    self.mismatches, self.three_prime_match)
            if rows is not None:
                return rows
        packed = record_packed(rec) if len(rec.sequence) > self.wordsize else None
        return self._scan_record(seq, packed)

    def search(
        self, fasta_records: List[FASTARecord], output_file: Optional[str] = None
    ) -> int:
        """Search all records; emit 5-field tab-delimited hits
        (reference engine.py:365-451; line format engine.py:442).

        Small inputs take the host path (``merpcr_tpu/engine.py:1436-1449``):
        when all records together hold at most ``MERPCR_TPU_HOST_MAX`` bases
        (read at every search; default 2,000,000), without a mesh or
        several processes, and while the table is not on the engine's
        device, each record is scanned in NumPy on its own, and a record
        past the host path's caps falls back to the kernels.
        ``MERPCR_TPU_TRACE`` naming a directory wraps the search in
        ``torch.profiler`` and writes a Chrome trace there
        (``merpcr_tpu/engine.py:1411-1419``)."""
        total_hits = 0
        # Several processes: every rank runs every plan item (all must join
        # each gather, in the same order) but only rank 0 writes; the others
        # never create output_file (merpcr_tpu/engine.py:1394-1409)
        emit_here = not self._multihost or distributed.is_output_host()
        # None or the literal string "stdout" (any case) -> stdout
        # (reference engine.py:368-371)
        if not emit_here:
            output = open(os.devnull, "w")
        elif output_file and output_file.lower() != "stdout":
            output = open(output_file, "w")
        else:
            output = sys.stdout
        trace_dir = os.environ.get("MERPCR_TPU_TRACE")
        prof = None
        if trace_dir:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = profile(activities=activities)
            prof.__enter__()
        search_t0 = time.time()
        total_bp = 0
        have_table = self._meta is not None and self._meta.n_entries > 0
        self.last_scans = []
        empty = np.zeros((0, 6), dtype=np.int64)
        log_debug = logger.isEnabledFor(logging.DEBUG)
        try:
            host_max = int(os.environ.get("MERPCR_TPU_HOST_MAX", "2000000"))
            # an engine whose table is on its device already scans a small
            # input faster on the kernels than in NumPy
            use_host = (have_table and self.mesh is None and not self._multihost
                        and self.device not in self._tables
                        and sum(len(r.sequence) for r in fasta_records) <= host_max)
            if use_host:  # every record an item of its own, never a stream run
                plan = [("host", i) for i in range(len(fasta_records))]
            elif have_table:
                plan = self._plan(fasta_records)
            else:
                plan = [("single", i) for i in range(len(fasta_records))]
            for item in plan:
                t0 = time.time()
                if item[0] == "stream":
                    idxs, arrs = item[1], self._scan_stream(item[2])
                else:
                    arr = empty
                    if have_table:
                        arr = self._search_record(fasta_records[item[1]], item[0] == "host")
                    idxs, arrs = [item[1]], [arr]
                for j, arr in zip(idxs, arrs):
                    record = fasta_records[j]
                    seq_label = record.label
                    seq_len = len(record.sequence)
                    logger.info("Processing sequence: %s (%d bp)", seq_label, seq_len)
                    if len(arr):
                        # Reproduce T=1 ordering: stable sort by pos1 over
                        # hits emitted scan-order (tile, pair, rank) --
                        # engine.py:434. Host rows carry tile 0 and a
                        # record-wide pair order, which sort the same way.
                        key = np.lexsort((arr[:, 5], arr[:, 4], arr[:, 3], arr[:, 0]))
                        arr = arr[key]
                        e2r = self._meta.entry_to_record
                        for pos1, pos2, entry, _t, _o, _r in arr:
                            sts = self.sts_records[int(e2r[int(entry)])]
                            print(
                                f"{seq_label}\t{pos1 + 1}..{pos2 + 1}\t{sts.id}\t{sts.alias}\t({sts.direct})",
                                file=output,
                            )
                        total_hits += len(arr)
                    total_bp += seq_len
                    if log_debug:
                        logger.debug("searched %s (%d bp) in %.3fs",
                                     seq_label, seq_len, time.time() - t0)
        finally:
            if output is not sys.stdout:
                output.close()
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(
                    trace_dir, f"merpcr_{os.getpid()}_{next(_TRACE_SEQ)}.pt.trace.json"))

        elapsed = time.time() - search_t0
        if elapsed > 0 and total_bp:
            logger.info(
                "Throughput: %.2f Mbp/s (%d bp in %.3fs)",
                total_bp / 1e6 / elapsed, total_bp, elapsed,
            )
        logger.info(f"Total hits found: {total_hits}")
        self.total_hits = total_hits
        return total_hits
