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

Repeat searches reuse what does not depend on -N, -X or -I: a record's
(or stream run's) dirty rates, layout and planes on the device, kept in a
cache entry that holds the record's arrays (``_owned``). The entries are
shared by every engine of the process, as the JAX package's plane cache is
(``merpcr_tpu/engine.py:72-74``), so a sweep that builds a fresh engine per
setting samples and uploads each record once; an engine also keeps the
plan of its last search (``_plan``) for a repeat search over the same
records. A plane's tiles
are enqueued with no host read between their stages
(``ops.scan.dispatch_stream``): each stage reads the count of the one
before from device memory, and the host reads the plane once, when it
collects it, rerunning count first the rare tile that passed a buffer.
The plan's next item is dispatched before this one is collected
(``merpcr_tpu/engine.py:1519-1532``).

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

This module imports no torch, as the JAX engine imports no jax
(``merpcr_tpu/engine.py:30-37``): the device side (torch, ``ops.scan``,
``ops.table.table_from_numpy``, ``parallel``) is imported inside the
methods that use it, so a small run on the host path never loads PyTorch.
``resolve_device`` checks for a card through the CUDA driver API, in a
child process (``cuda_driver.py`` says why), and the engine's
``torch.device`` is made at its first use.
"""

from __future__ import annotations

import functools
import itertools
import logging
import math
import operator
import os
import subprocess
import sys
import time
from typing import TYPE_CHECKING, List, Optional

import numpy as np

from . import cuda_driver, native, trace
from .io.fasta import FASTALoader, record_packed, record_seq_bytes
from .io.sts import STSLoader
from .models import FASTARecord
from .ops.encoding import AMBIG, SCODE
from .ops.host_scan import host_scan_record
from .ops.table import build_strict1, compile_table

if TYPE_CHECKING:  # pragma: no cover - the device side is imported at first use
    import torch

    from .ops.scan import ScanConfig

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
# hit lines formatted and written at a time: a whole genome's lines never
# sit in one buffer
EMIT_ROWS = 1 << 16

logger = logging.getLogger(__name__)
# per-process number of a search's trace file (MERPCR_TPU_TRACE)
_TRACE_SEQ = itertools.count()


# MERPCR_TPU_PLATFORM values (the JAX package's override,
# merpcr_tpu/__init__.py:14-22) and the device each one means
PLATFORMS = {"cpu": "cpu", "cuda": "cuda", "gpu": "cuda"}
NO_CARD = "no CUDA device is available"


def _no_card(why: str) -> RuntimeError:
    return RuntimeError(f"{NO_CARD} ({why}); pass device='cpu' to run the plain "
                        "PyTorch versions of the kernels")


def _driver_report() -> str:
    """``cuda_driver.py``'s line (the count, or ``error: <why>``), from the
    script run in a child process, which leaves the CUDA driver of this
    process to torch (the module says why)."""
    r = subprocess.run([sys.executable, "-S", cuda_driver.__file__], capture_output=True,
                       text=True, timeout=120)
    if r.returncode != 0:
        return f"error: the driver check exited with {r.returncode}: {r.stderr[-500:]}"
    return r.stdout.strip()


def cuda_device_count() -> int:
    """The CUDA cards this process may use, through the CUDA driver API
    (``cuda_driver.py``: ``cuInit``, ``cuDeviceGetCount``), without
    importing torch; the driver honours ``CUDA_VISIBLE_DEVICES`` as
    ``torch.cuda`` does. Raises RuntimeError when there is no driver
    library, a driver call fails or the driver sees no card."""
    line = _driver_report()
    if line.startswith("error: "):
        raise _no_card(line[len("error: "):])
    n = int(line)
    if n < 1:
        raise _no_card("the CUDA driver sees no device")
    return n


class _Checked(str):
    """A device spec that ``resolve_device`` has checked: resolving it
    again asks the driver nothing (``cli.main`` resolves before the engine
    does)."""


def _kind_and_index(device) -> tuple:
    """(type, index or None) of a device spec: a string such as "cpu",
    "cuda" or "cuda:1", a card index, or a ``torch.device``."""
    if isinstance(device, int):
        return "cuda", device
    if isinstance(device, str):
        kind, sep, index = device.partition(":")
        if not sep:
            return kind, None
        if not index.isdigit():
            raise ValueError(f"unsupported device {device!r}")
        return kind, int(index)
    return device.type, device.index


def resolve_device(device=None):
    """The engine's device, checked: ``None`` means ``MERPCR_TPU_PLATFORM``
    when it is set ("cpu"; "cuda" or "gpu" for the card; any other value
    raises ValueError, where the JAX package ignores it), else the CUDA
    card. Asking for CUDA without a card, or for a card index the driver
    does not see, raises RuntimeError: the engine never carries on
    silently on the CPU. The card is looked for through the CUDA driver
    (``cuda_device_count``), so this imports no torch. Returns a string
    spec ("cpu", "cuda", "cuda:1"; checked, so resolving it again is free),
    or the caller's ``torch.device`` as it is."""
    if isinstance(device, _Checked):
        return device
    if device is None:
        platform = os.environ.get("MERPCR_TPU_PLATFORM")
        if platform:
            if platform not in PLATFORMS:
                raise ValueError(f"MERPCR_TPU_PLATFORM={platform!r}: accepted values are "
                                 + ", ".join(repr(k) for k in PLATFORMS))
            device = PLATFORMS[platform]
        else:
            device = "cuda"
    kind, index = _kind_and_index(device)
    if kind == "cuda":
        n = cuda_device_count()
        if index is not None and not 0 <= index < n:
            raise _no_card(f"cuda:{index} asked for, the CUDA driver sees {n}")
    elif kind != "cpu":
        raise ValueError(f"unsupported device {device}")
    if isinstance(device, int):
        return _Checked(f"cuda:{device}")
    return _Checked(device) if isinstance(device, str) else device


def _dirty_bytes(b: np.ndarray) -> np.ndarray:
    """Bytes of a nibble packing that hold a code outside ACGT."""
    return ((b & 0xF) >= 4) | ((b >> 4) >= 4)


def _window_flags(dirty: np.ndarray) -> np.ndarray:
    """``w_pos``'s flag at each byte offset p of a packing's dirty bytes:
    dirty in bytes p..p+7 (16 bases), clean in p..p+5 (~11)."""
    n = max(len(dirty) - 7, 0)
    clean6 = ~dirty[:n]
    for o in range(1, 6):
        clean6 &= ~dirty[o : o + n]
    return clean6 & (dirty[6 : 6 + n] | dirty[7 : 7 + n])


# Owners (records, stream runs) whose dirty rates, layouts and uploaded
# planes every engine of the process reuses: past this many the store is
# cleared (the JAX package's bound, ``merpcr_tpu/engine.py:575``)
OWNERS_MAX = 64
# (arrays, entry) of each owner (``_owned``); one store per process, as the
# JAX package's ``_DEVICE_PLANE_CACHE``
_OWNERS: list = []


def _owned(arrays: tuple) -> dict:
    """The cache entry of a record (``arrays``: its packed bytes, or its
    raw bytes) or a stream run (every item's packed bytes), which repeat
    searches and every other engine of the process reuse
    (``merpcr_tpu/engine.py:492-499``, ``:556-579``): the dirty rates
    ("dirty"), a run's layout ("layout") and the uploaded planes, keyed by
    device and all that their bytes and length depend on. None of it depends
    on an engine's -W, -N, -X, -I, STS set or table, except through a plane's
    key. The entry holds ``arrays`` and is found by the identity of every one
    of them, so an entry is never served to another record, even one of the
    same length, and no key is an object's id number, which a new object
    could reuse. Cleared past ``OWNERS_MAX`` owners."""
    for owners, entry in _OWNERS:
        if len(owners) == len(arrays) and all(map(operator.is_, owners, arrays)):
            return entry
    if len(_OWNERS) >= OWNERS_MAX:
        _OWNERS.clear()
    entry: dict = {}
    _OWNERS.append((arrays, entry))
    return entry


class PlaneScan(tuple):
    """(cfg, tiles, records) of one scanned plane, with ``shards``: the
    mesh's shard count (1 without a mesh), and ``reruns``: the (global)
    tiles that passed a buffer of the deferred tile scan and were rerun
    count first (``ops.scan.collect_stream``). ``tiles`` counts the plane's
    real tiles; a mesh of n shards scans n * ceil(tiles / n) global tiles,
    the rest padding."""

    def __new__(cls, cfg, tiles: int, records: int, shards: int = 1, reruns=()):
        self = super().__new__(cls, (cfg, tiles, records))
        self.shards = shards
        self.reruns = tuple(reruns)
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
        # the checked spec; the torch.device is made at first use (``device``)
        self._device = resolve_device(device)

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
        # (meta, sts_records, native.Texts): the end of each device entry's
        # hit line, built from those two objects (``_line_tails``)
        self._tails: Optional[tuple] = None
        self._strict1_tried = False  # build_strict1 ran for this table
        # Test hook: force a specific tile length (exercises multi-tile
        # paths on small inputs). None -> TILE_LEN_BUCKETS heuristic.
        self._tile_len_override: Optional[int] = None
        # (records, their sequences, plan) of the last plan built (``_plan``)
        self._plan_cache: Optional[tuple] = None
        # set: each search fills a ``trace.SearchTrace`` (spans and
        # counters), left in ``last_trace``; unset, ``last_trace`` is None
        self.tracing = False
        self.last_trace: Optional[trace.SearchTrace] = None

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

    @property
    def device(self) -> "torch.device":
        """The engine's ``torch.device``, made (and torch imported) at its
        first use from the spec that ``resolve_device`` checked; a card
        without an index is the current one."""
        dev = self._device
        if isinstance(dev, str) or (dev.type == "cuda" and dev.index is None):
            import torch

            dev = torch.device(dev)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            self._device = dev
        return dev

    @device.setter
    def device(self, dev) -> None:
        self._device = dev

    def use_mesh(self, mesh) -> "MerPCR":
        """Shard the scan across a 1-D mesh (``parallel.make_mesh``: a
        tuple of devices, one per shard; None: one device again). Tiles
        are partitioned by scan position and the table replicated; the
        output is byte-identical to the single-device path
        (``merpcr_tpu/engine.py:185-190``)."""
        if mesh is not None:
            from .parallel.sharded import make_mesh

            mesh = make_mesh(mesh)
        self.mesh = mesh
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
        from .parallel import distributed

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
            from .ops.table import table_from_numpy

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

        The JAX package (``merpcr_tpu/engine.py:284-336``) takes a prefix
        sum of the dirty bytes over the whole record and differences it at
        about 16k sampled offsets; each difference sums at most 10 bytes
        (packed) or 20 bases (raw) from its offset, so only those windows
        are read here, and the rates are the same numbers.
        """
        if packed_rec is not None and len(packed_rec):
            b = packed_rec
            n_cs = len(b) + 1  # the JAX prefix sum's length
            if n_cs <= 13:
                return (float(_dirty_bytes(b).any()), 0.0)
            # byte granularity: 1 byte = 2 bases. Unit key bases 7..19
            # ~ bytes 3..9; phase W-mer windows ~ 6-byte windows at byte
            # offsets 0..4; position windows: 8 B = 16 bases, 6 B ~ 11.
            idx = np.arange(0, n_cs - 13, max(1, n_cs >> 14))
            d = _dirty_bytes(b[idx[:, None] + np.arange(10)])
            key_d = d[:, 3:10].any(axis=1)
            phase_c = np.zeros(len(idx), dtype=bool)
            for o in range(5):
                phase_c |= ~d[:, o : o + 6].any(axis=1)
            w_unit = float((key_d & phase_c).mean())
            w16, w11 = d[:, :8].any(axis=1), d[:, :6].any(axis=1)
            return (w_unit, float((w16 & ~w11).mean()))
        if seq is None or not len(seq):
            return (0.0, 0.0)
        n_cs = len(seq) + 1
        if n_cs <= 27:
            return (float((SCODE[seq] == AMBIG).any()), 0.0)
        idx = np.arange(0, n_cs - 27, max(1, n_cs >> 15))
        d = SCODE[seq[idx[:, None] + np.arange(20)]] == AMBIG
        key_d = d[:, 7:20].any(axis=1)
        phase_c = np.zeros(len(idx), dtype=bool)
        for o in range(8):
            phase_c |= ~d[:, o : o + 11].any(axis=1)
        w_unit = float((key_d & phase_c).mean())
        w16, w11 = d[:, :16].any(axis=1), d[:, :11].any(axis=1)
        return (w_unit, float((w16 & ~w11).mean()))

    @staticmethod
    def _run_dirty_pos(items) -> float:
        """The length-weighted mean of a stream run's records' ``w_pos``
        rates (``_dirty_of``), which arms K10 for the run
        (``merpcr_tpu/engine.py:949-962``), in one vectorised pass over the
        run instead of one call per record: every offset's window flag over
        the records' packed bytes end to end, then each record's sampled
        offsets counted (all of them below 2^14 bytes, where the stride is
        1). The counts are ``_dirty_of``'s integers, and the rates are
        summed in record order as its loop sums them, so the float is
        equal."""
        packed = [p for _, p in items]
        lens = np.fromiter((len(p) for p in packed), dtype=np.int64, count=len(packed))
        flags = _window_flags(_dirty_bytes(np.concatenate(packed)))
        off = np.cumsum(lens) - lens
        n_cs = lens + 1
        stride = np.maximum(1, n_cs >> 14)
        k = np.where(n_cs > 13, -(-(n_cs - 13) // stride), 0)  # sampled offsets
        hits = np.zeros(len(packed), dtype=np.int64)
        dense = (k > 0) & (stride == 1)
        if dense.any():  # contiguous offsets: one segment sum per record
            bounds = np.stack([off[dense], off[dense] + k[dense]], axis=1).ravel()
            hits[dense] = np.add.reduceat(flags, bounds, dtype=np.int64)[::2]
        for i in np.flatnonzero((k > 0) & (stride > 1)).tolist():
            hits[i] = int(flags[off[i] : off[i] + k[i] * stride[i] : stride[i]].sum())
        w_pos = 0.0
        for h, n_k, (seq, _p) in zip(hits.tolist(), k.tolist(), items):
            w_pos += (h / n_k if n_k else 0.0) * len(seq)
        return w_pos / sum(len(seq) for seq, _p in items)

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
                with trace.span("table.strict1"):
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
        from .ops.scan import default_config

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

    def _dispatch_plane(self, cfg: ScanConfig, owned: dict, make_plane,
                        total_scan: int, stream_len: int, rmeta: np.ndarray,
                        recmap, n_records: int) -> tuple:
        """Enqueue the scan of one plane without a host read
        (``ops.scan.dispatch_stream``, or with a mesh
        ``parallel.sharded.dispatch_shards``). The plane, and its ``rmeta``
        and ``recmap``, are uploaded once per device (or mesh) and geometry
        and kept in ``owned``, so a repeat search with a new -N, -X or -I,
        or another engine's search, uploads nothing (a new -M or STS set
        changes ``lead``/``tail`` and so the plane, a new -W the number of
        tiles); ``make_plane()`` builds its host bytes on a miss. Returns
        the context that ``_collect`` reads."""
        from .ops.scan import dispatch_stream
        from .parallel.sharded import dispatch_shards, upload, upload_shards

        n_tiles = -(-total_scan // cfg.tile_len)
        rt = self._runtime_params()
        # all that the plane's bytes and length depend on: its halos, its
        # tiles (their number follows -W: total_scan = n - W + 1; under a
        # mesh it sets the tiles per shard) and the record or run
        geometry = (cfg.lead, cfg.tail, cfg.tile_len, n_tiles, cfg.packed, stream_len)
        if self.mesh is not None:
            key = (self.mesh, *geometry)
            up = owned.get(key)
            if up is None:
                with trace.span("dispatch.upload"):
                    up = owned[key] = upload_shards(make_plane(), rmeta, recmap, self.mesh)
            pend = dispatch_shards(cfg, self._table, up, total_scan, stream_len, rt,
                                   self._tables)
            return ("mesh", cfg, n_tiles, n_records, pend)
        dev = self.device
        key = (dev, *geometry)
        up = owned.get(key)
        if up is None:
            with trace.span("dispatch.upload"):
                up = owned[key] = (upload(make_plane(), dev), upload(rmeta, dev),
                                   None if recmap is None else upload(recmap, dev))
        pend = dispatch_stream(cfg, self._table, up[0], total_scan, stream_len, up[1],
                               up[2], rt, n_tiles)
        return ("plane", cfg, n_tiles, n_records, pend)

    def _collect(self, ctx, n_items: int) -> List[np.ndarray]:
        """The (n_hits, 6) int64 rows (pos1, pos2, entry, tile_idx,
        pair_order, rank), 0-based in each record's coordinates, of each of
        the ``n_items`` records of a dispatched plan item
        (``merpcr_tpu/engine.py`` ``_collect_record``/``_collect_stream``):
        the plane's one host read and the reruns of the tiles that passed a
        buffer, the plane recorded in ``last_scans``. ``ctx``: None (nothing
        to scan), ("rows", rows) from the host path, or a plane
        (``_dispatch_plane``)."""
        if ctx is None:
            return [np.zeros((0, 6), dtype=np.int64)] * n_items
        if ctx[0] == "rows":
            return [ctx[1]]
        kind, cfg, n_tiles, n_records, pend = ctx
        if kind == "mesh":
            from .parallel.sharded import collect_shards

            outs, reruns = collect_shards(pend, len(self.mesh))
        else:
            from .ops.scan import collect_stream

            outs, reruns = collect_stream(pend)
        with trace.span("collect.rows"):
            rows = self._rows(cfg, n_tiles, n_records, outs, reruns)
            if n_items == 1:
                return [rows[:, :6]]
            # split by record with one stable argsort (:1163-1168); the
            # emitter re-sorts each record's rows by their unique keys
            rows = rows[np.argsort(rows[:, 6], kind="stable")]
            bounds = np.searchsorted(rows[:, 6], np.arange(n_items + 1))
            return [rows[bounds[i] : bounds[i + 1], :6] for i in range(n_items)]

    def _rows(self, cfg: ScanConfig, n_tiles: int, n_records: int, outs,
              reruns) -> np.ndarray:
        """Record the plane in ``last_scans`` and stack its tiles' hits as
        (n_hits, 7) int64 rows (pos1, pos2, entry, tile_idx, pair_order,
        rank, rec); the tile column is the index in ``outs``, the global
        tile index ``shard * tiles_per_shard + t`` under a mesh."""
        import torch

        shards = 1 if self.mesh is None else len(self.mesh)
        self.last_scans.append(PlaneScan(cfg, n_tiles, n_records, shards, reruns))
        parts = []
        for t, o in enumerate(outs):
            if o.hit_total:
                part = torch.stack([o.pos1, o.pos2, o.entry, torch.full_like(o.rank, t),
                                    o.pair_order, o.rank, o.rec], dim=1)
                parts.append(part.cpu())  # a rerun tile's rows are on its device
        if not parts:
            return np.zeros((0, 7), dtype=np.int64)
        return torch.cat(parts).numpy().astype(np.int64)

    def _dispatch_record(self, seq: np.ndarray, packed_rec):
        """Enqueue one record's scan (``merpcr_tpu/engine.py:471-594``): the
        record path, a plane of [lead zeros][record][zeros], nibble-packed,
        or raw bytes when ``packed_rec`` is None. In strict mode the
        dirty-span filter is armed from this record's own dirty rate
        (``:492-504``), computed on the first strict search and kept with
        the plane in the record's cache entry (``_owned``); the loose and
        raw paths never arm it, so they skip the sample. Returns the
        context of ``_collect``, None for a record no word fits in."""
        n = len(seq)
        if n <= self.wordsize:  # reference engine.py:458-459 (note <=)
            return None
        packed = packed_rec is not None
        total_scan = n - self.wordsize + 1
        tile_len = self._tile_len_override or self._pick_tile_len(total_scan)
        owned = _owned((packed_rec if packed else seq,))
        dirty_pos = 0.0
        if packed and self._front_end()[0]:
            if "dirty" not in owned:
                owned["dirty"] = self._dirty_of(seq, packed_rec)
            dirty_pos = self._quantize_dirty(owned["dirty"][1])
        cfg = self._base_config(tile_len, dirty_pos=dirty_pos, packed=packed)
        data = packed_rec if packed else seq

        def make_plane():
            if self.mesh is not None:  # (padded_shards, tile_start0, tiles_per_shard)
                from .parallel.sharded import shard_planes

                padded, starts, _, tps = shard_planes(cfg, seq, self.wordsize,
                                                      len(self.mesh), packed_rec)
                return padded, starts, tps
            n_tiles = -(-total_scan // cfg.tile_len)
            return self._plane(data, cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead,
                               packed=packed)

        return self._dispatch_plane(cfg, owned, make_plane, total_scan, n,
                                    np.asarray([[0, n]], dtype=np.int32), None, 1)

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
        """The dispatch plan of ``fasta_records`` (``_build_plan``), kept
        for repeat searches (``merpcr_tpu/engine.py:1452-1489``): reused
        while the records are the same objects in the same order and each
        ``sequence`` is the string object the plan was built from, all
        checked with ``is`` (the JAX package keys its plan by the records'
        id numbers, which a new object can reuse). A reassigned
        ``sequence``, another record in the list or another length builds
        it anew."""
        pc = self._plan_cache
        seqs = tuple(map(operator.attrgetter("sequence"), fasta_records))
        if (pc is not None and len(pc[0]) == len(fasta_records)
                and all(map(operator.is_, pc[0], fasta_records))
                and all(map(operator.is_, pc[1], seqs))):
            return pc[2]
        plan = self._build_plan(fasta_records)
        self._plan_cache = (tuple(fasta_records), seqs, plan)
        return plan

    def _build_plan(self, fasta_records) -> list:
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

    def _stream_geometry(self, items):
        """(cfg, total_scan, stream_len, rmeta, recmap, cache entry) of a
        run of records laid out as one stream plane
        (``merpcr_tpu/engine.py:904-985``), or None when no position of the
        run can be scanned (every record shorter than a word). The layout
        and the run's dirty rate come from the run's cache entry
        (``_owned``) after the first search."""
        owned = _owned(tuple(p for _s, p in items))
        if "layout" not in owned:
            rmeta, stream_len = self._stream_layout(items)
            owned["layout"] = (rmeta, stream_len, self._recmap(rmeta, stream_len))
        rmeta, stream_len, recmap = owned["layout"]
        total_scan = stream_len - self.wordsize + 1
        if total_scan <= 0:
            return None
        # length-weighted mean of the records' dirty rates (:953-962), which
        # only the strict path reads (K10)
        w_pos = 0.0
        if self._front_end()[0]:
            if "dirty" not in owned:
                owned["dirty"] = self._run_dirty_pos(items)
            w_pos = owned["dirty"]
        tile_len = self._tile_len_override or self._pick_tile_len(
            total_scan, max_tile=STREAM_MAX_TILE)
        cfg = self._base_config(tile_len, stream=True,
                                dirty_pos=self._quantize_dirty(w_pos))
        return cfg, total_scan, stream_len, rmeta, recmap, owned

    @staticmethod
    def _stream_bytes(cfg: ScanConfig, items, rmeta: np.ndarray,
                      total_scan: int) -> np.ndarray:
        """The host bytes of a stream plane: gaps, lead and tail are 0xFF
        (dirty nibbles), so no scan window crosses a record boundary;
        record starts are byte-aligned."""
        L = cfg.tile_len
        n_tiles = -(-total_scan // L)
        plane = np.full((cfg.lead + n_tiles * L + cfg.tail) // 2, 0xFF, np.uint8)
        lead_b = cfg.lead // 2
        for (_seq, packed), start in zip(items, rmeta[:, 0]):
            b0 = lead_b + int(start) // 2
            plane[b0 : b0 + len(packed)] = packed
        return plane

    def _stream_plane(self, items):
        """Lay a run of records out as one stream plane
        (``merpcr_tpu/engine.py:904-1001``). Returns (cfg, plane uint8,
        total_scan, stream_len, rmeta, recmap), or None when no position
        of the run can be scanned (every record shorter than a word)."""
        laid = self._stream_geometry(items)
        if laid is None:
            return None
        cfg, total_scan, stream_len, rmeta, recmap, _ = laid
        return (cfg, self._stream_bytes(cfg, items, rmeta, total_scan), total_scan,
                stream_len, rmeta, recmap)

    def _dispatch_stream(self, items):
        """Enqueue a run of records as one plane (``merpcr_tpu/engine.py``
        ``_dispatch_stream``, without capacities or rescans); the context
        of ``_collect``, None when nothing of the run can be scanned."""
        laid = self._stream_geometry(items)
        if laid is None:
            return None
        cfg, total_scan, stream_len, rmeta, recmap, owned = laid

        def make_plane():
            plane = self._stream_bytes(cfg, items, rmeta, total_scan)
            if self.mesh is None:
                return plane
            from .parallel.sharded import shard_stream_planes

            return shard_stream_planes(cfg, plane, total_scan, len(self.mesh))

        return self._dispatch_plane(cfg, owned, make_plane, total_scan, stream_len,
                                    rmeta, recmap, len(items))

    def _dispatch_item(self, fasta_records, item):
        """Dispatch one plan item (``merpcr_tpu/engine.py:1493-1515``): a
        host-path record is scanned here, in NumPy (``ops.host_scan``),
        unless it passes that path's caps, which sends it to the record
        path's kernels; a host-path record touches no device table, no
        front-end choice and no dirty-rate sample, and adds nothing to
        ``last_scans``. Other items enqueue their plane. Returns the context
        of ``_collect``."""
        if item[0] == "stream":
            return self._dispatch_stream(item[2])
        rec = fasta_records[item[1]]
        seq = record_seq_bytes(rec)
        if item[0] == "host":
            with trace.span("dispatch.host_scan"):
                rows = host_scan_record(self._table_host, self._meta, seq, self.margin,
                                        self.mismatches, self.three_prime_match)
            if rows is not None:
                return ("rows", rows)
        packed = record_packed(rec) if len(rec.sequence) > self.wordsize else None
        return self._dispatch_record(seq, packed)

    def _line_tails(self) -> native.Texts:
        r"""``"\t{id}\t{alias}\t({direct})\n"`` of each device entry's STS
        record, the end of its hit line (reference engine.py:442), kept
        with the table's meta and ``sts_records`` it was built from and
        built anew once either is another object (checked with ``is``)."""
        meta, recs = self._meta, self.sts_records
        t = self._tails
        if t is None or t[0] is not meta or t[1] is not recs:
            sts = map(recs.__getitem__, meta.entry_to_record.tolist())
            t = self._tails = (meta, recs, native.Texts(
                [f"\t{s.id}\t{s.alias}\t({s.direct})\n" for s in sts]))
        return t[2]

    def _write_hits(self, output, labelled: list) -> None:
        """Write one plan item's hit lines (reference engine.py:442):
        ``labelled`` holds (label, rows) of each of its records with rows,
        in FASTA order, the rows sorted. One ``native.format_hits`` call and
        one write per ``EMIT_ROWS`` rows of the item; the active trace
        record counts the lines the native codec wrote (``lines_native``)."""
        rows = (labelled[0][1] if len(labelled) == 1
                else np.concatenate([a for _l, a in labelled]))
        pos1, pos2 = rows[:, 0] + 1, rows[:, 1] + 1
        entry = np.ascontiguousarray(rows[:, 2])
        rec = np.repeat(np.arange(len(labelled), dtype=np.int64),
                        [len(a) for _l, a in labelled])
        labels = native.Texts([f"{label}\t" for label, _a in labelled])
        tails = self._line_tails()
        for a in range(0, len(rows), EMIT_ROWS):
            b = a + EMIT_ROWS
            output.write(native.format_hits(pos1[a:b], pos2[a:b], entry[a:b], rec[a:b],
                                            labels, tails))
        rec_trace = trace.active()
        if rec_trace is not None and native.get_lib() is not None:
            rec_trace.add("lines_native", len(rows))

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
        past the host path's caps falls back to the kernels. Plan items are
        dispatched one ahead of their collection, so the next item's host
        work overlaps this one's kernels; output stays in FASTA order.
        ``MERPCR_TPU_TRACE`` naming a directory wraps the search in
        ``torch.profiler`` and writes a Chrome trace there
        (``merpcr_tpu/engine.py:1411-1419``). With ``tracing`` set, or
        ``MERPCR_TPU_TRACE``, the search fills a ``trace.SearchTrace`` and
        leaves it in ``last_trace`` (its spans are in the Chrome trace
        too)."""
        total_hits = 0
        # Several processes: every rank runs every plan item (all must join
        # each gather, in the same order) but only rank 0 writes; the others
        # never create output_file (merpcr_tpu/engine.py:1394-1409)
        emit_here = True
        if self._multihost:
            from .parallel import distributed

            emit_here = distributed.is_output_host()
        # None or the literal string "stdout" (any case) -> stdout
        # (reference engine.py:368-371)
        if not emit_here:
            output = None  # nothing formatted
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
        search_t0 = time.perf_counter()
        total_bp = 0
        have_table = self._meta is not None and self._meta.n_entries > 0
        self.last_scans = []
        self.last_trace = None
        log_debug = logger.isEnabledFor(logging.DEBUG)
        search_trace = trace.start() if self.tracing or trace_dir else None
        try:
            with trace.span("plan"):
                host_max = int(os.environ.get("MERPCR_TPU_HOST_MAX", "2000000"))
                # an engine whose table is on its device already scans a small
                # input faster on the kernels than in NumPy; with no table on
                # any device, torch need not be loaded to tell
                use_host = (have_table and self.mesh is None and not self._multihost
                            and not (self._tables and self.device in self._tables)
                            and sum(len(r.sequence) for r in fasta_records) <= host_max)
                if use_host:  # every record an item of its own, never a stream run
                    plan = [("host", i) for i in range(len(fasta_records))]
                elif have_table:
                    plan = self._plan(fasta_records)
                else:
                    plan = [("single", i) for i in range(len(fasta_records))]
            # depth-1 prefetch (merpcr_tpu/engine.py:1519-1532): the next
            # item's host preparation and dispatch overlap this item's
            # device work; collect reads each plane once, in plan order
            dispatch = (functools.partial(self._dispatch_item, fasta_records)
                        if have_table else lambda item: None)
            if plan:
                with trace.span("dispatch", 0):
                    ctx_next = dispatch(plan[0])
            for pi, item in enumerate(plan):
                t0 = time.perf_counter() if log_debug else 0.0
                ctx, ctx_next = ctx_next, None
                if pi + 1 < len(plan):
                    with trace.span("dispatch", pi + 1):
                        ctx_next = dispatch(plan[pi + 1])
                idxs = item[1] if item[0] == "stream" else [item[1]]
                with trace.span("collect", pi):
                    arrs = self._collect(ctx, len(idxs))
                with trace.span("emit", pi):
                    # Reproduce T=1 ordering: stable sort by pos1 over hits
                    # emitted scan-order (tile, pair, rank) -- engine.py:434.
                    # Host rows carry tile 0 and a record-wide pair order,
                    # which sort the same way.
                    with trace.span("emit.sort"):
                        arrs = [arr[np.lexsort((arr[:, 5], arr[:, 4], arr[:, 3], arr[:, 0]))]
                                if len(arr) else arr for arr in arrs]
                    with trace.span("emit.write"):
                        labelled = []  # (label, rows) of the item's records with rows
                        for j, arr in zip(idxs, arrs):
                            record = fasta_records[j]
                            seq_label = record.label
                            seq_len = len(record.sequence)
                            logger.info("Processing sequence: %s (%d bp)", seq_label,
                                        seq_len)
                            if len(arr):
                                labelled.append((seq_label, arr))
                                total_hits += len(arr)
                            total_bp += seq_len
                            if log_debug:
                                logger.debug("searched %s (%d bp) in %.3fs",
                                             seq_label, seq_len, time.perf_counter() - t0)
                        if labelled and output is not None:
                            self._write_hits(output, labelled)
        finally:
            try:  # the search span closes inside the profiler's run
                if search_trace is not None:
                    self.last_trace = trace.stop(search_trace, total_hits, self.last_scans)
            finally:
                if output is not None and output is not sys.stdout:
                    output.close()
                if prof is not None:
                    prof.__exit__(None, None, None)
                    os.makedirs(trace_dir, exist_ok=True)
                    prof.export_chrome_trace(os.path.join(
                        trace_dir, f"merpcr_{os.getpid()}_{next(_TRACE_SEQ)}.pt.trace.json"))

        elapsed = time.perf_counter() - search_t0
        if elapsed > 0 and total_bp:
            logger.info(
                "Throughput: %.2f Mbp/s (%d bp in %.3fs)",
                total_bp / 1e6 / elapsed, total_bp, elapsed,
            )
        logger.info(f"Total hits found: {total_hits}")
        self.total_hits = total_hits
        return total_hits
