"""One plane's scan positions sharded over several devices (K15a, K15b).

Counterpart of ``merpcr_tpu/parallel/sharded.py``. The scan positions of
a plane (one record, or a stream of records laid end to end) are cut into
contiguous spans of whole tiles, one span per shard of a 1-D mesh. Each
shard gets its own halo-padded slice of the plane (the halos are read-only
overlaps, so no shard needs another's bytes), the compiled table is
replicated once to each distinct device, and every shard's tiles run the
deferred tile scan (``ops.scan.dispatch_stream``, no host read) on the
shard's device, so the shards on different cards run at once; the host
reads each shard once when it collects, and the gather of a group of
several processes runs there too.
Positions are partitioned, not overlapped, so no hit is found twice; the
result is one ``ScanOut`` per global tile, global index ``shard *
tiles_per_shard + t``, which grows with scan position, so the emitter's
(pos1, tile, pair, rank) sort prints the single-device bytes.

The port's mesh is a tuple of ``torch.device``, one per shard. A device
may repeat: ``("cuda:0",) * 2`` is two shards on one card, ``("cpu",) * n``
runs the plain versions of the kernels. In one process every shard runs
here (dispatched shard by shard, then collected) and the outputs come to
the host. In a ``torch.distributed`` group of several processes (``distributed.py``)
each rank runs its own block of shards and the rows are gathered, so that
every rank holds every global tile, as JAX's ``lax.all_gather`` does.

The JAX programs scan ``group`` tiles per dispatch; the port enqueues tile
by tile, so it takes ``group = 1``. The parameter is kept so that the tiles
per shard can be rounded as the JAX package rounds them.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops.encoding import NIB_LUT, pack_nibbles
from ..ops.scan import ScanConfig, ScanOut, collect_stream, dispatch_stream
from ..ops.table import Table
from . import distributed


def _mesh_device(d) -> torch.device:
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"mesh device {dev}: no CUDA device is available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported mesh device {dev}")
    return dev


def make_mesh(devices: Optional[Sequence] = None) -> tuple:
    """The port's 1-D mesh: an ordered tuple of ``torch.device``, one per
    shard. ``None`` means every visible CUDA device, and raises when there
    is none (a mesh never falls back to the CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the mesh's "
                               "devices, e.g. ('cpu',) * n")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = tuple(_mesh_device(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def _tiles_per_shard(n_tiles: int, n_shards: int, group: int) -> int:
    # rounded up to a multiple of the group (``sharded.py:108-110``)
    return -(-(-(-n_tiles // n_shards)) // group) * group


def shard_planes(cfg: ScanConfig, seq: np.ndarray, wordsize: int,
                 n_shards: int, packed_rec: Optional[np.ndarray] = None,
                 group: int = 1):
    """Cut one record into per-shard halo-padded byte planes (the JAX
    package's ``shard_planes``, ``sharded.py:86-130``): ONE plane of
    ``lead + n_shards * span + tail`` positions, the record at ``lead``
    (its nibble packing ``packed_rec`` when given, else ``seq`` packed, or
    with ``cfg.packed`` False the raw bytes), zeros elsewhere; shard s owns
    scan positions [s*span, (s+1)*span) and its buffer is the plane's
    ``lead + span + tail`` positions from s*span, zero-padded past the
    plane's end. Returns (padded_shards uint8[n_shards, buf], tile_start0
    int32[n_shards], total_scan, tiles_per_shard)."""
    n = len(seq)
    total_scan = n - wordsize + 1
    L = cfg.tile_len
    tiles_per_shard = _tiles_per_shard(-(-total_scan // L), n_shards, group)
    span = tiles_per_shard * L  # scan positions per shard

    d = 2 if cfg.packed else 1
    plane_len = (cfg.lead + n_shards * span + cfg.tail) // d
    if cfg.packed and packed_rec is not None:
        plane = np.zeros(plane_len, dtype=np.uint8)
        plane[cfg.lead // 2 : cfg.lead // 2 + len(packed_rec)] = packed_rec
    else:
        pos = np.zeros(plane_len * d, dtype=np.uint8)
        pos[cfg.lead : cfg.lead + n] = NIB_LUT[seq] if cfg.packed else seq
        plane = pack_nibbles(pos) if cfg.packed else pos

    buf_len = (cfg.lead + span + cfg.tail) // d
    padded_shards = np.zeros((n_shards, buf_len), dtype=np.uint8)
    tile_start0 = np.zeros((n_shards,), dtype=np.int32)
    for s in range(n_shards):
        tile_start0[s] = s * span  # first scan position owned by shard s
        chunk = plane[s * span // d : s * span // d + buf_len]
        padded_shards[s, : len(chunk)] = chunk
    return padded_shards, tile_start0, total_scan, tiles_per_shard


def shard_stream_planes(cfg: ScanConfig, plane: np.ndarray, total_scan: int,
                        n_shards: int, group: int = 1):
    """Cut a prebuilt plane (lead + positions + tail) into per-shard
    halo-padded slices (the JAX package's ``shard_stream_planes``,
    ``sharded.py:178-199``): shard s's buffer starts at plane position
    s*span, the plane position of its first scan position less ``lead``,
    and is zero-padded past the plane's end (the plane's own gaps, lead and
    tail keep their 0xFF). Returns (padded_shards, tile_start0,
    tiles_per_shard)."""
    L = cfg.tile_len
    tiles_per_shard = _tiles_per_shard(-(-total_scan // L), n_shards, group)
    span = tiles_per_shard * L
    d = 2 if cfg.packed else 1
    buf_len = (cfg.lead + span + cfg.tail) // d
    padded_shards = np.zeros((n_shards, buf_len), dtype=np.uint8)
    tile_start0 = np.zeros((n_shards,), dtype=np.int32)
    for s in range(n_shards):
        gstart = s * span
        tile_start0[s] = gstart
        a = gstart // d
        chunk = plane[a : a + buf_len]
        padded_shards[s, : len(chunk)] = chunk
    return padded_shards, tile_start0, tiles_per_shard


def replicate(table: Table, device: torch.device, tables: Optional[dict] = None) -> Table:
    """``table`` on ``device``, copied once per device: ``tables`` (device ->
    Table) keeps the copies across calls."""
    tables = {} if tables is None else tables
    if device not in tables:
        tables[device] = table._replace(**{
            f: v.to(device) for f, v in zip(table._fields, table)
            if isinstance(v, torch.Tensor)})
    return tables[device]


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host: staged in
    pinned memory and copied on the device's current stream, so a plane
    uploaded for the next plan item does not wait for the kernels still
    running. On the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(arr)
    if device.type != "cuda":
        return t
    with torch.cuda.device(device):
        return t.pin_memory().to(device, non_blocking=True)


def upload_shards(planes, rmeta: np.ndarray, recmap, mesh) -> tuple:
    """This process's shards of ``planes`` (padded_shards, tile_start0,
    tiles_per_shard) on their mesh devices: ((shard, device, buffer, rmeta,
    recmap, first scan position) per local shard, tiles_per_shard), the
    record tables uploaded once per device. What a search keeps across
    searches: the plane's bytes do not depend on -N, -X or -I."""
    padded, tile_start0, tps = planes
    n_shards = len(mesh)
    if padded.shape[0] != n_shards:
        raise ValueError(f"{padded.shape[0]} shard planes for a mesh of {n_shards}")
    on_dev: dict = {}
    shards = []
    for s in distributed.local_shards(n_shards):
        dev = mesh[s]
        if dev not in on_dev:
            on_dev[dev] = (upload(rmeta, dev),
                           None if recmap is None else upload(recmap, dev))
        shards.append((s, dev, upload(padded[s], dev), *on_dev[dev], int(tile_start0[s])))
    return tuple(shards), tps


def dispatch_shards(cfg: ScanConfig, table: Table, uploaded, total_scan: int,
                    stream_len: int, rt, tables: Optional[dict]) -> tuple:
    """Enqueue every local shard's tiles (``ops.scan.dispatch_stream``, no
    host read; shards on different cards run at once). ``uploaded``:
    ``upload_shards``'s result; ``table`` on any device, replicated to each
    mesh device through ``tables``. Returns (pending per local shard, tiles
    per shard)."""
    shards, tps = uploaded
    pend = tuple((s, dispatch_stream(cfg, replicate(table, dev, tables), buf,
                                     total_scan, stream_len, rm, rc, rt, tps,
                                     start=start))
                 for s, dev, buf, rm, rc, start in shards)
    return pend, tps


def collect_shards(dispatched, n_shards: int) -> tuple:
    """(one ScanOut per global tile, the global indices of the tiles rerun
    here): every local shard collected (``ops.scan.collect_stream``), then,
    in a group of several processes, every rank's tiles gathered. Tile t
    of shard s is global tile s * tiles_per_shard + t, starts at global scan
    position s*span + t*L and owns clip(total_scan - that, 0, L) positions
    (``sharded.py:61-63``): a shard past the plane's end scans padding
    tiles that own none, and they report zero totals and no rows."""
    pend, tps = dispatched
    outs: List[ScanOut] = []
    reruns = []
    for s, p in pend:
        got, rerun = collect_stream(p)
        outs += got
        reruns += [s * tps + t for t in rerun]
    if len(pend) < n_shards:
        outs = distributed.gather_tiles(outs)
    return outs, reruns


def sharded_scan_record(cfg: ScanConfig, table: Table, seq: np.ndarray,
                        wordsize: int, mesh, rt,
                        packed_rec: Optional[np.ndarray] = None,
                        tables: Optional[dict] = None) -> List[ScanOut]:
    """Scan one record across a mesh (K15a: ``_get_sharded_fn``,
    ``sharded.py:35-83``, and ``sharded_scan_record`` ``:253-297`` with
    ``engine._fetch_sharded``). ``seq``: the record's bytes; ``packed_rec``
    its nibble packing (``cfg.packed``); ``rt``: runtime (-M, -N, -X);
    ``table`` on any device, replicated to each mesh device through
    ``tables``. Returns one ScanOut per global tile, ``len(mesh) *
    tiles_per_shard`` of them, padding tiles included."""
    padded, tile_start0, total_scan, tps = shard_planes(cfg, seq, wordsize, len(mesh),
                                                        packed_rec)
    rmeta = np.asarray([[0, len(seq)]], dtype=np.int32)
    uploaded = upload_shards((padded, tile_start0, tps), rmeta, None, mesh)
    return collect_shards(dispatch_shards(cfg, table, uploaded, total_scan, len(seq),
                                          rt, tables), len(mesh))[0]


def sharded_scan_stream(cfg: ScanConfig, table: Table, plane: np.ndarray,
                        rmeta: np.ndarray, total_scan: int, stream_len: int,
                        mesh, rt, recmap: Optional[np.ndarray] = None,
                        tables: Optional[dict] = None) -> List[ScanOut]:
    """Scan a prebuilt plane across a mesh (K15b: ``_get_sharded_stream_fn``
    ``sharded.py:133-175``, ``sharded_scan_stream`` ``:202-250``). ``plane``:
    uint8 bytes laid out as [lead][records][tail]; ``rmeta``: int32[R, 2]
    (start, length); ``recmap``: the block -> record map of a stream plane
    (``cfg.stream``), None for a one-record plane. Returns one ScanOut per
    global tile, as ``sharded_scan_record``."""
    uploaded = upload_shards(shard_stream_planes(cfg, plane, total_scan, len(mesh)),
                             rmeta, recmap, mesh)
    return collect_shards(dispatch_shards(cfg, table, uploaded, total_scan, stream_len,
                                          rt, tables), len(mesh))[0]
