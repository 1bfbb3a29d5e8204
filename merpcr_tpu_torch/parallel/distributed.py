"""A search spread over several processes (K15c).

Counterpart of ``merpcr_tpu/parallel/distributed.py:30-64`` on
``torch.distributed``:

* ``initialize()`` starts the process group: from its arguments, or from
  the launcher's environment (``torchrun`` sets ``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), the counterpart of
  JAX's auto-detection; with neither, or when a group exists, it is a
  logged no-op;
* ``global_mesh()`` has one shard per rank; rank r scans shard r of every
  plane on ``rank_device`` and ``gather_tiles`` hands every rank every
  global tile's totals and rows, the counterpart of the ``lax.all_gather``
  inside JAX's sharded programs; ``is_output_host()`` gates emission so
  that rank 0 alone writes.

The gather runs on the gloo backend over host tensors, in every layout.
The rows are small (205 rows of six int32 for a 47 Mbp record; JAX too
reads them to the host right after its ``all_gather``), and NCCL refuses
two ranks on one card ("Duplicate GPU detected"), which is the layout of
a one-card machine. So ``initialize`` starts a gloo group whatever the
devices; a group started elsewhere must hold gloo for CPU tensors (the
default ``init_process_group()`` of a CUDA machine does).

Every rank must join each gather in the same order: the engine runs every
plan item on every rank, and gathers once per scanned plane whatever this
rank's share of it holds (a rank whose shard is all padding still joins).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional

import torch
import torch.distributed as dist

from ..ops.scan import ScanOut

logger = logging.getLogger(__name__)

_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Start the gloo process group of a multi-process search.

    With ``coordinator_address`` ("host:port" of rank 0), ``num_processes``
    and ``process_id``: a TCP rendezvous there. With no arguments: the
    launcher environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``). With neither, or when a group already exists: a
    logged no-op, and this process is rank 0 of 1."""
    if dist.is_initialized():
        logger.debug("torch.distributed already initialized: rank %d/%d",
                     rank(), world_size())
        return
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and process_id")
        dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                                world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in _LAUNCHER_ENV):
        dist.init_process_group("gloo", init_method="env://",
                                world_size=int(os.environ["WORLD_SIZE"]),
                                rank=int(os.environ["RANK"]))
    else:
        logger.debug("torch.distributed.initialize skipped: no coordinator "
                     "address and no launcher environment")
        return
    logger.info("torch.distributed initialized: rank %d/%d", rank(), world_size())


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_output_host() -> bool:
    """True on the process that writes results (rank 0)."""
    return rank() == 0


def rank_device(device) -> torch.device:
    """The device this rank scans on: ``cuda:{LOCAL_RANK or rank} %
    device_count()``, or the CPU for an engine built with device="cpu"."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def global_mesh(device="cuda") -> tuple:
    """One shard per rank. Each rank scans only its own shard, so every
    entry is this rank's device (``rank_device``)."""
    return (rank_device(device),) * world_size()


def local_shards(n_shards: int) -> range:
    """The shards this process scans: all of them in one process; in a
    group of several, rank r's contiguous block of n_shards / world_size
    (rank-major, as JAX orders a multi-process mesh's devices)."""
    world = world_size()
    if world == 1:
        return range(n_shards)
    if n_shards % world:
        raise ValueError(f"a mesh of {n_shards} shards over {world} processes")
    k = n_shards // world
    return range(rank() * k, (rank() + 1) * k)


def gather_tiles(outs: List[ScanOut]) -> List[ScanOut]:
    """Every rank's tile outputs on every rank, in rank order (global tile
    order): the five totals of each tile first (equal tile counts on every
    rank), then the hit rows padded to the largest rank's count, trimmed
    by those totals. Returns CPU ScanOuts."""
    t0 = time.perf_counter()
    world = dist.get_world_size()
    totals = torch.tensor([list(o[:5]) for o in outs], dtype=torch.int64).reshape(-1, 5)
    all_totals = [torch.empty_like(totals) for _ in range(world)]
    dist.all_gather(all_totals, totals)
    counts = [int(t[:, 4].sum()) for t in all_totals]
    rows = torch.zeros((max(1, *counts), 6), dtype=torch.int32)
    mine = [torch.stack(o[5:], dim=1).cpu() for o in outs if o.hit_total]
    if mine:
        rows[: counts[rank()]] = torch.cat(mine)
    all_rows = [torch.empty_like(rows) for _ in range(world)]
    t1 = time.perf_counter()
    dist.all_gather(all_rows, rows)
    t2 = time.perf_counter()
    gathered = []
    for tot, got in zip(all_totals, all_rows):
        off = 0
        for row in tot.tolist():
            h = row[4]
            gathered.append(ScanOut(*row, *got[off : off + h].unbind(dim=1)))
            off += h
    # ms: the whole gather, which waits for the slowest rank to arrive;
    # rows_ms: the second collective alone, the ranks already in step
    logger.info("gather: tiles=%d rows=%d bytes=%d ms=%.3f rows_ms=%.3f",
                len(gathered), sum(counts), world * rows.numel() * 4,
                (time.perf_counter() - t0) * 1e3, (t2 - t1) * 1e3)
    return gathered
