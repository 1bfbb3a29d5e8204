#!/usr/bin/env python3
"""Card check of the PyTorch/CUDA port (``merpcr_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py [--seed 0] [--mbp 47] [--nsts 1000] [--planted 200]

``--package-root DIR`` runs the ``merpcr_tpu_torch`` of another checkout
(for example a parent commit unpacked with ``git archive``) through the
same phases and measurements, for an A/B on one card: run parent, this
tree, this tree, parent in one command. The device-operation gate below
holds only for this checkout's package. ``--only warm_path`` runs phases
1-3 and phase 15 alone, without its device="cpu" comparisons, floods and
mixed plan: the A/B of the warm-search path, which a checkout before it
runs as well.

Phases (each prints one JSON line; any failure exits non-zero, and the
closing device line is printed only when every phase passed):

1. device    card name, and name + power limit from nvidia-smi
2. build     the kernel sources compiled from csrc/ by nvcc for sm_90a, one
             process per source, all at once; ptxas register/smem lines
3. workload  a random ACGT genome (one record) and random STS made from
             --seed, the first --planted STS planted as amplicons, plus
             one amplicon across every 2^23 tile boundary and one anchor
             W-mer straddling each boundary, plus 50 (+) amplicons with
             one mismatch in each primer and 50 with two (past the W = 11
             W-mer, off the -X 1 protected ends), plus amplicons whose real
             size is off the stated size by +100, -100, +700, +5,000 and
             +9,900 (three each, and one +100 that ends 40 bases before the
             record's end), which only a margin of at least that finds;
             written as STS + FASTA files
4. kernels   on one real 2^23 tile of that genome, each kernel against
             its plain PyTorch version on the same card tensors: every
             output and total must be equal (integers, tolerance 0); times
             from CUDA events
5. end2end   MerPCR().load_sts_file -> load_fasta_file -> search on the
             card, cold then warm (launch counts read around the warm
             run); every planted amplicon's line present and no mismatch
             plant's; output bytes equal to the same search with
             device="cpu" (plain versions); then a breakdown of one
             record's search: host-clock time per step and device time per
             kernel from torch.profiler
6. mismatch  the same engine at -N 1 (strict1 tables, built on this first
             -N 1 search) and at -N 2 (loose front end, K8), each cold then
             warm (launch counts around the warm run): the path that ran,
             the 1-mismatch lines present at both, the 2-mismatch lines at
             -N 2 only, every exact plant present, bytes equal to
             device="cpu"; a breakdown of the warm search; then the
             path's kernels against their plain versions on one real 2^23
             tile (phase mismatch_kernels)
7. wordsize  the same record in a fresh engine at W = 12, 13, 14 and 16
             (stride-2 exact tables with bstart or a binary search; above
             13 a mult-hash group bloom, no phase table): -N 0 (strict)
             cold then warm and -N 2 (loose) cold then warm, launch counts
             around the warm runs; the tier that ran; every exact plant
             present; bytes equal to device="cpu" (which also holds the
             mismatch plants' lines: they were placed clear of the W = 11
             word only); then that W's kernels against their plain
             versions on one real 2^23 tile, strict and loose (phase
             wordsize_kernels)
8. margin    the record at W = 11, -N 0, at -M 1000 and -M 10000, cold
             then warm: each off-size plant's line present exactly when
             the margin admits it (none at -M 50, phase 5); bytes equal to
             device="cpu"; the path's kernels against their plain versions
             on one real tile at that -M (phase margin_kernels), and at
             -M 10000 margin_p2 once more with the tile's anchors repeated
             until their rows pass the kernel's row buffer: a second
             launch, rows equal to the plain version's (margin_p2 counts
             each launch: one per tile on the searches, two here)
9. raw      records outside the 16-letter alphabet (the raw-byte path,
             K9): the record rendered as RNA (every T a U, the reverse-
             strand plants too) and passed through the API as a
             FASTARecord, at -I 1, cold then warm (launch counts around the
             warm run: the raw wrappers once per tile, no others): at -N 0
             bytes equal to the DNA record's -I 1 output, all planted
             lines, no mismatch plant's, and a breakdown; at -N 2 the 1- and
             2-mismatch plants; at W = 13 and 14 every exact plant; at
             -M 1000 each off-size plant exactly when the margin admits it;
             then a rendering with a junk byte (-*.0-9éZEÿ) about every
             10 kb outside the amplicons: every planted line, bytes equal
             to device="cpu"; the raw kernels against their plain versions
             on tile 1 (phase raw_kernels; the byte modes also at -I 0)
10. golden   tests/data through the API and through
             ``python -m merpcr_tpu_torch``: exactly the golden line; the
             CLI at -I 1, at -N 2 and at -W 13 -M 300 equal to the API
11. assembly a draft assembly: 30 Mbp of random ACGT in 3,000 equal
             scaffolds x --nsts random STS, --planted amplicons planted
             wholly inside scaffolds; every fourth planted STS carries R/Y/N
             letters in its primers and its sites resolve them. Four
             variants: (a) clean at -I 0, (b) the same scaffolds with 1 %
             scattered NRYKMSWBDHV (scattered before planting) at -I 0, (c)
             variant (b) at -I 1, (d) variant (b) at -I 1 -N 2 (loose, no
             dirty-span filter: the loose path's heaviest expansion). Each
             runs cold then warm on the card through the stream path
             (launch counts read around the warm run: every kernel of the
             path launched, at most once per stream tile); every planted
             ACGT-primer line present, the R/Y/N-primer lines present in
             (c) and (d) only; bytes equal to device="cpu"; the dirty-span
             filter (K10) armed in (b) and (c); then (e) variant (c) with
             every 100th scaffold rendered as RNA: those 30 take the
             raw-byte path alone (the raw front end and expansion launch
             once per such scaffold), the others the stream path, and the
             lines equal (c)'s; then variant (c) at W = 13
             and W = 14 (stream + K10 + K11 on the prefix-filter and
             every-valid-phase branches), ACGT-primer lines present
12. stream_kernels  on one real 2^21 stream tile of variant (c), each
             kernel's stream + dirty-span + IUPAC variant against its plain
             version on the same card tensors (tolerance 0); the tile must
             hold anchors and hits that only the IUPAC expansion-set match
             admits; times from CUDA events and torch.profiler, byte/op
             bound; then the same for variant (d)'s loose kernels on that
             tile at -N 2 (with a breakdown of (d)'s warm search), and for
             variant (c) at W = 13 and W = 14 on that tile. Wherever the
             dirty-span filter is armed the tile must hold positions that
             only the filter removes (the filter changes totals, not lines)
13. sharded  the sharded search (K15) on the one card (overhead, not
             scaling): the 47 Mbp record at -N 0 and -N 2 on 1, 2 and 4
             shards of cuda:0 (``use_mesh``) and assembly (c) on 1 and 2,
             each cold then warm with the launch counts read around the
             warm run (front end and expansion once per global tile,
             padding tiles included; verify and margin at most once per
             real tile: a padding tile has no pairs and skips them) and
             bytes equal to the single-device output; the per-global-tile
             outputs of the record's 4-shard plane on the card against the
             same call on the CPU (plain versions, padding tiles included,
             tolerance 0); then ``python -m merpcr_tpu_torch --multihost``
             as two gloo ranks on cuda:0 (launcher environment): rank 0's
             stdout equal to the single-device bytes, rank 1's empty, both
             exit 0 with the same hit count; a summary line with the warm
             seconds per shard count, the gather's milliseconds (whole,
             and its row collective alone) and bytes from rank 0's log,
             and its bound at this host's memcpy rate
14. host_path the host fast path (``ops/host_scan.py``) and its gate,
             one line: (a) the golden files on the default gate through
             ``MerPCR()`` and ``python -m merpcr_tpu_torch``: the golden
             line, no launch of any wrapper, no device table; (b) the same
             at MERPCR_TPU_HOST_MAX=0: the golden line, the four kernels
             launched; (c) start-up in cold processes on the host clock:
             the golden CLI under (a) and (b), and each step of both paths
             (``import torch``, ``resolve_device``, STS load and table
             compile, CUDA context, table upload, kernel library load,
             first search), then prefixes of the record (0.25, 0.5, 1 and
             2 Mbp) cold and warm on the host path (a fresh engine each),
             on the card's device path, and on the default gate on that
             warm engine, which holds the table on the card and so takes
             the kernels: bytes equal, every exact plant inside the prefix
             present; (d) two floods, the JAX flood test's shared-W-mer
             corpus (past 20,000 candidates, -N 2) and a tandem-primer
             repeat tract (past 400,000 window work, -M 300):
             ``host_scan_record`` returns None, the default gate scans the
             record on the kernels (launches read around it) with the bytes
             of MERPCR_TPU_HOST_MAX=0 and of device="cpu"; pair and row
             totals per tile against ``expand``'s and ``margin_p2``'s
             buffers (the repeat tract's rows take margin_p2's second
             launch); (e) a warm 47 Mbp -N 0 search under MERPCR_TPU_TRACE:
             one Chrome trace holding kernel events of the four kernels,
             the untraced bytes, warm s traced and untraced; then the
             golden CLI cold and traced under (a) and (b), which pays the
             profiler's first start in its process. Under
             ``--package-root`` a package without ``ops/host_scan.py``
             gets a line saying the phase did not run

15. warm_path the warm-search path: (a) the 47 Mbp record and assembly (c)
             on one engine each: the first search, three warm searches,
             then -N 2, -N 1, -N 0 and -M 1000, each with its host seconds,
             host reads (every ``ScanState.read`` and ``wait``, counted
             here), planes, tiles, tiles rerun and launches, bytes equal to
             device="cpu"; device busy and idle share of a warm search;
             the first search's host steps (dirty rate, plane, upload; a
             warm search takes them from the engine's cache); (b) the
             record at -N 2 and assemblies (a), (b), (d), (e) on fresh
             engines, first search and warm; (c) phase 14's two floods and
             their RNA renderings on the deferred scan: the tiles rerun
             count first are exactly those whose pair_total passes
             ``expand``'s pair buffer or whose hit_total passes
             ``margin_p2``'s row buffer, bytes equal to device="cpu"; (d) a
             mixed plan (a stream run, an empty record, a 2 Mbp lone
             record, an RNA scaffold, another run) under the depth-1
             prefetch: FASTA order, bytes equal to device="cpu"

Phases 1-13 and 15 run at MERPCR_TPU_HOST_MAX=0 (set by this script,
inherited by the processes it starts), so their inputs never take the host
path; phase 14 sets the gate itself. A search launches the stage
wrappers in their deferred mode (given ``totals``; rows ``*_deferred``,
counted in the wrapper's ``launches_deferred``) once per tile, and in
their count-first mode only to rerun a tile past a buffer.

The second-to-last JSON line lists every kernel with its launches on the
main path, error against its plain version, times and bound, each
kernel's count-first mode and its deferred one (``*_deferred``: counts
from device memory, fixed buffers, against the plain versions under the
same buffer contract); the count-first rows carry the launches of phase 15's
floods, where a search reruns tiles count first, and the run fails if any
row was launched no time: the record
path's four kernels (phase 4 times, launches of the warm 47 Mbp search),
their stream variants (phase 12 times, launches of the warm variant (c)
search), the -N 1 (strict1) and -N 2 (loose) paths' kernels (phase 6
times, launches of the warm 47 Mbp search at that -N), and the loose
stream kernels (phase 12 times, launches of the warm variant (d)
search), the W = 12, 13, 14, 16 kernels strict and loose (phase 7) and the
-M 1000 and -M 10000 kernels (phase 8), the stream kernels of variant
(c) at W = 13 and 14 (phase 12), and the raw-byte kernels (phase 9, with
the launches of the warm RNA -N 0 search), each with the launches of its
own warm search. ``device_ms`` pools several profiler traces, since the profiler
loses events (``profiled_ms``): ``device_events_lost`` is their share,
and a ``device_ms`` of null a reading with too few left; ``host_ms`` is
the host's time per call (the launch, for a wrapper without a host read);
a front end's byte bound counts its prefilter once and the full-table
words of the items that pass it, where that is less than every item's
table word. ``device_ops``
is the device operations (kernels, copies, fills) of one call from the same
traces; the run fails if an expand wrapper issues more than 2, or a front
end, a verify_p1, a margin_p2 or a deferred wrapper more than 1. The rows of the loose
and raw front ends also carry ``prefilter`` (of the tile's looked-up
items, clean and in scan, the share whose prefilter bit is set, which
gather from the full table, and the prefilter's density) and
``fold_ms`` (device ms with the table's prefilter and with folds of 2^18
and 2^20 bits, in turns, each call also equal to the plain version). The
breakdowns of strict searches also read the strict front end's device time
over the tile scan without and with a persisting L2 access-policy window
over its table (set on the stream through the CUDA driver API). The line before
the last is nvidia-smi's name and power limit; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import io
import json
import os
import random
import subprocess
import sys
import tempfile
import time
from contextlib import redirect_stdout

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
SCALAR_OPS_PER_S = 67e12  # H100 SXM non-tensor 32-bit peak (fp32 table entry)
TILE = 1 << 23
STREAM_TILE = 1 << 21
ASM_MBP = 30.0  # the assembly phase's size: bench.py's scaffolds_3000 row
ASM_RECORDS = 3000
AMBIGUITY = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)
RESOLVE = {ord("R"): b"AG", ord("Y"): b"CT", ord("N"): b"ACGT"}
COMP = bytes.maketrans(b"ACGTRYN", b"TGCAYRN")
# the wrappers of a -N 0 search: the front end and the deferred modes of
# the tile scan's stages (``Deferred``), one launch each per tile
WRAPPERS = ("front_end", "expand_deferred", "verify_p1_deferred", "margin_p2_deferred")
RAW_WRAPPERS = ("front_end_raw", "expand_raw_deferred", "verify_p1_raw_deferred",
                "margin_p2_raw_deferred")
# the count-first wrappers: a search launches them only to rerun a tile
# that passed a buffer of the deferred scan
COUNT_FIRST = ("expand", "expand_loose", "expand_raw", "verify_p1", "verify_p1_raw",
               "margin_p2", "margin_p2_raw")
DEFERRED = tuple(f"{k}_deferred" for k in COUNT_FIRST)
KERNEL_NAMES = ("front_end_kernel", "expand_kernel", "verify_p1_kernel", "margin_p2_kernel")
# wrapper -> its kernel source in merpcr_tpu_torch/csrc/
SOURCE_OF = {"front_end_loose": "front_end", "front_end_raw": "front_end",
             **{k: next(s for s in ("expand", "verify_p1", "margin_p2") if k.startswith(s))
                for k in COUNT_FIRST + DEFERRED}}
GOLDEN_LINE = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"
ROOT = os.path.dirname(os.path.abspath(__file__))
PKG = ROOT  # the checkout whose merpcr_tpu_torch runs (--package-root)
# device operations per call that the redesigned wrappers may issue: one
# launch, and for expand a second when the pairs pass its buffer (margin_p2
# takes a second only past its row buffer, which no tile timed here
# reaches: phase 8 checks that case on its own, and phase 14's window
# flood reaches it in a search)
DEVICE_OPS_MAX = {"front_end": 1, "front_end_loose": 1, "front_end_raw": 1,
                  "expand": 2, "expand_loose": 2, "expand_raw": 2,
                  "verify_p1": 1, "verify_p1_raw": 1, "margin_p2": 1, "margin_p2_raw": 1,
                  **{k: 1 for k in DEFERRED}}


class Deferred:
    """The deferred-mode launch count of a stage wrapper (its
    ``launches_deferred``), read and reset as ``launches`` under the name
    ``<wrapper>_deferred``, beside the wrapper's count-first ``launches``."""

    def __init__(self, fn):
        self.fn = fn
        self.__name__ = f"{fn.__name__}_deferred"

    @property
    def launches(self) -> int:
        return self.fn.launches_deferred

    @launches.setter
    def launches(self, n: int) -> None:
        self.fn.launches_deferred = n


READS = [0]  # the host's waits on the card so far (count_reads)
# host seconds of the waits on the card and of the garbage collections
# (all, and those of the oldest generation), and their number (count_reads)
CLOCK = {"wait_s": 0.0, "gc_s": 0.0, "gc_runs": 0, "gc2_s": 0.0}


def count_reads(kernels) -> None:
    """Count every host wait on the card in READS: ``ScanState.read`` (a
    count-first wrapper's totals) and ``ScanState.wait`` (the deferred
    scan's one read per plane), patched on the class, so that another
    checkout's package (``--package-root``) is counted the same way. The
    host seconds of those waits go into CLOCK["wait_s"], and those of
    Python's garbage collections into CLOCK["gc_s"]."""
    cls = kernels.ScanState
    for name in ("read", "wait"):
        real = getattr(cls, name, None)
        if real is None:
            continue

        def counted(self, *args, _real=real):
            READS[0] += 1
            t0 = time.perf_counter()
            try:
                return _real(self, *args)
            finally:
                CLOCK["wait_s"] += time.perf_counter() - t0

        setattr(cls, name, counted)
    gc_t0 = [0.0]

    def gc_clock(phase, info):
        if phase == "start":
            gc_t0[0] = time.perf_counter()
        else:
            dt = time.perf_counter() - gc_t0[0]
            CLOCK["gc_s"] += dt
            CLOCK["gc_runs"] += 1
            if info.get("generation") == 2:
                CLOCK["gc2_s"] += dt

    gc.callbacks.append(gc_clock)


def check(cond, msg: str) -> None:
    """Fail the run (exit non-zero, no result line) unless ``cond``."""
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- workload
def sts_rows(rng, n_sts: int):
    """Random STS: primers of 18-25 random bases, products of 100-399."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rows = []
    for i in range(n_sts):
        p1 = acgt[rng.integers(0, 4, size=int(rng.integers(18, 26)))].tobytes()
        p2 = acgt[rng.integers(0, 4, size=int(rng.integers(18, 26)))].tobytes()
        rows.append((f"SMOKE{i}", p1, p2, int(rng.integers(100, 400))))
    return rows


def write_sts(path: str, rows) -> str:
    with open(path, "w") as fh:
        for sid, p1, p2, size in rows:
            fh.write(f"{sid}\t{p1.decode()}\t{p2.decode()}\t{size}\talias {sid}\n")
    return path


def write_fasta(path: str, records, width: int = 80) -> str:
    """``records``: (label, uint8 sequence) pairs, written ``width`` bases
    per line."""
    with open(path, "wb") as fh:
        for label, seq in records:
            n = len(seq)
            pad = (-n) % width
            body = np.concatenate([seq, np.full(pad, ord("\n"), np.uint8)]).reshape(-1, width)
            body = np.concatenate([body, np.full((len(body), 1), ord("\n"), np.uint8)], axis=1)
            fh.write(f">{label} synthetic {n} bp\n".encode())
            fh.write(body.tobytes()[: n + -(-n // width)])  # ends in a newline
    return path


MM_PLANTS = 50  # amplicons with 1 and with 2 mismatches per primer, each
SIZE_DELTAS = (100, -100, 700, 5000, 9900)  # real minus stated product size
SIZE_PLANTS = 3  # amplicons per delta


def make_workload(tmp: str, seed: int, n_mbp: float, n_sts: int, planted: int):
    """(sts path, fasta path, genome length, expected planted lines, {k:
    lines of the amplicons planted with k mismatches in each primer},
    {delta: lines of the amplicons planted delta off their stated size}).

    The mismatch plants are (+) amplicons of STS that no other plant
    uses, with k transitions in primer 1 past its W-mer (which the lookup
    matches exactly) and off its 3'-end base, and k in primer 2 off its
    first base (the -X 1 protected ends); only -N >= k finds them."""
    rng = np.random.default_rng(seed)
    n = int(n_mbp * 1e6)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = acgt[rng.integers(0, 4, size=n, dtype=np.uint8)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    rows = sts_rows(rng, n_sts)
    label = "smoke_genome"
    expect, taken = [], []

    mism = {1: [], 2: []}
    transition = bytes.maketrans(b"ACGT", b"GTAC")

    def mutate(primer: bytes, lo: int, hi: int, k: int) -> bytes:
        site = bytearray(primer)
        for j in rng.choice(np.arange(lo, hi), size=k, replace=False):
            site[j : j + 1] = bytes(site[j : j + 1]).translate(transition)
        return bytes(site)

    off_size = {d: [] for d in SIZE_DELTAS}

    def plant(pos, i, strand, k=0, delta=0):
        sid, p1, p2, size = rows[i]
        size += delta  # the amplicon's real size; the STS states rows[i][3]
        if pos < 0 or pos + size > n or any(a < pos + size and pos < b for a, b in taken):
            return False
        left, right = (p1, p2) if strand == "+" else (p2, p1.translate(comp)[::-1])
        if k:
            left, right = mutate(left, 12, len(left) - 2, k), mutate(right, 2, len(right) - 2, k)
        genome[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
        genome[pos + size - len(right) : pos + size] = np.frombuffer(right, dtype=np.uint8)
        taken.append((pos, pos + size))
        line = f"{label}\t{pos + 1}..{pos + size}\t{sid}\talias {sid}\t({strand})"
        (off_size[delta] if delta else mism[k] if k else expect).append(line)
        return True

    for i in range(planted):  # evenly spread, as bench.py plants them
        plant((n // (planted + 1)) * (i + 1), i, "+")
    k = planted
    for b in range(TILE, n, TILE):
        plant(b - 60, k % n_sts, "+")  # amplicon across the tile boundary
        plant(b - 7, (k + 1) % n_sts, "-")  # anchor W-mer straddles it
        k += 2
    gap = n // (2 * MM_PLANTS + 1)
    for j in range(2 * MM_PLANTS):  # between the exact plants, other STS
        plant(gap * (j + 1) + gap // 3, (k + j) % n_sts, "+", 1 + j % 2)
    # off-size amplicons, after every other plant so that those keep their
    # places: STS no other plant uses, stated sizes that leave room for the
    # negative deltas (lo = exp - l1 - l2), free places found by stepping
    free = (i for i in range(k + 2 * MM_PLANTS, n_sts) if rows[i][3] >= 250)
    pos = n // 7
    for delta in SIZE_DELTAS:
        for j in range(SIZE_PLANTS):
            i = next(free)
            for _ in range(1000):
                if plant(pos % n, i, "+-"[j % 2], delta=delta):
                    break
                pos += 20_011
            else:
                raise RuntimeError(f"no free place for a {delta:+d} amplicon")
            pos += n // 19
    i = next(free)  # ends 40 bases before the record's end: hi = 140 there
    check(plant(n - 40 - (rows[i][3] + 100), i, "+", delta=100), "end plant overlaps")
    sts = write_sts(os.path.join(tmp, "smoke.sts"), rows)
    fa = write_fasta(os.path.join(tmp, "smoke.fa"), [(label, genome)])
    return sts, fa, n, expect, mism, off_size


def make_assembly(tmp: str, seed: int, n_sts: int, planted: int):
    """A draft assembly (the shape of the JAX package's bench row
    ``scaffolds_3000``): ASM_RECORDS equal scaffolds of random ACGT,
    ``planted`` amplicons wholly inside scaffolds, and a dirty copy with
    1 % scattered ambiguity letters (``bench.py``'s ``iupac_genome``)
    scattered before planting. Every fourth planted STS gets two R/Y/N
    letters in each primer (outside its 3'-end 12 bases, which hold the
    anchor W-mer), and its sites hold ACGT bases that resolve them: only
    -I 1 finds those. Returns (sts path, clean fasta, dirty
    fasta, total bases, lines of the ACGT-primer plants, lines of the
    R/Y/N-primer plants)."""
    rng = np.random.default_rng(seed + 1)
    n_rec = int(ASM_MBP * 1e6) // ASM_RECORDS
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    clean = acgt[rng.integers(0, 4, size=n_rec * ASM_RECORDS, dtype=np.uint8)]
    dirty = clean.copy()
    hit = rng.integers(0, len(dirty), size=len(dirty) // 100)
    dirty[hit] = AMBIGUITY[rng.integers(0, len(AMBIGUITY), size=len(hit))]
    rows = sts_rows(rng, n_sts)
    expect, expect_iupac = [], []

    def resolved(primer: bytes) -> np.ndarray:
        site = bytes(rng.choice(list(RESOLVE[b])) if b in RESOLVE else b for b in primer)
        return np.frombuffer(site, dtype=np.uint8)

    for i in range(planted):  # one amplicon in every (ASM_RECORDS // planted)th scaffold
        sid, p1, p2, size = rows[i]
        if i % 4 == 3:
            p1, p2 = bytearray(p1), bytearray(p2)
            for p in (p1, p2):
                # off the 3'-end W-mer, so that each entry keeps its hash
                for j in rng.integers(0, len(p) - 12, size=2):
                    p[j] = int(rng.choice(list(b"RYN")))
            rows[i] = (sid, bytes(p1), bytes(p2), size)
            p1, p2 = rows[i][1:3]
        r = (i * ASM_RECORDS) // planted
        pos = int(rng.integers(0, n_rec - size))
        strand = "+" if i % 2 else "-"
        left, right = (p1, p2) if strand == "+" else (p2, p1.translate(COMP)[::-1])
        left, right = resolved(left), resolved(right)
        for g in (clean, dirty):
            s = g[r * n_rec : (r + 1) * n_rec]
            s[pos : pos + len(left)] = left
            s[pos + size - len(right) : pos + size] = right
        line = f"scaf{r}\t{pos + 1}..{pos + size}\t{sid}\talias {sid}\t({strand})"
        (expect_iupac if i % 4 == 3 else expect).append(line)
    sts = write_sts(os.path.join(tmp, "asm.sts"), rows)
    fas = [write_fasta(os.path.join(tmp, f"asm_{name}.fa"),
                       [(f"scaf{r}", g[r * n_rec : (r + 1) * n_rec]) for r in range(ASM_RECORDS)])
           for name, g in (("clean", clean), ("dirty", dirty))]
    return sts, fas[0], fas[1], n_rec * ASM_RECORDS, expect, expect_iupac


# ---------------------------------------------------------------- timing
def cuda_ms(fn, reps: int) -> float:
    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps: int) -> float:
    """Host ms per call of ``fn``: the loop's time on the host clock, the
    card synchronised before and after but not inside (for a wrapper with no
    host read, the time to launch its kernel)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e3


def device_time(fn) -> dict:
    """{name: (device seconds, count)} of the CUDA-side events (kernels,
    copies, fills) that ``fn`` issues, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {
        e.key: (e.self_device_time_total / 1e6, e.count)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    }


def profiled_ms(fn, reps: int) -> tuple:
    """(device ms per call of ``fn``, share of events lost, device
    operations per call, {event name: device ms per call}) from
    torch.profiler; the operations are the kernels, copies and fills that
    one call issues, m per event name. The profiler drops events: often
    the first few of a trace, now and then a long stretch or every event
    of one name. So
    two or three traces of ``reps`` + 1 calls are pooled: an event name
    comes m times per call, m the most any trace shows, and costs m
    times its mean over the pooled events, which a loss does not move. The
    reading is void, (None, share), while a name has fewer than ``reps``
    pooled events."""
    n, traces = reps + 1, []
    while len(traces) < 3:
        dev = device_time(lambda: [fn() for _ in range(n)])
        traces.append(dev)
        per_call = [{k: -(-c // n) for k, (_, c) in d.items()} for d in traces[-2:]]
        if dev and len(traces) > 1 and per_call[0] == per_call[1]:
            break
    pooled = {}
    for d in traces:
        for k, (t, c) in d.items():
            t0, c0, m0 = pooled.get(k, (0.0, 0, 0))
            pooled[k] = (t0 + t, c0 + c, max(m0, -(-c // n)))
    ops = sum(m for _, _, m in pooled.values())
    want = len(traces) * n * ops
    lost = 1 - sum(c for _, c, _ in pooled.values()) / want if want else 1.0
    if not pooled or any(c < reps for _, c, _ in pooled.values()):
        return None, lost, ops, {}
    split = {k.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0][:60]:
             t / c * m * 1e3 for k, (t, c, m) in pooled.items()}
    return sum(split.values()), lost, ops, split


def max_abs_err(got, want) -> int:
    """Largest absolute difference over matching outputs (ints and
    tensors); a shape mismatch is a failure."""
    err = 0
    for g, w in zip(got, want):
        if isinstance(g, torch.Tensor):
            if g.shape != w.shape:
                raise RuntimeError(f"shape {tuple(g.shape)} != {tuple(w.shape)}")
            if g.numel():
                err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
        else:
            err = max(err, abs(int(g) - int(w)))
    return err


def prefilter_stats(table, pre, pre_bits: int, shift: int, keys) -> dict:
    """How the loose or raw front end's prefilter (2^pre_bits bits at key
    bit ``shift`` of the 2^t-bit ``table``) treats the tile's looked-up
    ``keys`` (table indices of the valid items with clean keys): the share
    whose prefilter bit is set (they gather from the full table), the share
    the full table holds, the prefilter's density, and the distinct table
    words that all keys and the passed keys touch (``bound``'s bytes)."""
    from merpcr_tpu_torch.ops.units import u32

    def bit(words, i):
        return ((u32(words)[i >> 5] >> (i & 31)) & 1) == 1

    n = keys.numel()
    hit = bit(pre, (keys >> shift) & ((1 << pre_bits) - 1))
    passed = int(hit.sum())
    held = int(bit(table, keys).sum())
    ones = int(((u32(pre)[:, None] >> torch.arange(32, device=pre.device)) & 1).sum())
    confirm = table.numel() * 32 > 1 << pre_bits
    return {"bits": pre_bits, "shift": shift, "table_bits": (table.numel() * 32).bit_length() - 1,
            "confirm": confirm, "tested": n, "passed": passed,
            "pass_share": passed / n if n else None, "table_hits": held,
            "prefilter_density": ones / float(1 << pre_bits),
            "words": int(torch.unique(keys >> 5).numel()),
            "passed_words": int(torch.unique(keys[hit] >> 5).numel()) if confirm else 0}


def table_bytes(distinct_words: int, pre_stats) -> int:
    """The least table bytes a front end must read: 4 per distinct table
    word its items look up; with a prefilter, where that is less, the
    prefilter once (2^bits / 8 bytes) and 4 per distinct full-table word
    that the items it passes gather."""
    if pre_stats is None:
        return 4 * distinct_words
    return min(4 * pre_stats["words"],
               (1 << pre_stats["bits"]) // 8 + 4 * pre_stats["passed_words"])


def bound(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def search_bytes(engine, recs) -> tuple:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        hits = engine.search(recs)
    if engine.device.type == "cuda":
        torch.cuda.synchronize()
    return buf.getvalue(), hits, time.perf_counter() - t0


# ---------------------------------------------------------------- phases
def record_tile(eng, recs):
    """(cfg, card plane, tile index, scan positions, rmeta, recmap) of the
    47 Mbp record's plane: tile 1 starts at a tile boundary and holds
    boundary plants on both sides."""
    from merpcr_tpu_torch.io.fasta import record_packed
    from merpcr_tpu_torch.ops.scan import record_rmeta

    n = len(recs[0].sequence)
    total = n - eng.wordsize + 1
    cfg = eng._base_config(eng._pick_tile_len(total))
    check(cfg.tile_len == TILE, f"tile length {cfg.tile_len}")
    n_tiles = -(-total // cfg.tile_len)
    plane = eng._plane(record_packed(recs[0]), cfg.lead + n_tiles * cfg.tile_len + cfg.tail,
                       cfg.lead, packed=True)
    return (cfg, torch.from_numpy(plane).to(eng.device), 1, total,
            record_rmeta(n, eng.device), None)


def stream_tile(eng, recs):
    """The same for the assembly's stream plane (tile 1 of 2^21)."""
    (kind, _, items), = eng._plan(recs)
    check(kind == "stream", f"assembly plan is {kind}")
    cfg, plane, total, _, rmeta, recmap = eng._stream_plane(items)
    check(cfg.tile_len == STREAM_TILE and cfg.stream, f"stream tile {cfg.tile_len}")
    dev = eng.device
    return (cfg, torch.from_numpy(plane).to(dev), 1, total,
            torch.from_numpy(rmeta).to(dev), torch.from_numpy(recmap).to(dev))


def phase_kernels(eng, laid, card: str, phase: str, variant: str,
                  buffer_check: bool = False) -> dict:
    """Each kernel of the config's path and its plain version on one real
    tile of ``laid`` (``record_tile``/``stream_tile``), with the config's
    front end (strict over the N=0 or N=1 tables, or loose), word-size
    tier, filters and the engine's runtime -M/-N/-X. With ``buffer_check``
    margin_p2 runs once more on the tile's anchors repeated until their
    rows pass the kernel's row buffer, so that the wrapper must launch
    twice. Returns {wrapper name: kernel entry}."""
    from merpcr_tpu_torch.ops.expand import (expand, expand_loose, expand_loose_plain,
                                             expand_plain, expand_raw, expand_raw_plain)
    from merpcr_tpu_torch.ops.front_end import (GOLD, front_end, front_end_loose,
                                                front_end_loose_plain, front_end_plain,
                                                front_end_raw, front_end_raw_plain)
    from merpcr_tpu_torch.ops import margin_p2 as margin_mod
    from merpcr_tpu_torch.ops.margin_p2 import (margin_p2, margin_p2_plain, margin_p2_raw,
                                                margin_p2_raw_plain)
    from merpcr_tpu_torch.ops.units import (group_regs, mask_bases, mul32, raw_hashes,
                                            unit_regs, units_of, valid_phases)
    from merpcr_tpu_torch.ops.verify_p1 import (verify_p1, verify_p1_plain, verify_p1_raw,
                                                verify_p1_raw_plain)

    cfg, plane, t, total, rmeta, recmap = laid
    W, L, lead = eng.wordsize, cfg.tile_len, cfg.lead
    t0 = t * L
    step = cfg.tile_step_in  # plane bytes per tile: L/2 packed, L raw
    tile = plane[t * step : t * step + cfg.tile_buf_in]
    n_scan = min(L, total - t0)
    tb = eng._table
    margin, nmm, x = eng._runtime_params()
    bloom = tb.bloom if cfg.dirty_bloom else None
    raw = not cfg.packed
    if raw:  # byte verifies: primer bytes, and the match table at -I 1
        p1c, p2c = tb.p1_bytes, tb.p2_bytes
        p1x = p2x = tb.match if cfg.iupac else None
        code_b = 2 if cfg.iupac else 1  # primer byte (+ match byte) per base
        vf, vf_plain, mf, mf_plain = (verify_p1_raw, verify_p1_raw_plain, margin_p2_raw,
                                      margin_p2_raw_plain)
    else:
        p1c, p2c = tb.p1_codes, tb.p2_codes
        p1x, p2x = (tb.p1_exp, tb.p2_exp) if cfg.iupac else (None, None)
        code_b = 4 if cfg.iupac else 1  # bytes per primer base read
        vf, vf_plain, mf, mf_plain = verify_p1, verify_p1_plain, margin_p2, margin_p2_plain
    rec_b = 12 if cfg.stream else 0  # recmap + rmeta bytes per candidate
    res = {}

    def run(name, kernel, plain, args, reps, n_bytes, n_ops, replaces, out_of, kw=None):
        kw = kw or {}
        got, want = kernel(*args, **kw), plain(*args)
        err = max_abs_err(out_of(got), out_of(want))
        ms = cuda_ms(lambda: kernel(*args, **kw), reps)
        call_host_ms = host_ms(lambda: kernel(*args, **kw), reps)
        plain_ms = cuda_ms(lambda: plain(*args), max(2, reps // 5))
        device_ms, lost, ops, split = profiled_ms(lambda: kernel(*args, **kw), reps)  # None: void
        b_ms, b_by = bound(n_bytes, n_ops)
        res[name] = {
            "name": name if not variant else f"{name}[{variant}]", "route": "cuda",
            "source": f"merpcr_tpu_torch/csrc/{SOURCE_OF.get(name, name)}.cu",
            "replaces": replaces, "equal": err == 0, "max_abs_err": err,
            "ms": ms, "kernel_ms": ms, "host_ms": call_host_ms, "device_ms": device_ms,
            "device_events_lost": lost, "device_ops": ops, "device_split": split,
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None, "prefilter": None,
        }
        if err:
            raise RuntimeError(f"{name}[{variant}]: kernel differs from plain by {err}")
        check(PKG != ROOT or ops <= DEVICE_OPS_MAX.get(name, ops),
              f"{name}[{variant}]: {ops} device operations per call")
        return got

    # K1 / K8: plane units of the scan span + the distinct table words
    # looked up
    fe_kw, pre_stats = {}, None
    n_units = L // 8
    u = units_of(tile[: tile.numel() // 4 * 4]) if not raw else None
    if raw:  # one item per scan position, one bloom word per clean window;
        # the least work is a rolling W-mer: code the new byte (4: select,
        # code-table read, shift, add), its W-mer index (2: funnel shift,
        # mask), the prefilter bit (6: word index, read, shift, mask, place,
        # OR) and its share of the ambiguity smear and the word (2)
        h, amb = raw_hashes(tile, torch.arange(L, device=tile.device) + lead, W)
        bk = (h >> (2 * W - tb.bloom_bits))[~amb]
        n_items, fe_name, fe, fe_plain = L, "front_end_raw", front_end_raw, front_end_raw_plain
        fe_line = "merpcr_tpu/ops/scan.py:660"
        fe_args = (tile, tb.bloom, tb.bloom_bits, W, lead, L, n_scan)
        if hasattr(tb, "raw_prefilter"):  # (an A/B parent has none)
            fe_kw = {"prefilter": tb.raw_prefilter}
            tested = (h >> (2 * W - tb.bloom_bits))[~amb & (torch.arange(L, device=tile.device)
                                                           < n_scan)]
            pre_stats = prefilter_stats(tb.bloom, *tb.raw_prefilter, tested)
        del h, amb
    elif cfg.strict:
        s1 = cfg.strict_n == 1
        qb, gq = (tb.qbloom_s1, tb.gq1) if s1 else (tb.qbloom_s, tb.gq)
        t16, t16_bits = (tb.t16_1, tb.t16_1_bits) if s1 else (tb.t16, tb.t16_bits)
        A, _, B, _ = unit_regs(u, torch.arange(n_units, device=tile.device) + lead // 8)
        bk = ((A >> 14) | ((B & 0xFF) << 18)) & ((1 << gq) - 1)
        n_items, fe_name, fe, fe_plain = n_units, "front_end", front_end, front_end_plain
        fe_line = "merpcr_tpu/ops/scan.py:504" if s1 else "merpcr_tpu/ops/scan.py:452"
        fe_args = (tile, qb, gq, W, lead, L, n_scan)
    else:
        qb, gq = tb.qbloom, tb.q_bits
        n_items = n_units * (8 // cfg.stride)  # stride groups
        q = torch.arange(n_items, device=tile.device)
        A, Aa, _, Ba = group_regs(u, q, lead // 8, cfg.stride)
        m2kb = mask_bases(W + cfg.stride - 1)
        bk = A & m2kb
        bk = (mul32(bk, GOLD) >> (32 - cfg.qbloom_bits)) if cfg.qbloom_bits else bk & ((1 << gq) - 1)
        if hasattr(tb, "loose_prefilter"):  # (an A/B parent has none)
            fe_kw = {"prefilter": tb.loose_prefilter}
            looked_up = ((valid_phases(Aa, Ba, cfg.stride * q, cfg.stride, W, n_scan) != 0)
                         & ((Aa & m2kb) == 0))
            pre_stats = prefilter_stats(qb, *tb.loose_prefilter, bk[looked_up])
        del A, Aa, Ba, q
        fe_name, fe, fe_plain = "front_end_loose", front_end_loose, front_end_loose_plain
        fe_line = ("merpcr_tpu/ops/scan.py:579" if cfg.stride == 4 else
                   "merpcr_tpu/ops/scan.py:605" if cfg.exact_group else
                   "merpcr_tpu/ops/scan.py:609")
        fe_args = (tile, qb, gq, W, lead, L, n_scan, cfg.stride, cfg.qbloom_bits)
    distinct_words = int(torch.unique(bk >> 5).numel())
    del u, bk
    # per item: the strict unit's decode, smear and key (70); a loose group's
    # key (2; a mult-hash 2 more), valid phase (4), prefilter bit (8) and
    # flag (2), and its share of the unit's decode and clean phases (16 per
    # unit); a raw position as above (14)
    fe_ops = (14 * n_items if raw else 70 * n_items if cfg.strict
              else 16 * n_items + 16 * n_units)
    words, c_t = run(
        fe_name, fe, fe_plain, fe_args, 50,
        (L + W - 1 if raw else 4 * (n_units + 2)) + table_bytes(distinct_words, pre_stats)
        + n_items // 8 + 4, fe_ops, fe_line, lambda o: o, fe_kw,
    )
    c_total = int(c_t.item())
    if fe_kw:  # the same kernel with folds of 2^18 and 2^20 bits, in turns
        # with the table's own (staging against passes)
        from merpcr_tpu_torch.ops.table import fold_bits, prefilter_shift

        res[fe_name]["prefilter"] = pre_stats
        want = fe_plain(*fe_args)
        table = fe_args[1]
        t_bits = (table.numel() * 32).bit_length() - 1
        variants = [(f"2^{fe_kw['prefilter'][1]}", fe_kw)]
        for bits in (18, 20):
            if bits < t_bits:
                sh = 0 if raw else prefilter_shift(t_bits, W, cfg.stride,
                                                   bool(cfg.qbloom_bits), bits)
                pf = (fold_bits(table, sh, bits), bits, sh)
            else:  # the table is its own prefilter
                pf = (table, t_bits, 0)
            variants.append((f"2^{bits}", {"prefilter": pf}))
        folded = {name: [] for name, _ in variants}
        for name, kw in variants * 2:
            check(max_abs_err(fe(*fe_args, **kw), want) == 0,
                  f"{fe_name}[{variant}]: a {name}-bit prefilter differs from plain")
            folded[name].append(profiled_ms(lambda: fe(*fe_args, **kw), 50)[0])
        res[fe_name]["fold_ms"] = folded
    # bucket lookup per expanded position: one 8-byte row, two starts, or
    # a binary search of ceil(log2 U) keys and two starts
    steps = max(1, int(tb.uhash.numel()).bit_length()) if W >= 13 else 0
    pos_b, pos_ops = 4 + 8 + 4 * steps, 6 * steps
    tier = cfg.stride == 2
    if raw:  # a flagged position hashes its W bytes and looks its bucket up
        ex_name, ex, ex_plain = "expand_raw", expand_raw, expand_raw_plain
        ex_args = (tile, words, tb.csr, tb.emeta.shape[0], W, lead, L, n_scan)
        ex_line = "merpcr_tpu/ops/scan.py:965"
        item_b, item_ops = W + pos_b, 6 * W + pos_ops
    elif cfg.strict:
        ex_name, ex, ex_plain = "expand", expand, expand_plain
        ex_args = (tile, words, tb.ptab, tb.pf_bits, t16, t16_bits, tb.csr,
                   tb.emeta.shape[0], W, lead, L, n_scan, cfg.stride,
                   cfg.exact_group, bloom, tb.bloom_bits)
        ex_line = ("merpcr_tpu/ops/scan.py:803" if bloom is not None else
                   "merpcr_tpu/ops/scan.py:944" if s1 else
                   "merpcr_tpu/ops/scan.py:680" if not tier else
                   "merpcr_tpu/ops/scan.py:841" if cfg.exact_group else
                   "merpcr_tpu/ops/scan.py:872")
        item_b = 12 + (4 * (8 // cfg.stride) if cfg.exact_group else 0)
        item_ops = 300 + (120 if bloom is not None else 0)
    else:
        ex_name, ex, ex_plain = "expand_loose", expand_loose, expand_loose_plain
        ex_args = (tile, words, tb.ptab, tb.pf_bits, tb.csr, tb.emeta.shape[0], W,
                   lead, L, n_scan, cfg.stride, cfg.exact_group)
        ex_line = ("merpcr_tpu/ops/scan.py:775" if not tier else
                   "merpcr_tpu/ops/scan.py:863" if cfg.exact_group else
                   "merpcr_tpu/ops/scan.py:731")
        item_b, item_ops = 12 + (4 if cfg.exact_group else 0), 150
    first = ex(*ex_args)
    pos_total, pair_total = first[2], first[3]
    unpruned = None
    if bloom is not None:
        # K10 changes totals, not lines: the tile must hold phases that only
        # the bloom removes, else the comparison below could not tell an
        # expand that skips it from one that applies it
        unpruned = ex(*ex_args[:14], None, ex_args[15])[2]
        check(pos_total < unpruned,
              f"{variant}: bloom removed no position ({pos_total} of {unpruned})")
    entry, ppos, _, _ = run(
        ex_name, ex, ex_plain, ex_args, 20,
        n_items // 8 + c_total * item_b + pos_total * pos_b + pair_total * 8,
        4 * (n_items // 32 if raw else n_items) + item_ops * c_total + pos_ops * pos_total,
        ex_line, lambda o: o,
    )
    v_args = (tile, entry, ppos, tb.emeta, p1c, p1x, t0, rmeta, recmap,
              lead, nmm, x)
    a_idx = run(
        "verify_p1_raw" if raw else "verify_p1", vf, vf_plain, v_args, 20,
        pair_total * (8 + rec_b + 32 + (16 if not raw else p1c.shape[1])
                      + code_b * p1c.shape[1]),
        pair_total * 6 * p1c.shape[1],
        "merpcr_tpu/ops/scan.py:1026" if raw else
        "merpcr_tpu/ops/scan.py:985" if cfg.stream else
        "merpcr_tpu/ops/scan.py:1039" if nmm else "merpcr_tpu/ops/scan.py:979",
        lambda o: (o,),
    )
    anch = a_idx.numel()
    m_args = (tile, a_idx, entry, ppos, tb.emeta, p2c, p2x, t0, rmeta,
              recmap, lead, margin, nmm, x)
    rows = run(
        "margin_p2_raw" if raw else "margin_p2", mf, mf_plain, m_args, 20,
        anch * (4 + 8 + rec_b + 32 + code_b * p2c.shape[1]
                + (2 * margin + cfg.p2_max) // (1 if raw else 2)),
        anch * (2 * margin + 1) * 40,
        "merpcr_tpu/ops/scan.py:1147" if raw else
        "merpcr_tpu/ops/scan.py:1058" if cfg.stream else
        "merpcr_tpu/ops/scan.py:1157" if nmm else
        "merpcr_tpu/ops/scan.py:1201" if margin > 128 else "merpcr_tpu/ops/scan.py:1047",
        lambda o: (o,),
    )
    if hasattr(margin_p2, "launches_deferred"):  # (an A/B parent has no deferred mode)
        # the same three stages in the deferred mode of the tile scan
        # (counts from device memory, buffers of fixed capacity), against
        # their plain versions under the same contract
        fe(*fe_args, **fe_kw)  # leaves the tile's count in the scan state again
        deferred_rows(res, variant, tile, (ex_name, ex_plain, ex_args, c_t, L),
                      (vf_plain, v_args), (mf_plain, m_args), raw,
                      {k: (res[k]["bound_ms"], res[k]["bound_by"], res[k]["replaces"])
                       for k in (ex_name, "verify_p1_raw" if raw else "verify_p1",
                                 "margin_p2_raw" if raw else "margin_p2")})
    past_buffer = None
    if buffer_check and hasattr(margin_mod, "ROW_CAP"):  # (an A/B parent may lack it)
        row_cap = margin_mod.ROW_CAP
        reps = row_cap // max(1, rows.shape[0]) + 2
        many = (tile, a_idx.repeat(reps), *m_args[2:])
        check(reps * rows.shape[0] > row_cap, "the repeated anchors' rows fit the buffer")
        torch.cuda.synchronize()
        c_0 = margin_p2.launches
        t_0 = time.perf_counter()
        got = margin_p2(*many)
        torch.cuda.synchronize()
        t_k = time.perf_counter() - t_0
        n_launch = margin_p2.launches - c_0
        check(n_launch == 2, f"{variant}: {n_launch} margin_p2 launches past the row buffer")
        want = margin_p2_plain(*many)
        check(got.shape[0] == reps * rows.shape[0] and torch.equal(got, want),
              f"{variant}: margin_p2 past its row buffer differs from plain")
        past_buffer = {"anchors": many[1].numel(),
                       "items": many[1].numel() * (2 * margin + 1), "row_buffer": row_cap,
                       "launches": n_launch, "rows": int(got.shape[0]), "wrapper_s": t_k,
                       "equal": True}
    iupac_only = {}
    if cfg.iupac:
        # anchors and hits that only the expansion-set match admits: without
        # them the comparison above could not tell the IUPAC kernels from
        # code-equality ones (at -N 0; a mismatch budget may admit the
        # same sites as mismatches)
        a_eq = vf_plain(*v_args[:5], None, *v_args[6:])
        r_eq = mf_plain(*m_args[:6], None, *m_args[7:])
        iupac_only = {"anch": anch - a_eq.numel(), "hit": int(rows.shape[0] - r_eq.shape[0])}
        if raw:  # the byte modes' -I 0 branch (case-insensitive equality) too
            check(torch.equal(vf(*v_args[:5], None, *v_args[6:]), a_eq)
                  and torch.equal(mf(*m_args[:6], None, *m_args[7:]), r_eq),
                  f"{variant}: -I 0 byte verify differs from plain")
        # (held at W = 11, where the R/Y/N letters are clear of the W-mer)
        check(nmm or W > 11 or min(iupac_only.values()) > 0,
              f"{variant}: no IUPAC-only matches {iupac_only}")
    emit({"phase": phase, "variant": variant or "record", "tile": t, "tile_len": L,
          "card": card, "strict": cfg.strict, "strict_n": cfg.strict_n, "mismatches": nmm,
          "dirty_bloom": cfg.dirty_bloom, "iupac": cfg.iupac,
          "stream": cfg.stream, "packed": cfg.packed, "iupac_only": iupac_only,
          "wordsize": W, "stride": cfg.stride, "exact_group": cfg.exact_group,
          "margin": margin, "margin_past_buffer": past_buffer, "pos_without_bloom": unpruned,
          "totals": {"c": c_total, "pos": pos_total, "pair": pair_total,
                     "anch": anch, "hit": int(rows.shape[0])},
          "kernels": [{k: r.get(k) for k in ("name", "equal", "kernel_ms", "device_ms",
                                             "device_events_lost", "device_ops", "plain_ms",
                                             "max_abs_err", "bound_ms", "prefilter",
                                             "fold_ms", "host_ms")}
                      for r in res.values()]})
    return res


def deferred_rows(res: dict, variant: str, tile, ex, ver, mar, raw: bool, bounds: dict) -> None:
    """Rows of the deferred modes of a tile's expand, verify_p1 and
    margin_p2 (``ops.scan.dispatch_stream``'s stages) into ``res``: each
    against its plain version under the same buffer contract on the same
    card tensors (the five totals, the pairs, anchors and rows within the
    buffers; tolerance 0), CUDA-event and profiler times. The bounds are
    the count-first rows' (the same work)."""
    from merpcr_tpu_torch.ops import expand as ex_mod
    from merpcr_tpu_torch.ops import margin_p2 as m_mod
    from merpcr_tpu_torch.ops import verify_p1 as v_mod

    ex_name, ex_plain, ex_args, c_t, L = ex
    vf_plain, v_args = ver
    mf_plain, m_args = mar
    dev = tile.device
    cap = m_mod.ROW_CAP
    v_name = "verify_p1_raw" if raw else "verify_p1"
    m_name = "margin_p2_raw" if raw else "margin_p2"
    dex, dv, dm = getattr(ex_mod, ex_name), getattr(v_mod, v_name), getattr(m_mod, m_name)
    state = {w: {"tot": torch.zeros(5, dtype=torch.int32, device=dev),
                 "rows": torch.zeros((cap, 6), dtype=torch.int32, device=dev)}
             for w in ("kernel", "plain")}
    k, p = state["kernel"], state["plain"]
    k["e"], k["p"] = dex(*ex_args, totals=k["tot"], c_total=c_t)
    p["e"], p["p"] = ex_mod.deferred_plain(ex_plain(*ex_args), c_t, p["tot"], L)
    tv = v_args[3:]  # emeta, primers, ..., after (tile, entry, ppos)
    tm = m_args[4:]  # emeta, primers, ..., after (tile, a_idx, entry, ppos)
    calls = {
        ex_name: (lambda: dex(*ex_args, totals=k["tot"], c_total=c_t),
                  lambda: ex_mod.deferred_plain(ex_plain(*ex_args), c_t, p["tot"], L)),
        v_name: (lambda: dv(tile, k["e"], k["p"], *tv, totals=k["tot"]),
                 lambda: v_mod.deferred_plain(vf_plain, tile, p["e"], p["p"], p["tot"], *tv)),
        m_name: (lambda: dm(tile, k["a"], k["e"], k["p"], *tm, totals=k["tot"],
                            rows=k["rows"]),
                 lambda: m_mod.deferred_plain(mf_plain, tile, p["a"], p["tot"], p["rows"],
                                              p["e"], p["p"], *tm)),
    }
    k["a"], p["a"] = calls[v_name][0](), calls[v_name][1]()
    calls[m_name][0]()
    calls[m_name][1]()
    tot = p["tot"].tolist()
    pairs, rows = min(tot[2], k["e"].numel()), min(tot[4], cap)
    err = max_abs_err([k["tot"], k["e"][:pairs], k["p"][:pairs], k["a"][: tot[3]],
                       k["rows"][:rows]],
                      [p["tot"], p["e"][:pairs], p["p"][:pairs], p["a"][: tot[3]],
                       p["rows"][:rows]])
    if err:
        raise RuntimeError(f"deferred stages [{variant}]: kernels differ from plain by {err}")
    for name, (call, plain) in calls.items():
        reps = 20
        ms = cuda_ms(call, reps)
        device_ms, lost, ops, split = profiled_ms(call, reps)
        b_ms, b_by, line = bounds[name]
        row = {
            "name": f"{name}_deferred" if not variant else f"{name}_deferred[{variant}]",
            "route": "cuda", "source": f"merpcr_tpu_torch/csrc/{SOURCE_OF[name]}.cu",
            "replaces": line, "equal": True, "max_abs_err": 0, "ms": ms, "kernel_ms": ms,
            "host_ms": host_ms(call, reps), "device_ms": device_ms,
            "device_events_lost": lost, "device_ops": ops, "device_split": split,
            "plain_ms": cuda_ms(plain, 4), "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "prefilter": None, "totals": tot,
            "capacity": k["e"].numel() if name != m_name else cap,
        }
        check(PKG != ROOT or ops <= DEVICE_OPS_MAX[f"{name}_deferred"],
              f"{name}_deferred[{variant}]: {ops} device operations per call")
        res[f"{name}_deferred"] = row


def breakdown(eng, recs) -> dict:
    """Host-clock time of each step of one record's first search (the
    steps a warm search takes from the engine's cache: dirty rate, plane,
    upload), the deferred tile scan of its plane with its host reads, and
    device time by kernel name from torch.profiler over that scan."""
    from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes
    from merpcr_tpu_torch.ops.scan import collect_stream, dispatch_stream, record_rmeta

    rec = recs[0]
    t0 = time.perf_counter()
    seq = record_seq_bytes(rec)
    t_bytes = time.perf_counter() - t0
    packed = record_packed(rec)
    n = len(seq)
    total = n - eng.wordsize + 1
    cfg = eng._base_config(eng._pick_tile_len(total), packed=packed is not None)
    out = {"wordsize": eng.wordsize, "margin": eng.margin, "mismatches": eng.mismatches,
           "iupac": cfg.iupac, "strict": cfg.strict, "packed": cfg.packed,
           "seq_bytes_s": t_bytes, "dirty_rate_s": None}
    if cfg.strict:  # the loose path takes no dirty-rate sample
        t0 = time.perf_counter()
        eng._dirty_of(seq, packed)
        out["dirty_rate_s"] = time.perf_counter() - t0
    n_tiles = -(-total // cfg.tile_len)
    t0 = time.perf_counter()
    plane_np = eng._plane(seq if packed is None else packed,
                          cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead,
                          packed=packed is not None)
    out["plane_bytes"] = int(plane_np.nbytes)
    out["plane_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    plane = torch.from_numpy(plane_np).to(eng.device)
    rmeta = record_rmeta(n, eng.device)
    torch.cuda.synchronize()
    out["upload_s"] = time.perf_counter() - t0
    reads = READS[0]

    def scan():
        collect_stream(dispatch_stream(cfg, eng._table, plane, total, n, rmeta, None,
                                       eng._runtime_params(), n_tiles))
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    scan()
    out["scan_tiles_s"] = time.perf_counter() - t0
    out["host_reads_per_scan"] = READS[0] - reads
    dev = device_time(scan)
    busy = sum(v[0] for v in dev.values())
    out["device_busy_s"] = busy if dev else None
    # against the unprofiled scan of the same tiles
    out["device_idle_share"] = (1 - busy / out["scan_tiles_s"]) if dev else None
    out["device_by_name"] = {
        k.replace("(anonymous namespace)::", "").split("(")[0]: {
            "device_s": v[0], "count": v[1]}
        for k, v in dev.items()
    }
    if cfg.strict:
        out["front_end_l2_window_ms"] = l2_window_ms(
            eng._table.qbloom_s1 if cfg.strict_n == 1 else eng._table.qbloom_s, scan)
    return out


def set_l2_window(ptr: int, n_bytes: int) -> None:
    """Set (n_bytes > 0) or clear the persisting L2 access-policy window of
    the current CUDA stream over n_bytes at ptr, through the CUDA driver API
    (cuCtxSetLimit, cuStreamSetAttribute); clearing also gives the L2
    set-aside back, so later phases see the whole cache."""
    import ctypes

    class Window(ctypes.Structure):  # CUaccessPolicyWindow
        _fields_ = [("base_ptr", ctypes.c_void_p), ("num_bytes", ctypes.c_size_t),
                    ("hit_ratio", ctypes.c_float), ("hit_prop", ctypes.c_int),
                    ("miss_prop", ctypes.c_int)]

    cu = ctypes.CDLL("libcuda.so.1")
    if not n_bytes:
        cu.cuCtxResetPersistingL2Cache()
    rc = cu.cuCtxSetLimit(ctypes.c_int(6), ctypes.c_size_t(n_bytes))  # persisting L2 bytes
    check(rc == 0, f"cuCtxSetLimit: CUresult {rc}")
    value = (ctypes.c_char * 64)()  # CUstreamAttrValue, a union
    w = Window.from_buffer(value)
    w.base_ptr, w.num_bytes = (ptr, n_bytes) if n_bytes else (None, 0)
    # persisting hits, streaming misses (CU_ACCESS_PROPERTY_*); normal: cleared
    w.hit_ratio, w.hit_prop, w.miss_prop = (1.0, 2, 1) if n_bytes else (0.0, 0, 0)
    rc = cu.cuStreamSetAttribute(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),
                                 ctypes.c_int(1), value)  # ..._ACCESS_POLICY_WINDOW
    check(rc == 0, f"cuStreamSetAttribute: CUresult {rc}")


def l2_window_ms(table, scan) -> dict:
    """Device ms of the strict front end over one warm tile scan, without
    and with a persisting L2 access-policy window over its table on the
    stream, in turns: the window that would keep the table in L2 across
    tiles."""
    got = {"off": [], "on": []}
    try:
        for on in (False, True, True, False):
            set_l2_window(table.data_ptr(), table.numel() * 4 if on else 0)
            dev = device_time(scan)
            got["on" if on else "off"].append(
                sum(t for k, (t, _) in dev.items() if "front_end_kernel" in k) * 1e3)
    except RuntimeError as e:  # a CUDA driver without the window
        got["error"] = str(e)[:200]
    try:
        set_l2_window(0, 0)
    except RuntimeError as e:
        got["error_clearing"] = str(e)[:200]
    return got


def stream_breakdown(eng, recs) -> dict:
    """Host-clock time of each step of one warm stream search (the layout
    and the run's dirty rate from the engine's cache, and afresh), and
    device busy time over its plane's deferred scan from torch.profiler."""
    out = {}
    t0 = time.perf_counter()
    (_, _, items), = eng._plan(recs)
    out["plan_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._stream_geometry(items)  # layout and dirty rate, cached
    out["layout_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng._run_dirty_pos(items)  # what the first search of the run pays
    out["run_dirty_rate_s"] = time.perf_counter() - t0
    reads = READS[0]

    def scan():
        eng._collect(eng._dispatch_stream(items), len(items))  # the cached plane
        torch.cuda.synchronize()

    scan()  # warm
    t0 = time.perf_counter()
    scan()
    out["scan_plane_s"] = time.perf_counter() - t0
    out["host_reads_per_scan"] = (READS[0] - reads) / 2
    dev = device_time(scan)
    busy = sum(v[0] for v in dev.values())
    out["device_busy_s"] = busy if dev else None
    out["device_idle_share"] = (1 - busy / out["scan_plane_s"]) if dev else None
    out["tiles"] = eng.last_scans[-1].tiles
    out["device_by_name"] = {
        k.replace("(anonymous namespace)::", "").split("(")[0]: {
            "device_s": v[0], "count": v[1]}
        for k, v in dev.items()
    }
    return out


def phase_assembly(MerPCR, wrappers, sts, fa, iupac: int, expect, absent,
                   n_bp: int, card: str, variant: str, want_bloom: bool,
                   mismatches: int = 0, wordsize: int = 11):
    """One assembly variant end to end on the card (cold, then warm with
    the launch counts read around it) and against device="cpu": every line
    of ``expect`` present, none of ``absent``. -N 0 scans strict, -N 2
    loose."""
    eng = MerPCR(wordsize=wordsize, iupac_mode=iupac, mismatches=mismatches)
    t0 = time.perf_counter()
    check(eng.load_sts_file(sts), "STS load failed")
    t_table = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = eng.load_fasta_file(fa)
    t_fasta = time.perf_counter() - t0
    check(len(recs) == ASM_RECORDS, f"{len(recs)} records")
    cold, hits_cold, t_cold = search_bytes(eng, recs)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    warm, hits, t_warm = search_bytes(eng, recs)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    check(warm == cold and hits == hits_cold, f"{variant}: warm search differs from cold")
    (cfg, n_tiles, n_rec), = eng.last_scans
    check(cfg.stream and n_rec == ASM_RECORDS, f"{variant}: not one stream plane: {eng.last_scans}")
    check(cfg.strict == (mismatches == 0), f"{variant}: strict {cfg.strict}")
    check(cfg.dirty_bloom == want_bloom, f"{variant}: dirty_bloom {cfg.dirty_bloom}")
    check(cfg.iupac == bool(iupac), f"{variant}: iupac {cfg.iupac}")
    check((cfg.stride, cfg.exact_group) == tier_of(wordsize), f"{variant}: tier of {cfg}")
    used = path_wrappers(cfg)
    check(all((0 < v <= n_tiles) == (k in used) for k, v in launches.items()),
          f"{variant}: launches {launches} for {n_tiles} stream tiles")
    lines = set(warm.splitlines())
    missing = [e for e in expect if e not in lines]
    check(not missing, f"{variant}: {len(missing)} planted lines missing, e.g. {missing[:3]}")
    found = [e for e in absent if e in lines]
    check(not found, f"{variant}: R/Y/N-primer lines found at -I 0, e.g. {found[:3]}")
    cpu = MerPCR(device="cpu", wordsize=wordsize, iupac_mode=iupac, mismatches=mismatches)
    check(cpu.load_sts_file(sts), "STS load failed (cpu)")
    cpu_out, _, t_cpu = search_bytes(cpu, recs)
    check(cpu_out == warm, f"{variant}: card output differs from the CPU (plain) output")
    emit({"phase": "assembly", "variant": variant, "card": card, "bases": n_bp,
          "wordsize": wordsize,
          "records": ASM_RECORDS, "iupac": iupac, "mismatches": mismatches,
          "strict": cfg.strict, "dirty_bloom": cfg.dirty_bloom,
          "stream_tiles": n_tiles, "tile_len": cfg.tile_len, "hits": hits,
          "planted_found": len(expect), "planted_absent": len(absent),
          "cold_s": t_cold, "warm_s": t_warm,
          "warm_mbp_per_s": n_bp / 1e6 / t_warm, "cpu_plain_s": t_cpu,
          "table_compile_s": t_table, "fasta_load_s": t_fasta,
          "peak_mem_bytes": peak, "launches": launches, "equal_to_cpu": True})
    return eng, recs, launches, warm


RNA_EVERY = 100  # variant (e): every 100th scaffold rendered as RNA


def phase_assembly_rna(MerPCR, wrappers, sts, fa, want: str, n_bp: int,
                       card: str) -> dict:
    """Variant (e): variant (c) (1 % IUPAC, -I 1) with every RNA_EVERY-th
    scaffold rendered as RNA (T -> U). Each rendered scaffold takes the
    raw-byte path alone and ends a stream run, the others the stream path:
    cold then warm on the card, launch counts around the warm run (the raw
    front end and expansion once per rendered scaffold, the stream
    kernels at most once per stream tile), and the lines equal to variant
    (c)'s ``want``. Returns the warm launches."""
    from merpcr_tpu_torch.models import FASTARecord

    eng = MerPCR(iupac_mode=1)
    check(eng.load_sts_file(sts), "STS load failed")
    recs = eng.load_fasta_file(fa)
    n_raw = 0
    for r in range(0, len(recs), RNA_EVERY):
        recs[r] = FASTARecord(defline=recs[r].defline, sequence=rna(recs[r].sequence))
        n_raw += 1
    cold, hits_cold, t_cold = search_bytes(eng, recs)
    for w in wrappers.values():
        w.launches = 0
    warm, hits, t_warm = search_bytes(eng, recs)
    launches = {k: w.launches for k, w in wrappers.items()}
    check(warm == cold and hits == hits_cold, "e: warm search differs from cold")
    raw = [(c, t) for c, t, _ in eng.last_scans if not c.packed]
    streams = [(c, t, k) for c, t, k in eng.last_scans if c.packed]
    check(len(raw) == n_raw and all(t == 1 for _, t in raw), f"e: raw scans {raw[:3]}")
    check(all(c.stream and c.strict and c.dirty_bloom and c.iupac for c, _, _ in streams)
          and sum(k for _, _, k in streams) == ASM_RECORDS - n_raw,
          f"e: stream scans {[(t, k) for _, t, k in streams]}")
    tiles = sum(t for _, t, _ in streams)
    want_n = {**{k: (n_raw, n_raw) for k in RAW_WRAPPERS},
              **{k: (1, tiles) for k in path_wrappers(streams[0][0])}}
    check(all(want_n.get(k, (0, 0))[0] <= v <= want_n.get(k, (0, 0))[1]
              for k, v in launches.items()),
          f"e: launches {launches} for {n_raw} RNA scaffolds, {tiles} stream tiles")
    check(warm == want, "e: lines differ from variant (c)'s")
    emit({"phase": "assembly", "variant": "e_dirty_I1_rna", "card": card, "bases": n_bp,
          "records": ASM_RECORDS, "rna_records": n_raw, "stream_planes": len(streams),
          "stream_tiles": tiles, "iupac": 1, "hits": hits, "cold_s": t_cold,
          "warm_s": t_warm, "warm_mbp_per_s": n_bp / 1e6 / t_warm,
          "launches": launches, "equal_to_c": True})
    return launches


def tier_of(wordsize: int) -> tuple:
    """(stride, exact_group) of the tables the compiler builds at a word
    size (``ops/table.py``: stride 4 while 4^(W+3) group bits fit 2^28)."""
    return (4 if wordsize <= 11 else 2, wordsize <= 13)


def path_wrappers(cfg) -> tuple:
    """The wrappers a scan with ``cfg`` launches (one each per tile, and a
    count-first rerun of a tile past a buffer launches its front end
    again)."""
    if not cfg.packed:
        return RAW_WRAPPERS
    if cfg.strict:
        return WRAPPERS
    return ("front_end_loose", "expand_loose_deferred", "verify_p1_deferred",
            "margin_p2_deferred")


def timed_search(eng, recs, wrappers, what: str) -> tuple:
    """Cold then warm search on the card with the launch counts read
    around the warm run, which must launch the path's wrappers once per
    tile and no others. Returns (output, hits, cold s, warm s, launches,
    cfg, tiles)."""
    cold, hits_cold, t_cold = search_bytes(eng, recs)
    for w in wrappers.values():
        w.launches = 0
    warm, hits, t_warm = search_bytes(eng, recs)
    launches = {k: w.launches for k, w in wrappers.items()}
    check(warm == cold and hits == hits_cold, f"{what}: warm search differs from cold")
    (cfg, n_tiles, _), = eng.last_scans
    used = path_wrappers(cfg)
    check(all(v == (n_tiles if k in used else 0) for k, v in launches.items()),
          f"{what}: launches {launches} for {n_tiles} tiles")
    return warm, hits, t_cold, t_warm, launches, cfg, n_tiles


def phase_mismatch(MerPCR, eng, recs, wrappers, expect, mism, n: int, card: str,
                   sts: str) -> dict:
    """The 47 Mbp record at -N 1 (strict1) and -N 2 (loose) in the
    engine that ran -N 0: per budget, cold then warm on the card (launch
    counts read around the warm run), which path ran, the planted k-
    mismatch lines present exactly at -N >= k, every exact plant present,
    bytes equal to device="cpu"; then the path's kernels against their
    plain versions on one real 2^23 tile. Returns {N: (kernel entries,
    warm launches)}."""
    out = {}
    for n_mm in (1, 2):
        eng.mismatches = n_mm
        warm, hits, t_cold, t_warm, launches, cfg, n_tiles = timed_search(
            eng, recs, wrappers, f"-N {n_mm}")
        check((cfg.strict, cfg.strict_n) == ((True, 1) if n_mm == 1 else (False, 0)),
              f"-N {n_mm}: ran strict={cfg.strict} strict_n={cfg.strict_n}")
        lines = set(warm.splitlines())
        for k, want in ((0, expect), *mism.items()):
            got = sum(line in lines for line in want)
            check(got == (len(want) if k <= n_mm else 0),
                  f"-N {n_mm}: {got} of {len(want)} {k}-mismatch lines present")
        cpu = MerPCR(device="cpu", mismatches=n_mm)
        check(cpu.load_sts_file(sts), "STS load failed (cpu)")
        cpu_out, _, t_cpu = search_bytes(cpu, recs)
        check(cpu_out == warm, f"-N {n_mm}: card output differs from the CPU (plain) output")
        emit({"phase": "mismatch", "mismatches": n_mm, "card": card, "genome_bp": n,
              "strict": cfg.strict, "strict_n": cfg.strict_n, "tiles": n_tiles,
              "strict1_armed": bool(eng._meta.strict1), "hits": hits,
              "planted_found": {k: sum(line in lines for line in want)
                                for k, want in ((0, expect), *mism.items())},
              "cold_s": t_cold, "warm_s": t_warm, "warm_mbp_per_s": n / 1e6 / t_warm,
              "cpu_plain_s": t_cpu, "launches": launches, "equal_to_cpu": True})
        emit({"phase": "breakdown", "card": card, **breakdown(eng, recs)})
        kern = phase_kernels(eng, record_tile(eng, recs), card, "mismatch_kernels",
                             "strict1" if cfg.strict else f"N{n_mm}")
        out[n_mm] = (kern, launches)
    eng.mismatches = 0
    return out


def phase_wordsize(MerPCR, recs, wrappers, expect, n: int, card: str, sts: str) -> list:
    """The 47 Mbp record at W = 12, 13, 14, 16, a fresh engine each: -N 0
    (strict) and -N 2 (loose), cold then warm; the tier the word size
    selects; all exact plants present; bytes equal to device="cpu"; then
    the kernels of both paths against their plain versions on one real
    tile. Returns [(kernel entries, warm launches)]."""
    out = []
    for W in (12, 13, 14, 16):
        eng = MerPCR(wordsize=W)
        t0 = time.perf_counter()
        check(eng.load_sts_file(sts), f"STS load failed at W={W}")
        t_table = time.perf_counter() - t0
        cpu = MerPCR(device="cpu", wordsize=W)
        check(cpu.load_sts_file(sts), "STS load failed (cpu)")
        for n_mm in (0, 2):
            eng.mismatches = cpu.mismatches = n_mm
            what = f"W={W} -N {n_mm}"
            torch.cuda.reset_peak_memory_stats()
            warm, hits, t_cold, t_warm, launches, cfg, n_tiles = timed_search(
                eng, recs, wrappers, what)
            check(cfg.strict == (n_mm == 0) and (cfg.stride, cfg.exact_group) == tier_of(W),
                  f"{what}: ran {cfg}")
            lines = set(warm.splitlines())
            missing = [e for e in expect if e not in lines]
            check(not missing, f"{what}: {len(missing)} planted lines missing, e.g. {missing[:3]}")
            cpu_out, _, t_cpu = search_bytes(cpu, recs)
            check(cpu_out == warm, f"{what}: card output differs from the CPU (plain) output")
            emit({"phase": "wordsize", "wordsize": W, "mismatches": n_mm, "card": card,
                  "genome_bp": n, "strict": cfg.strict, "stride": cfg.stride,
                  "exact_group": cfg.exact_group, "qbloom_bits": cfg.qbloom_bits,
                  "tiles": n_tiles, "hits": hits, "planted_found": len(expect),
                  "cold_s": t_cold, "warm_s": t_warm, "warm_mbp_per_s": n / 1e6 / t_warm,
                  "cpu_plain_s": t_cpu, "table_compile_s": t_table,
                  "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                  "launches": launches, "equal_to_cpu": True})
            emit({"phase": "breakdown", "card": card, **breakdown(eng, recs)})
            kern = phase_kernels(eng, record_tile(eng, recs), card, "wordsize_kernels",
                                 f"W{W}" if cfg.strict else f"W{W}+N{n_mm}")
            out.append((kern, launches))
        del eng, cpu
    return out


def phase_margin(MerPCR, recs, wrappers, expect, off_size, n: int, card: str,
                 sts: str) -> list:
    """The 47 Mbp record at W = 11, -N 0, at -M 1000 and -M 10000, cold
    then warm: each off-size plant present exactly when |delta| <= M; bytes
    equal to device="cpu"; the path's kernels against their plain versions
    on one real tile, at -M 10000 also past margin_p2's row buffer.
    Returns [(kernel entries, warm launches)]."""
    out = []
    for margin in (1000, 10000):
        eng = MerPCR(margin=margin)
        check(eng.load_sts_file(sts), "STS load failed")
        what = f"-M {margin}"
        warm, hits, t_cold, t_warm, launches, cfg, n_tiles = timed_search(
            eng, recs, wrappers, what)
        lines = set(warm.splitlines())
        missing = [e for e in expect if e not in lines]
        check(not missing, f"{what}: {len(missing)} planted lines missing, e.g. {missing[:3]}")
        found = {d: sum(line in lines for line in want) for d, want in off_size.items()}
        check(all(found[d] == (len(want) if abs(d) <= margin else 0)
                  for d, want in off_size.items()), f"{what}: off-size lines {found}")
        cpu = MerPCR(device="cpu", margin=margin)
        check(cpu.load_sts_file(sts), "STS load failed (cpu)")
        cpu_out, _, t_cpu = search_bytes(cpu, recs)
        check(cpu_out == warm, f"{what}: card output differs from the CPU (plain) output")
        emit({"phase": "margin", "margin": margin, "margin_cap": cfg.margin, "card": card,
              "genome_bp": n, "lead": cfg.lead, "tail": cfg.tail, "tiles": n_tiles,
              "hits": hits, "planted_found": len(expect), "off_size_found": found,
              "cold_s": t_cold, "warm_s": t_warm, "warm_mbp_per_s": n / 1e6 / t_warm,
              "cpu_plain_s": t_cpu, "launches": launches, "equal_to_cpu": True})
        emit({"phase": "breakdown", "card": card, **breakdown(eng, recs)})
        kern = phase_kernels(eng, record_tile(eng, recs), card, "margin_kernels",
                             f"M{margin}", buffer_check=margin == 10000)
        out.append((kern, launches))
        del eng, cpu
    return out


def raw_tile(eng, rec):
    """(cfg, card plane, tile index, scan positions, rmeta, recmap) of a
    raw-byte record's plane (one byte per position): tile 1 of 2^23."""
    from merpcr_tpu_torch.io.fasta import record_seq_bytes
    from merpcr_tpu_torch.ops.scan import record_rmeta

    seq = record_seq_bytes(rec)
    n = len(seq)
    total = n - eng.wordsize + 1
    cfg = eng._base_config(eng._pick_tile_len(total), packed=False)
    check(cfg.tile_len == TILE and not cfg.packed, f"raw tile {cfg}")
    n_tiles = -(-total // cfg.tile_len)
    plane = eng._plane(seq, cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead,
                       packed=False)
    return (cfg, torch.from_numpy(plane).to(eng.device), 1, total,
            record_rmeta(n, eng.device), None)


RNA_JUNK = "-*.0123456789\u00e9ZE\u00ff"  # bytes outside the 16-letter alphabet
JUNK_EVERY = 10_007


def rna(seq: str) -> str:
    """The RNA rendering of a DNA record: every T a U."""
    return seq.replace("T", "U").replace("t", "u")


def with_junk(seq: str, lines) -> tuple:
    """``seq`` with one byte of RNA_JUNK about every 10 kb, none inside an
    amplicon of ``lines`` (hit lines of that record) or within 50 bases of
    one. Returns (sequence, junk bytes placed)."""
    spans = sorted((int(a) - 51, int(b) + 50) for a, b in
                   (ln.split("\t")[1].split("..") for ln in lines))
    chars = list(seq)
    placed, k = 0, 0
    for pos in range(JUNK_EVERY // 2, len(chars), JUNK_EVERY):
        k = next((j for j in range(k, len(spans)) if spans[j][1] >= pos), len(spans))
        if k < len(spans) and spans[k][0] <= pos:
            continue
        chars[pos] = RNA_JUNK[placed % len(RNA_JUNK)]
        placed += 1
    return "".join(chars), placed


def phase_raw(MerPCR, recs, wrappers, expect, mism, off_size, n: int, card: str,
              sts: str) -> tuple:
    """The 47 Mbp record rendered as RNA (T -> U, the reverse-strand plants
    too) and passed through the API as a FASTARecord: records outside the
    16-letter alphabet take the raw-byte path (K9). At -I 1: -N 0 prints
    the DNA record's -I 1 bytes and all planted lines; -N 2 the 1- and
    2-mismatch plants; W = 13 and 14 every exact plant; -M 1000 each
    off-size plant exactly when the margin admits it. Then a rendering
    with a junk byte about every 10 kb outside the amplicons: every planted
    line, bytes equal to device="cpu". Then the raw kernels against their
    plain versions on tile 1 (phase raw_kernels). Returns (kernel entries,
    launches of the warm -N 0 search)."""
    from merpcr_tpu_torch.models import FASTARecord

    t0 = time.perf_counter()
    rec = FASTARecord(defline=recs[0].defline, sequence=rna(recs[0].sequence))
    t_render = time.perf_counter() - t0
    eng = MerPCR(iupac_mode=1)
    check(eng.load_sts_file(sts), "STS load failed (-I 1)")
    dna, _, t_dna = search_bytes(eng, recs)
    check(eng.last_scans[0][0].packed, "the DNA record did not scan packed")

    def run(engine, what):
        warm, hits, t_cold, t_warm, launches, cfg, n_tiles = timed_search(
            engine, [rec], wrappers, what)
        check(not cfg.packed and not cfg.strict and not cfg.dirty_bloom and cfg.iupac,
              f"{what}: ran {cfg}")
        lines = set(warm.splitlines())
        missing = [e for e in expect if e not in lines]
        check(not missing, f"{what}: {len(missing)} planted lines missing, e.g. {missing[:3]}")
        emit({"phase": "raw", "variant": what, "card": card, "genome_bp": n,
              "wordsize": engine.wordsize, "margin": engine.margin,
              "mismatches": engine.mismatches, "iupac": 1, "tiles": n_tiles, "hits": hits,
              "planted_found": len(expect), "cold_s": t_cold, "warm_s": t_warm,
              "warm_mbp_per_s": n / 1e6 / t_warm, "launches": launches})
        return warm, lines, launches

    warm, lines, launches = run(eng, "rna_I1_N0")
    check(warm == dna, "RNA -I 1 output differs from the DNA record's -I 1 output")
    found = [e for k in mism for e in mism[k] if e in lines]
    check(not found, f"RNA -N 0 found {len(found)} mismatch lines, e.g. {found[:3]}")
    emit({"phase": "raw", "variant": "rna_equals_dna", "card": card, "equal": True,
          "dna_search_s": t_dna, "render_s": t_render})
    emit({"phase": "breakdown", "card": card, **breakdown(eng, [rec])})
    kern = phase_kernels(eng, raw_tile(eng, rec), card, "raw_kernels", "raw+iupac")

    eng.mismatches = 2
    _, lines, _ = run(eng, "rna_I1_N2")
    for k, want in mism.items():
        got = sum(line in lines for line in want)
        check(got == len(want), f"RNA -N 2: {got} of {len(want)} {k}-mismatch lines present")
    eng.mismatches = 0
    for W in (13, 14):
        e_w = MerPCR(wordsize=W, iupac_mode=1)
        check(e_w.load_sts_file(sts), f"STS load failed at W={W}")
        run(e_w, f"rna_I1_W{W}")
        del e_w
    e_m = MerPCR(margin=1000, iupac_mode=1)
    check(e_m.load_sts_file(sts), "STS load failed (-M 1000)")
    _, lines, _ = run(e_m, "rna_I1_M1000")
    found = {d: sum(line in lines for line in want) for d, want in off_size.items()}
    check(all(found[d] == (len(want) if abs(d) <= 1000 else 0)
              for d, want in off_size.items()), f"RNA -M 1000: off-size lines {found}")
    del e_m

    junk, placed = with_junk(rec.sequence, [*expect, *(e for v in mism.values() for e in v),
                                            *(e for v in off_size.values() for e in v)])
    jrec = FASTARecord(defline=recs[0].defline, sequence=junk)
    card_out, hits, t_card = search_bytes(eng, [jrec])
    lines = set(card_out.splitlines())
    missing = [e for e in expect if e not in lines]
    check(not missing, f"junk rendering: {len(missing)} planted lines missing")
    cpu = MerPCR(device="cpu", iupac_mode=1)
    check(cpu.load_sts_file(sts), "STS load failed (cpu)")
    cpu_out, _, t_cpu = search_bytes(cpu, [jrec])
    check(cpu_out == card_out, "junk rendering: card output differs from the CPU output")
    emit({"phase": "raw", "variant": "rna_junk_I1", "card": card, "junk_bytes": placed,
          "hits": hits, "planted_found": len(expect), "card_s": t_card,
          "cpu_plain_s": t_cpu, "equal_to_cpu": True})
    return kern, launches


SHARD_COUNTS = (2, 4)  # shards on the one card (overhead, not scaling)
GATHER_LOG = "gather: "  # the rank-0 log line of parallel.distributed.gather_tiles


def sharded_search(MerPCR, recs, wrappers, sts: str, shards: int, what: str,
                   **params) -> dict:
    """One search of ``recs`` on ``shards`` shards of cuda:0 (1: no mesh),
    cold then warm, launch counts read around the warm run: the path's
    four wrappers once per global tile (padding tiles included: the
    deferred scan reads no count on the host, so a padding tile's verify
    and margin launch and find no pair), no other wrapper. Returns the
    warm output and figures."""
    from merpcr_tpu_torch.parallel import make_mesh

    eng = MerPCR(**params)
    if shards > 1:
        eng.use_mesh(make_mesh(("cuda:0",) * shards))
    check(eng.load_sts_file(sts), "STS load failed")
    cold, hits_cold, t_cold = search_bytes(eng, recs)
    for w in wrappers.values():
        w.launches = 0
    warm, hits, t_warm = search_bytes(eng, recs)
    launches = {k: w.launches for k, w in wrappers.items()}
    check(warm == cold and hits == hits_cold, f"{what}: warm search differs from cold")
    (scan,) = eng.last_scans
    cfg, n_tiles = scan.cfg, scan.tiles
    n_global = shards * -(-n_tiles // shards)
    check(scan.shards == shards, f"{what}: last_scans shows {scan.shards} shards")
    used = path_wrappers(cfg)
    check(all(v == (n_global if k in used else 0) for k, v in launches.items()),
          f"{what}: launches {launches} for {n_tiles} tiles, {n_global} global")
    return {"out": warm, "hits": hits, "cold_s": t_cold, "warm_s": t_warm,
            "launches": launches, "tiles": n_tiles, "global_tiles": n_global,
            "last_scans_shards": scan.shards, "cfg": cfg}


def host_copy_bytes_per_s() -> float:
    """This host's memcpy rate: the best of five copies of 256 MiB."""
    src = np.ones(1 << 28, dtype=np.uint8)
    dst = np.empty_like(src)
    best = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(dst, src)
        best = min(best, time.perf_counter() - t0)
    return src.nbytes / best


def two_process_search(sts: str, fa: str, want: str) -> dict:
    """``python -m merpcr_tpu_torch --multihost`` as two ranks of one gloo
    group, both on cuda:0 (launcher environment, loopback rendezvous):
    rank 0 prints ``want``, rank 1 nothing, both exit 0 and log the same
    hit count. Returns the rank-0 gather's figures from its log."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    for r in (0, 1):
        # both ranks on this host: gloo's sockets on the loopback device
        env = {"GLOO_SOCKET_IFNAME": "lo", **os.environ, "RANK": str(r),
               "LOCAL_RANK": str(r), "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
               "MASTER_PORT": str(port)}
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "merpcr_tpu_torch", sts, fa, "--multihost", "-Q", "0"],
            cwd=PKG, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    t0 = time.perf_counter()
    try:
        res = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    seconds = time.perf_counter() - t0
    for r, (p, (_, err)) in enumerate(zip(procs, res)):
        check(p.returncode == 0, f"rank {r} rc={p.returncode} err={err[-3000:]}")
    check(res[0][0] == want, "rank 0's output differs from the single-device output")
    check(res[1][0] == "", f"rank 1 printed {res[1][0][:200]!r}")
    found = [[ln for ln in err.splitlines() if "Search complete" in ln] for _, err in res]
    counts = [ln[-1].split("Search complete: ")[1] for ln in found]
    check(counts[0] == counts[1] == f"{want.count(chr(10))} hits found",
          f"hit counts {counts}")
    gathers = [ln.split(GATHER_LOG)[1] for ln in res[0][1].splitlines() if GATHER_LOG in ln]
    check(len(gathers) == 1, f"rank 0 logged {len(gathers)} gathers")
    f = dict(kv.split("=") for kv in gathers[0].split())  # tiles= rows= bytes= ms= rows_ms=
    return {"seconds": seconds, "gather_tiles": int(f["tiles"]),
            "gather_rows": int(f["rows"]), "gather_bytes": int(f["bytes"]),
            "gather_ms": float(f["ms"]), "gather_rows_ms": float(f["rows_ms"])}


def phase_sharded(MerPCR, recs, wrappers, sts: str, fa: str, want_n0: str,
                  a_sts: str, a_fa: str, want_c: str, n: int, a_bp: int, card: str) -> dict:
    """Phase 13: the sharded search (K15) on the one card. The 47 Mbp
    record at -N 0 and -N 2 on 1, 2 and 4 shards of cuda:0, assembly (c)
    on 2: bytes equal to the single-device output; the per-global-tile
    outputs of one sharded record plane on the card against the same call
    on the CPU (plain versions, padding tiles included); two processes of
    the CLI under --multihost. Returns the summary."""
    from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes
    from merpcr_tpu_torch.parallel import make_mesh
    from merpcr_tpu_torch.parallel.sharded import sharded_scan_record

    warm_s = {}
    for n_mm in (0, 2):
        base = None
        for shards in (1, *SHARD_COUNTS):
            r = sharded_search(MerPCR, recs, wrappers, sts, shards,
                               f"47 Mbp -N {n_mm} on {shards} shards", mismatches=n_mm)
            base = base or r["out"]
            check(r["out"] == base, f"-N {n_mm}: {shards} shards differ from one device")
            check(n_mm or r["out"] == want_n0, "-N 0: differs from phase 5's output")
            warm_s[f"N{n_mm}_{shards}"] = r["warm_s"]
            emit({"phase": "sharded", "run": f"record_N{n_mm}", "card": card,
                  "genome_bp": n, "shards": shards, "strict": r["cfg"].strict,
                  "tiles": r["tiles"], "global_tiles": r["global_tiles"],
                  "last_scans_shards": r["last_scans_shards"], "hits": r["hits"],
                  "cold_s": r["cold_s"], "warm_s": r["warm_s"],
                  "warm_mbp_per_s": n / 1e6 / r["warm_s"], "launches": r["launches"],
                  "equal_to_one_device": True})
    a_recs = MerPCR(device="cpu").load_fasta_file(a_fa)
    for shards in (1, 2):
        r = sharded_search(MerPCR, a_recs, wrappers, a_sts, shards,
                           f"assembly (c) on {shards} shards", iupac_mode=1)
        check(r["out"] == want_c, f"assembly (c) on {shards} shards differs from phase 11")
        warm_s[f"asm_c_{shards}"] = r["warm_s"]
        emit({"phase": "sharded", "run": "assembly_c", "card": card, "bases": a_bp,
              "shards": shards, "stream": r["cfg"].stream, "tiles": r["tiles"],
              "global_tiles": r["global_tiles"], "last_scans_shards": r["last_scans_shards"],
              "hits": r["hits"], "cold_s": r["cold_s"], "warm_s": r["warm_s"],
              "warm_mbp_per_s": a_bp / 1e6 / r["warm_s"], "launches": r["launches"],
              "equal_to_one_device": True})
    del a_recs

    # K15 against its plain version: one sharded plane, per global tile
    eng = MerPCR()
    check(eng.load_sts_file(sts), "STS load failed")
    seq, packed = record_seq_bytes(recs[0]), record_packed(recs[0])
    total = len(seq) - eng.wordsize + 1
    cfg = eng._base_config(eng._pick_tile_len(total))
    rt = eng._runtime_params()
    shards = SHARD_COUNTS[-1]
    t0 = time.perf_counter()
    card_outs = sharded_scan_record(cfg, eng._table, seq, eng.wordsize,
                                    make_mesh(("cuda:0",) * shards), rt, packed_rec=packed)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_outs = sharded_scan_record(cfg, eng._table, seq, eng.wordsize,
                                   make_mesh(("cpu",) * shards), rt, packed_rec=packed)
    t_cpu = time.perf_counter() - t0
    n_real = -(-total // cfg.tile_len)
    check(len(card_outs) == len(cpu_outs) == shards * -(-n_real // shards),
          f"{len(card_outs)} card tiles, {len(cpu_outs)} CPU tiles")
    err = max(max_abs_err([v.cpu() if isinstance(v, torch.Tensor) else v for v in a], b)
              for a, b in zip(card_outs, cpu_outs))
    check(err == 0, f"sharded tiles differ from the plain versions by {err}")
    check(all(o.c_total == 0 and o.hit_total == 0 for o in card_outs[n_real:]),
          "a padding tile reports totals or rows")
    emit({"phase": "sharded_tiles", "card": card, "shards": shards,
          "global_tiles": len(card_outs), "real_tiles": n_real,
          "hits": sum(o.hit_total for o in card_outs), "max_abs_err": err,
          "card_s": t_card, "cpu_plain_s": t_cpu})
    del eng

    # two processes, both on cuda:0
    mp = two_process_search(sts, fa, want_n0)
    rate = host_copy_bytes_per_s()
    summary = {"phase": "sharded_summary", "card": card, "warm_s": warm_s,
               "two_process_s": mp["seconds"], "gather_ms": mp["gather_ms"],
               "gather_rows_ms": mp["gather_rows_ms"],
               "gather_tiles": mp["gather_tiles"], "gather_rows": mp["gather_rows"],
               "gather_bytes": mp["gather_bytes"], "host_copy_bytes_per_s": rate,
               "gather_bound_ms": mp["gather_bytes"] / rate * 1e3,
               "two_process_equal": True,
               "note": "shards share one card: overhead, not scaling"}
    emit(summary)
    return summary


# ---------------------------------------------------------------- host path
BASES = "ACGT"


def gen_shared_wmer_sts(rng, n_sts: int, wordsize: int = 11, n_buckets: int = 1) -> tuple:
    """``tools/workloads.py``'s ``gen_shared_wmer_sts`` (no extended
    entries), copied draw for draw: STS whose primer1s all start with one
    of ``n_buckets`` shared W-mers. Returns (STS text, the shared W-mers)."""
    shared = ["".join(rng.choices(BASES, k=wordsize)) for _ in range(n_buckets)]
    lines = []
    p1s = []
    for i in range(n_sts):
        s = shared[i % len(shared)]
        ln = rng.randrange(18, 26)
        rng.random()  # the original's draw for an extended entry (none here)
        p1s.append(s + "".join(rng.choices(BASES, k=ln - len(s))))
    for i, p1 in enumerate(p1s):
        p2 = "".join(rng.choices(BASES, k=rng.randrange(18, 26)))
        size = rng.randrange(max(100, len(p1) + len(p2)), 400)
        lines.append(f"SHW{i}\t{p1}\t{p2}\t{size}")
    return "\n".join(lines) + "\n", shared


def gen_tandem_tract(rng, n: int, unit: str, tract_frac: float) -> str:
    """``tools/workloads.py``'s ``gen_tandem_tract``, copied draw for draw:
    random bases with one tract of ``unit`` in tandem over ~``tract_frac``
    of them."""
    g = rng.choices(BASES, k=n)
    ln = int(n * tract_frac)
    start = rng.randrange(0, max(1, n - ln))
    g[start : start + ln] = (unit * (ln // len(unit) + 1))[:ln]
    return "".join(g)


def flood_corpus(tmp: str, flood: str) -> tuple:
    """(sts, fa, engine parameters) of a corpus past one host-path cap, the
    same as ``tests/test_torch_kernels.py::flood_corpus``: "candidates",
    the JAX flood test's corpus (800 STS sharing one W-mer, a 15 kb genome
    with a 20 % tandem tract of it, -N 2 -M 50: past 20,000 candidates);
    "window", a 20-base tandem repeat over 16 kb of a 20 kb record and one
    STS whose primers are both the unit (product 200, -M 300): under 1,000
    candidates, but the anchors' window work passes 400,000 and their rows
    pass margin_p2's 8,192-row buffer."""
    if flood == "candidates":
        rng = random.Random(99)
        sts_text, shared = gen_shared_wmer_sts(rng, 800, n_buckets=1)
        genome = gen_tandem_tract(rng, 15_000, shared[0], tract_frac=0.2)
        params = {"mismatches": 2, "margin": 50}
    else:
        rng = random.Random(7)
        unit = "".join(rng.choices(BASES, k=20))
        genome = gen_tandem_tract(rng, 20_000, unit, tract_frac=0.8)
        sts_text = f"TAND\t{unit}\t{unit}\t200\n"
        params = {"margin": 300}
    sts = os.path.join(tmp, f"{flood}.sts")
    with open(sts, "w") as fh:
        fh.write(sts_text)
    fa = write_fasta(os.path.join(tmp, f"{flood}.fa"),
                     [("wk", np.frombuffer(genome.encode(), dtype=np.uint8))])
    return sts, fa, params


# one cold process: each start-up step on the host clock (argv: package
# root, STS, FASTA); the device path's steps run at MERPCR_TPU_HOST_MAX=0
STARTUP = r"""
import sys, time
t0 = time.perf_counter()
import torch
steps = {"import_torch_s": time.perf_counter() - t0}
sys.path.insert(0, sys.argv[1])
import ctypes, io, json, os
from contextlib import redirect_stdout
t = time.perf_counter()
from merpcr_tpu_torch import MerPCR
from merpcr_tpu_torch.engine import resolve_device
from merpcr_tpu_torch.ops import kernels
steps["import_package_s"] = time.perf_counter() - t
device_path = os.environ.get("MERPCR_TPU_HOST_MAX") == "0"

def step(name, fn, on_card=False):
    t = time.perf_counter()
    out = fn()
    if on_card:  # a step that queues device work ends when the card is done
        torch.cuda.synchronize()
    steps[name] = time.perf_counter() - t
    return out

dev = step("resolve_device_s", lambda: resolve_device(None))
eng = MerPCR(device=dev)
step("sts_load_and_table_compile_s", lambda: eng.load_sts_file(sys.argv[2]))
recs = step("fasta_load_s", lambda: eng.load_fasta_file(sys.argv[3]))
if device_path:
    step("cuda_context_s", lambda: torch.zeros(1, device=dev), True)
    step("table_upload_s", lambda: eng._table, True)
    step("kernel_library_load_s",
         lambda: (kernels.build(), [ctypes.CDLL(kernels.lib_path(s)) for s in kernels.SOURCES]))
buf = io.StringIO()

def search():
    with redirect_stdout(buf):
        eng.search(recs)

step("first_search_s", search, device_path)
steps["total_s"] = time.perf_counter() - t0
print(json.dumps({"steps": steps, "out": buf.getvalue(), "tables": len(eng._tables),
                  "scans": len(eng.last_scans)}))
"""

CROSSOVER_MBP = (0.25, 0.5, 1.0, 2.0)


def set_gate(value) -> None:
    """MERPCR_TPU_HOST_MAX for this process and the ones it starts (None:
    unset, the engine's default of 2,000,000 bases)."""
    if value is None:
        os.environ.pop("MERPCR_TPU_HOST_MAX", None)
    else:
        os.environ["MERPCR_TPU_HOST_MAX"] = str(value)


def cold_cli(g_sts: str, g_fa: str) -> tuple:
    """(stdout, host s) of ``python -m merpcr_tpu_torch`` on the golden
    files in a fresh process, under this process's gate."""
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "merpcr_tpu_torch", g_sts, g_fa],
                         cwd=PKG, capture_output=True, text=True, timeout=300)
    seconds = time.perf_counter() - t0
    check(cli.returncode == 0, f"golden CLI rc={cli.returncode} err={cli.stderr[-2000:]}")
    return cli.stdout, seconds


def cold_startup(g_sts: str, g_fa: str) -> dict:
    """The STARTUP script's steps in a fresh process, under this process's
    gate."""
    r = subprocess.run([sys.executable, "-c", STARTUP, PKG, g_sts, g_fa], cwd=PKG,
                       capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"start-up script rc={r.returncode} err={r.stderr[-2000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    check(got["out"] == GOLDEN_LINE + "\n", f"start-up script printed {got['out']!r}")
    return got


def traced_kernels(trace_dir: str) -> dict:
    """{kernel name: events} of the kernel events in the one Chrome trace
    that ``MERPCR_TPU_TRACE`` left in ``trace_dir``."""
    files = os.listdir(trace_dir)
    check(len(files) == 1, f"trace directory holds {files}")
    with open(os.path.join(trace_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    found = {}
    for e in events:
        if e.get("cat") == "kernel":
            name = e.get("name", "").replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            found[name] = found.get(name, 0) + 1
    return found


def plane_totals(eng, rec) -> tuple:
    """(tile_len, [(pair_total, anch_total, hit_total) per tile]) of one
    record's record-path scan on the card, as its search ran it."""
    from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes
    from merpcr_tpu_torch.ops.scan import record_rmeta, scan_stream

    seq, packed = record_seq_bytes(rec), record_packed(rec)
    n = len(seq)
    total = n - eng.wordsize + 1
    cfg = eng._base_config(eng._pick_tile_len(total), packed=packed is not None)
    n_tiles = -(-total // cfg.tile_len)
    plane = eng._plane(seq if packed is None else packed,
                       cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead,
                       packed=packed is not None)
    outs = scan_stream(cfg, eng._table, torch.from_numpy(plane).to(eng.device), total, n,
                       record_rmeta(n, eng.device), None, eng._runtime_params(), n_tiles)
    return cfg.tile_len, [(o.pair_total, o.anch_total, o.hit_total) for o in outs]


def phase_host_path(MerPCR, wrappers, sts: str, recs, expect, want_n0: str, n: int,
                    card: str, build_s: float, tmp: str) -> dict:
    """Phase 14: the host fast path and its gate on the card. (a) the
    golden files on the default gate through the API and the CLI: the
    golden line, no launch, no device table; (b) the same at
    MERPCR_TPU_HOST_MAX=0: the golden line, the four kernels launched; (c)
    start-up in cold processes on the host clock (the golden CLI under (a)
    and (b), and each step of both paths), then warm s of prefixes of the
    47 Mbp record on the host path (fresh engines), on the card's device
    path, and on the default gate on the warm engine (the kernels: its
    table is on the card), bytes equal, every plant inside the prefix
    present; (d) a candidate flood
    and a window-work flood: host_scan_record returns None, the default
    gate falls back to the kernels with the bytes of the device path and
    of device="cpu"; the window flood's rows pass margin_p2's row buffer
    (its second launch), and whether expand passed its pair buffer; (e) a
    warm 47 Mbp -N 0 search under MERPCR_TPU_TRACE: one trace holding the
    four kernels, the untraced bytes; the golden CLI cold and traced under
    (a) and (b). Returns the phase line."""
    from merpcr_tpu_torch.io.fasta import record_seq_bytes
    from merpcr_tpu_torch.models import FASTARecord
    from merpcr_tpu_torch.ops.expand import PAIRS_PER_CAP
    from merpcr_tpu_torch.ops.host_scan import host_scan_record
    from merpcr_tpu_torch.ops.margin_p2 import ROW_CAP

    four = WRAPPERS
    data = os.path.join(ROOT, "tests", "data")
    g_sts, g_fa = os.path.join(data, "test.sts"), os.path.join(data, "test.fa")
    line = {"phase": "host_path", "card": card}

    def launched() -> dict:
        return {k: w.launches for k, w in wrappers.items()}

    def zero() -> None:
        for w in wrappers.values():
            w.launches = 0

    # (a) and (b): the golden files on each side of the gate
    for name, gate in (("default_gate", None), ("host_max_0", 0)):
        set_gate(gate)
        zero()
        g = MerPCR()
        check(g.load_sts_file(g_sts), "golden STS load failed")
        api, _, t_api = search_bytes(g, g.load_fasta_file(g_fa))
        counts = launched()
        check(api == GOLDEN_LINE + "\n", f"golden {name}: API output {api!r}")
        if gate is None:
            check(not any(counts.values()) and g._tables == {} and g.last_scans == [],
                  f"golden on the default gate: launches {counts}, "
                  f"{len(g._tables)} tables, {len(g.last_scans)} planes")
        else:
            check(all(counts[k] > 0 for k in four) and len(g._tables) == 1,
                  f"golden at MERPCR_TPU_HOST_MAX=0: launches {counts}")
        out, t_cli = cold_cli(g_sts, g_fa)
        check(out == GOLDEN_LINE + "\n", f"golden CLI {name}: {out!r}")
        line[name] = {"api_s": t_api, "launches": counts, "device_tables": len(g._tables),
                      "cli_cold_s": t_cli, "golden": True}
        del g

    # (c) start-up steps in cold processes, then the crossover
    startup = {}
    for name, gate in (("host_path", None), ("device_path", 0)):
        set_gate(gate)
        got = cold_startup(g_sts, g_fa)
        check((got["tables"], got["scans"]) == ((0, 0) if gate is None else (1, 1)),
              f"start-up {name}: {got['tables']} tables, {got['scans']} planes")
        startup[name] = got["steps"]
    startup["kernel_build_s_first_use"] = build_s  # phase 2: nvcc, all four
    line["startup"] = startup
    # each prefix on a fresh engine on the host path (an engine whose
    # table is on the card takes the kernels), on one engine on the device
    # path, and on that warm engine again on the default gate
    eng = MerPCR()
    check(eng.load_sts_file(sts), "STS load failed")
    crossover = []
    for mbp in CROSSOVER_MBP:
        m = int(mbp * 1e6)
        rec = FASTARecord(defline=f">{recs[0].label} prefix", sequence=recs[0].sequence[:m])
        inside = [e for e in expect if int(e.split("\t")[1].split("..")[1]) <= m]
        row = {"mbp": mbp, "bases": m}
        outs = {}
        for path, gate in (("host", None), ("device", 0), ("warm_engine_default_gate", None)):
            set_gate(gate)
            zero()
            e = eng
            if path == "host":
                e = MerPCR()
                check(e.load_sts_file(sts), "STS load failed")
            outs[path], _, row[f"{path}_cold_s"] = search_bytes(e, [rec])
            outs[path + "_warm"], _, row[f"{path}_warm_s"] = search_bytes(e, [rec])
            row[f"{path}_launches"] = sum(launched()[k] for k in four)
            check(outs[path] == outs[path + "_warm"], f"{mbp} Mbp {path}: warm differs")
            check((len(e.last_scans) > 0) == (path != "host") and
                  (len(e._tables) == 0) == (path == "host"),
                  f"{mbp} Mbp {path}: {len(e.last_scans)} planes, {len(e._tables)} tables")
            del e
        check(outs["host"] == outs["device"] == outs["warm_engine_default_gate"],
              f"{mbp} Mbp: host and device bytes differ")
        lines = set(outs["host"].splitlines())
        missing = [e for e in inside if e not in lines]
        check(not missing, f"{mbp} Mbp: {len(missing)} planted lines missing")
        row.update(planted_inside=len(inside), hits=len(lines), equal=True,
                   host_warm_mbp_per_s=mbp / row["host_warm_s"],
                   device_warm_mbp_per_s=mbp / row["device_warm_s"])
        crossover.append(row)
    line["crossover"] = crossover
    # the device path's one-time cost in a cold process against the host
    # path's warm rate: the input size at which a one-shot run breaks even
    dev, host = startup["device_path"], startup["host_path"]
    once = (dev["cuda_context_s"] + dev["table_upload_s"] + dev["kernel_library_load_s"]
            + dev["first_search_s"] - host["first_search_s"])
    last = crossover[-1]
    h_rate, d_rate = last["host_warm_s"] / last["mbp"], last["device_warm_s"] / last["mbp"]
    line["crossover_estimate"] = {
        "device_once_s": once, "host_warm_s_per_mbp": h_rate,
        "device_warm_s_per_mbp": d_rate,
        "warm_device_faster_at_every_prefix": all(
            r["device_warm_s"] < r["host_warm_s"] for r in crossover),
        "cold_crossover_mbp": once / (h_rate - d_rate) if h_rate > d_rate else None}
    del eng

    # (d) floods: past each cap, the record falls back to the kernels
    floods = {}
    for flood in ("candidates", "window"):
        f_sts, f_fa, params = flood_corpus(tmp, flood)
        set_gate(None)
        eng = MerPCR(**params)
        check(eng.load_sts_file(f_sts), f"{flood} flood STS load failed")
        f_recs = eng.load_fasta_file(f_fa)
        t0 = time.perf_counter()
        rows = host_scan_record(eng._table_host, eng._meta, record_seq_bytes(f_recs[0]),
                                eng.margin, eng.mismatches, eng.three_prime_match)
        t_host = time.perf_counter() - t0
        check(rows is None, f"{flood} flood: host_scan_record returned rows")
        zero()
        out, hits, t_search = search_bytes(eng, f_recs)
        counts = launched()
        (scan,) = eng.last_scans
        used = path_wrappers(scan.cfg)
        # a tile past a buffer of the deferred scan reruns count first
        check(counts[used[1]] == scan.tiles
              and counts[used[0]] == scan.tiles + len(scan.reruns) and
              all(v == 0 for k, v in counts.items() if k not in used + COUNT_FIRST),
              f"{flood} flood: launches {counts} for {scan.tiles} tiles")
        set_gate(0)
        dev_out, _, _ = search_bytes(eng, f_recs)
        cpu = MerPCR(device="cpu", **params)
        check(cpu.load_sts_file(f_sts), "STS load failed (cpu)")
        cpu_out, _, _ = search_bytes(cpu, f_recs)
        check(out == dev_out == cpu_out, f"{flood} flood: bytes differ")
        tile_len, totals = plane_totals(eng, f_recs[0])
        pair_cap = max(1024, tile_len // PAIRS_PER_CAP)
        floods[flood] = {
            "params": params, "bases": len(f_recs[0].sequence), "hits": hits,
            "host_scan_s_to_none": t_host, "search_s": t_search, "tiles": scan.tiles,
            "launches": counts, "strict": scan.cfg.strict, "reruns": list(scan.reruns),
            "pairs_per_tile": [t[0] for t in totals], "pair_buffer": pair_cap,
            "expand_past_pair_buffer": any(t[0] > pair_cap for t in totals),
            "rows_per_tile": [t[2] for t in totals], "row_buffer": ROW_CAP,
            "margin_p2_past_row_buffer": counts["margin_p2"] > counts["verify_p1"],
            "equal_to_host_max_0_and_cpu": True}
        del eng, cpu
    w = floods["window"]
    check(max(w["rows_per_tile"]) > ROW_CAP and w["reruns"]
          and w["launches"]["margin_p2"] == 2 * len(w["reruns"]),
          f"window flood: rows {w['rows_per_tile']}, reruns {w['reruns']}, margin_p2 "
          f"launches {w['launches']['margin_p2']}")
    line["floods"] = floods

    # (e) the trace of a warm 47 Mbp -N 0 search
    set_gate(0)  # above the default cutoff anyway: the device path
    eng = MerPCR()
    check(eng.load_sts_file(sts), "STS load failed")
    search_bytes(eng, recs)
    plain, _, t_plain = search_bytes(eng, recs)
    trace_dir = os.path.join(tmp, "trace")
    os.environ["MERPCR_TPU_TRACE"] = trace_dir
    try:
        traced, _, t_traced = search_bytes(eng, recs)
    finally:
        del os.environ["MERPCR_TPU_TRACE"]
    check(traced == plain == want_n0, "the traced search's bytes differ")
    found = traced_kernels(trace_dir)
    check(all(found.get(k, 0) > 0 for k in KERNEL_NAMES), f"trace kernels {found}")
    line["trace"] = {"warm_s_untraced": t_plain, "warm_s_traced": t_traced,
                     "kernel_events": found, "trace_bytes": sum(
                         os.path.getsize(os.path.join(trace_dir, f))
                         for f in os.listdir(trace_dir))}
    del eng
    # a one-shot traced run pays the profiler's first start in its process:
    # the golden CLI cold and traced on each side of the gate, against (a)
    # and (b) untraced
    for name, gate in (("default_gate", None), ("host_max_0", 0)):
        set_gate(gate)
        trace_dir = os.path.join(tmp, f"trace_cli_{name}")
        os.environ["MERPCR_TPU_TRACE"] = trace_dir
        try:
            out, t_cli = cold_cli(g_sts, g_fa)
        finally:
            del os.environ["MERPCR_TPU_TRACE"]
        check(out == GOLDEN_LINE + "\n", f"traced golden CLI {name}: {out!r}")
        check(len(os.listdir(trace_dir)) == 1, f"traced golden CLI {name}: no trace")
        line["trace"][f"cli_cold_s_traced_{name}"] = t_cli
        line["trace"][f"cli_cold_s_untraced_{name}"] = line[name]["cli_cold_s"]
    set_gate(0)
    emit(line)
    return line


# ---------------------------------------------------------------- warm path
WARM_SWEEP = (("N2", {"mismatches": 2}), ("N1", {"mismatches": 1}),
              ("N0", {"mismatches": 0}), ("M1000", {"margin": 1000}))


def searched(eng, recs, wrappers, want=None, what: str = "") -> tuple:
    """(output, figures) of one search: host seconds, the host's waits on
    the card (READS), planes, tiles, tiles rerun past a buffer, launches,
    and ``host_split``: the host seconds of the engine's dispatch and
    collect steps, of the waits on the card (within collect) and of
    Python's garbage collections (CLOCK); the output held to ``want`` when
    given."""
    for w in wrappers.values():
        w.launches = 0
    r0, c0 = READS[0], dict(CLOCK)
    steps = {"dispatch_s": 0.0, "collect_s": 0.0}
    for step, attr in (("dispatch_s", "_dispatch_item"), ("collect_s", "_collect")):
        real = getattr(eng, attr, None)  # (an A/B parent has neither)
        if real is not None:
            setattr(eng, attr, clocked(real, steps, step))
    try:
        out, hits, t = search_bytes(eng, recs)
    finally:
        for attr in ("_dispatch_item", "_collect"):
            eng.__dict__.pop(attr, None)
    scans = eng.last_scans
    fig = {"s": t, "host_reads": READS[0] - r0, "planes": len(scans),
           "host_split": {**steps, **{k: CLOCK[k] - c0[k] for k in CLOCK}},
           "tiles": sum(sc[1] for sc in scans),
           "reruns": sum(len(getattr(sc, "reruns", ())) for sc in scans), "hits": hits,
           "launches": {k: w.launches for k, w in wrappers.items() if w.launches}}
    if want is not None:
        check(out == want, f"{what}: bytes differ from device=\"cpu\"")
    return out, fig


def clocked(fn, acc: dict, key: str):
    """``fn`` with its host seconds added to ``acc[key]``."""

    def run(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            acc[key] += time.perf_counter() - t0

    return run


def cpu_bytes(MerPCR, sts: str, recs, **params) -> str:
    cpu = MerPCR(device="cpu", **params)
    check(cpu.load_sts_file(sts), "STS load failed (cpu)")
    return search_bytes(cpu, recs)[0]


def warm_engine(MerPCR, wrappers, sts: str, recs, what: str, cpu: bool, sweep: bool,
                **params) -> dict:
    """A fresh engine's first search, then warm searches: three at the
    start parameters (device busy and idle share of one of them from
    torch.profiler against the unprofiled warm seconds), then with
    ``sweep`` -N 2, -N 1, -N 0 and -M 1000 in turn on the same engine. Every
    search's bytes equal the first one's at the same parameters and, with
    ``cpu``, device="cpu"'s."""
    eng = MerPCR(**params)
    check(eng.load_sts_file(sts), "STS load failed")
    want = cpu_bytes(MerPCR, sts, recs, **params) if cpu else None
    first, fig = searched(eng, recs, wrappers, want, f"{what} first")
    got = {"first": fig, "warm": []}
    for _ in range(3):
        out, fig = searched(eng, recs, wrappers, first, f"{what} warm")
        got["warm"].append(fig)
    dev = device_time(lambda: search_bytes(eng, recs))
    busy = sum(v[0] for v in dev.values())
    warm_s = min(f["s"] for f in got["warm"])
    got.update(device_busy_s=busy, device_idle_share=1 - busy / warm_s,
               warm_mbp_per_s=sum(len(r.sequence) for r in recs) / 1e6 / warm_s)
    if sweep:
        base = dict(params)
        for name, change in WARM_SWEEP:
            for k, v in change.items():
                setattr(eng, k, v)
            base.update(change)
            ref = cpu_bytes(MerPCR, sts, recs, **base) if cpu else None
            out, fig = searched(eng, recs, wrappers, ref, f"{what} {name}")
            got[name] = fig
        eng.margin = params.get("margin", 50)
    return got


def flood_reruns(MerPCR, wrappers, tmp: str, rna_too: bool) -> tuple:
    """Phase 14's two floods (and their RNA renderings, raw-byte records) on
    the deferred scan: the tiles rerun are exactly those whose
    count-first pair_total passes ``expand``'s pair buffer or whose
    hit_total passes ``margin_p2``'s row buffer, and the bytes equal
    device="cpu"'s. Returns (figures, launches of every wrapper)."""
    from merpcr_tpu_torch.models import FASTARecord
    from merpcr_tpu_torch.ops import expand as ex_mod
    from merpcr_tpu_torch.ops import margin_p2 as m_mod

    out, total = {}, {}
    for flood in ("candidates", "window"):
        f_sts, f_fa, params = flood_corpus(tmp, flood)
        eng = MerPCR(**params)
        check(eng.load_sts_file(f_sts), f"{flood} flood STS load failed")
        f_recs = eng.load_fasta_file(f_fa)
        renders = [("dna", f_recs, params)]
        if rna_too:  # at -I 1, where U matches T
            renders.append(("rna", [FASTARecord(defline=r.defline, sequence=rna(r.sequence))
                                    for r in f_recs], {**params, "iupac_mode": 1}))
        for kind, rs, prm in renders:
            eng = MerPCR(**prm)
            check(eng.load_sts_file(f_sts), f"{flood} flood STS load failed")
            want = cpu_bytes(MerPCR, f_sts, rs, **prm)
            got, fig = searched(eng, rs, wrappers, want, f"{flood} flood ({kind})")
            (scan,) = eng.last_scans
            tile_len, totals = plane_totals(eng, rs[0])
            pair_cap = ex_mod.pair_cap(tile_len)
            past = tuple(t for t, (pairs, _a, hits) in enumerate(totals)
                         if pairs > pair_cap or hits > m_mod.ROW_CAP)
            check(past and scan.reruns == past,
                  f"{flood} flood ({kind}): reruns {scan.reruns}, past a buffer {past}")
            out[f"{flood}_{kind}"] = {**fig, "pair_buffer": pair_cap,
                                      "row_buffer": m_mod.ROW_CAP,
                                      "pairs_per_tile": [t[0] for t in totals],
                                      "rows_per_tile": [t[2] for t in totals],
                                      "rerun_tiles": list(scan.reruns), "packed": scan.cfg.packed,
                                      "equal_to_cpu": True}
            for k, v in fig["launches"].items():
                total[k] = total.get(k, 0) + v
    return out, total


def phase_warm_path(MerPCR, wrappers, sts: str, recs, a_sts: str, fas: dict, tmp: str,
                    card: str, full: bool) -> tuple:
    """Phase 15: the warm-search path. (a) the 47 Mbp record and assembly
    (c): a fresh engine's first search, three warm searches, then -N 2, -N 1,
    -N 0 and -M 1000 on the same engine, each with its seconds, host reads,
    reruns and launches, bytes equal to device="cpu"; device busy and idle
    share of a warm search; the first search's host steps (dirty rate,
    plane, upload), which warm searches take from the cache; (b) the
    record at -N 2 and assemblies (a), (b), (d), (e) on fresh engines,
    first search and warm; (c) the floods on the deferred scan, reruns
    exactly past the buffers; (d) a mixed plan under the depth-1 prefetch.
    With ``full`` False (an A/B of another checkout) (c) and (d) and the
    device="cpu" comparisons are left out. Returns (the phase line, the
    launches of the floods' searches)."""
    from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes
    from merpcr_tpu_torch.models import FASTARecord

    line = {"phase": "warm_path", "card": card, "package": os.path.relpath(PKG, ROOT)}
    a_recs = MerPCR(device="cpu").load_fasta_file(fas["dirty"])
    line["record_N0"] = warm_engine(MerPCR, wrappers, sts, recs, "47 Mbp", full, True)
    line["assembly_c"] = warm_engine(MerPCR, wrappers, a_sts, a_recs, "assembly (c)", full,
                                     True, iupac_mode=1)
    # the first search's host steps, each on its own
    eng = MerPCR()
    check(eng.load_sts_file(sts), "STS load failed")
    seq, packed = record_seq_bytes(recs[0]), record_packed(recs[0])
    steps = {}
    t0 = time.perf_counter()
    eng._dirty_of(seq, packed)
    steps["dirty_rate_s"] = time.perf_counter() - t0
    total = len(seq) - eng.wordsize + 1
    cfg = eng._base_config(eng._pick_tile_len(total))
    n_tiles = -(-total // cfg.tile_len)
    t0 = time.perf_counter()
    plane = eng._plane(packed, cfg.lead + n_tiles * cfg.tile_len + cfg.tail, cfg.lead,
                       packed=True)
    steps["plane_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    torch.from_numpy(plane).to(eng.device)
    torch.cuda.synchronize()
    steps["upload_s"] = time.perf_counter() - t0
    (_, _, items), = eng._plan(a_recs)
    t0 = time.perf_counter()
    if hasattr(eng, "_run_dirty_pos"):
        eng._run_dirty_pos(items)
    else:  # a checkout whose stream run samples record by record
        sum(eng._dirty_of(q, p)[1] * len(q) for q, p in items)
    steps["assembly_dirty_rate_s"] = time.perf_counter() - t0
    line["first_search_steps"] = steps
    del eng, plane
    # (b) the other cells, fresh engines
    line["record_N2"] = warm_engine(MerPCR, wrappers, sts, recs, "47 Mbp -N 2", full, False,
                                    mismatches=2)
    for name, fa, params in (("assembly_a", fas["clean"], {}), ("assembly_b", fas["dirty"], {}),
                             ("assembly_d", fas["dirty"], {"iupac_mode": 1, "mismatches": 2})):
        rs = a_recs if fa == fas["dirty"] else MerPCR(device="cpu").load_fasta_file(fa)
        line[name] = warm_engine(MerPCR, wrappers, a_sts, rs, name, full, False, **params)
    e_recs = [FASTARecord(defline=r.defline, sequence=rna(r.sequence)) if i % RNA_EVERY == 0
              else r for i, r in enumerate(a_recs)]
    line["assembly_e"] = warm_engine(MerPCR, wrappers, a_sts, e_recs, "assembly (e)", full,
                                     False, iupac_mode=1)
    floods = {}
    if full:
        # (c) the floods on the deferred scan
        line["floods"], floods = flood_reruns(MerPCR, wrappers, tmp, True)
        # (d) a mixed plan: a stream run, an empty record, a 2 Mbp lone
        # record, an RNA scaffold (raw bytes), another run, an empty record
        prefix = FASTARecord(defline=">prefix of the record", sequence=recs[0].sequence[:2_000_000])
        empty = FASTARecord(defline=">empty", sequence="")
        mixed = [*a_recs[:100], empty, prefix, FASTARecord(
            defline=a_recs[100].defline, sequence=rna(a_recs[100].sequence)),
            *a_recs[101:200], FASTARecord(defline=">empty2", sequence="")]
        eng = MerPCR(iupac_mode=1)
        check(eng.load_sts_file(a_sts), "STS load failed")
        want = cpu_bytes(MerPCR, a_sts, mixed, iupac_mode=1)
        got = {}
        for run in ("first", "warm"):
            out, got[run] = searched(eng, mixed, wrappers, want, f"mixed plan ({run})")
        labels = [ln.split("\t")[0] for ln in out.splitlines()]
        order = {r.label: i for i, r in enumerate(mixed)}
        check(labels == sorted(labels, key=order.__getitem__), "mixed plan: not in FASTA order")
        kinds = [k for k, *_ in eng._plan(mixed)]
        check([(sc.records, sc.cfg.packed) for sc in eng.last_scans] ==
              [(100, True), (1, True), (1, False), (99, True)], f"mixed plan: {eng.last_scans}")
        line["mixed_plan"] = {**got, "plan": kinds, "records": len(mixed),
                              "equal_to_cpu": True, "in_fasta_order": True}
    emit(line)
    return line, floods


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mbp", type=float, default=47.0)
    ap.add_argument("--nsts", type=int, default=1000)
    ap.add_argument("--planted", type=int, default=200)
    ap.add_argument("--package-root", default=ROOT,
                    help="run the merpcr_tpu_torch of this checkout (an A/B "
                         "against another commit), measured by this script")
    ap.add_argument("--only", choices=("warm_path",),
                    help="phases 1-3 and this phase alone, without its "
                         "device=\"cpu\" comparisons, floods and mixed plan (the A/B)")
    args = ap.parse_args()
    global PKG
    PKG = os.path.abspath(args.package_root)
    sys.path.insert(0, PKG)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # phases 1-13 drive the kernels: no input of theirs takes the host path
    # (the golden files of phase 10 would); phase 14 sets the gate itself
    set_gate(0)
    from merpcr_tpu_torch import MerPCR
    from merpcr_tpu_torch.ops import expand as ex_mod
    from merpcr_tpu_torch.ops import front_end as fe_mod
    from merpcr_tpu_torch.ops import kernels
    from merpcr_tpu_torch.ops import margin_p2 as m_mod
    from merpcr_tpu_torch.ops import verify_p1 as v_mod

    # every wrapper the package has, and the deferred mode of each stage
    # wrapper that has one (an A/B parent has none)
    wrappers = {k: getattr(mod, k) for mod in (fe_mod, ex_mod, v_mod, m_mod)
                for k in ("front_end", "front_end_loose", "front_end_raw") + COUNT_FIRST
                if hasattr(mod, k) and hasattr(getattr(mod, k), "launches")}
    wrappers.update({f"{k}_deferred": Deferred(wrappers[k]) for k in COUNT_FIRST
                     if hasattr(wrappers.get(k), "launches_deferred")})
    count_reads(kernels)
    t_start = time.perf_counter()

    # 1. device
    name = torch.cuda.get_device_name(0)
    card = smi()
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "nvidia_smi": card})

    # 2. build
    t0 = time.perf_counter()
    logs = kernels.build()
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.split("ptxas info    : ")[-1] for ln in v.splitlines()
                 if "registers" in ln] for k, v in logs.items()}
    emit({"phase": "build", "seconds": build_s,
          "compiled": sorted(logs), "ptxas": ptxas})

    with tempfile.TemporaryDirectory() as tmp:
        # 3. workload
        t0 = time.perf_counter()
        sts, fa, n, expect, mism, off_size = make_workload(
            tmp, args.seed, args.mbp, args.nsts, args.planted)
        emit({"phase": "workload", "seconds": time.perf_counter() - t0,
              "genome_bp": n, "sts": args.nsts, "planted_lines": len(expect),
              "mismatch_lines": {k: len(v) for k, v in mism.items()},
              "off_size_lines": {d: len(v) for d, v in off_size.items()}})
        if args.only:  # the A/B: phase 15 alone
            a_sts, a_clean, a_dirty, *_ = make_assembly(tmp, args.seed, args.nsts, args.planted)
            recs = MerPCR(device="cpu").load_fasta_file(fa)
            phase_warm_path(MerPCR, wrappers, sts, recs, a_sts,
                            {"clean": a_clean, "dirty": a_dirty}, tmp, card, False)
            print(smi())
            emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                         "count": torch.cuda.device_count()}})
            return 0

        eng = MerPCR()
        t0 = time.perf_counter()
        check(eng.load_sts_file(sts), "STS load failed")
        t_table = time.perf_counter() - t0
        t0 = time.perf_counter()
        recs = eng.load_fasta_file(fa)
        t_fasta = time.perf_counter() - t0
        check(len(recs) == 1 and len(recs[0].sequence) == n, "FASTA load")
        plants = list(expect)  # the record's exact plants (phase 11 reuses the name)

        # 4. kernels
        res = phase_kernels(eng, record_tile(eng, recs), card, "kernels", "")

        # 5. end to end
        cold, hits_cold, t_cold = search_bytes(eng, recs)
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        warm, hits, t_warm = search_bytes(eng, recs)
        launches = {k: w.launches for k, w in wrappers.items()}
        peak = torch.cuda.max_memory_allocated()
        check(warm == cold and hits == hits_cold, "warm search differs from cold")
        lines = set(warm.splitlines())
        missing = [e for e in expect if e not in lines]
        check(not missing, f"{len(missing)} planted lines missing, e.g. {missing[:3]}")
        found = [e for k in mism for e in mism[k] if e in lines]
        check(not found, f"-N 0 found {len(found)} mismatch lines, e.g. {found[:3]}")
        found = [e for d in off_size for e in off_size[d] if e in lines]
        check(not found, f"-M 50 found {len(found)} off-size lines, e.g. {found[:3]}")
        used = path_wrappers(eng.last_scans[0][0])
        check(all((v > 0) == (k in used) for k, v in launches.items()),
              f"-N 0 launches {launches}")
        cpu = MerPCR(device="cpu")
        check(cpu.load_sts_file(sts), "STS load failed (cpu)")
        cpu_out, _, t_cpu = search_bytes(cpu, recs)
        check(cpu_out == warm, "card output differs from the CPU (plain) output")
        emit({"phase": "end2end", "card": card, "genome_bp": n, "hits": hits,
              "planted_found": len(expect), "cold_s": t_cold, "warm_s": t_warm,
              "warm_mbp_per_s": n / 1e6 / t_warm, "cpu_plain_s": t_cpu,
              "table_compile_s": t_table, "fasta_load_s": t_fasta,
              "peak_mem_bytes": peak, "launches": launches,
              "equal_to_cpu": True})
        emit({"phase": "breakdown", "card": card, **breakdown(eng, recs)})

        # 6. mismatch budget: -N 1 (strict1) and -N 2 (loose)
        mm = phase_mismatch(MerPCR, eng, recs, wrappers, expect, mism, n, card, sts)

        # 7. every -W: the stride-2, bstart, binary-search and mult-hash tiers
        ws = phase_wordsize(MerPCR, recs, wrappers, expect, n, card, sts)

        # 8. every -M: margins above 128
        mg = phase_margin(MerPCR, recs, wrappers, expect, off_size, n, card, sts)

        # 9. records outside the 16-letter alphabet: the raw-byte path (K9)
        rw = phase_raw(MerPCR, recs, wrappers, expect, mism, off_size, n, card, sts)

        # 10. golden
        data = os.path.join(ROOT, "tests", "data")
        g_sts, g_fa = os.path.join(data, "test.sts"), os.path.join(data, "test.fa")
        g = MerPCR()
        check(g.load_sts_file(g_sts), "golden STS load failed")
        api, _, _ = search_bytes(g, g.load_fasta_file(g_fa))
        check(api == GOLDEN_LINE + "\n", f"golden API output {api!r}")
        cli = subprocess.run(
            [sys.executable, "-m", "merpcr_tpu_torch", g_sts, g_fa],
            cwd=PKG, capture_output=True, text=True, timeout=300,
        )
        check(cli.returncode == 0 and cli.stdout == GOLDEN_LINE + "\n",
              f"golden CLI rc={cli.returncode} out={cli.stdout!r} "
              f"err={cli.stderr[-2000:]}")
        gi = MerPCR(iupac_mode=1)
        check(gi.load_sts_file(g_sts), "golden STS load failed (-I 1)")
        api_i, _, _ = search_bytes(gi, gi.load_fasta_file(g_fa))
        cli_i = subprocess.run(
            [sys.executable, "-m", "merpcr_tpu_torch", g_sts, g_fa, "-I", "1"],
            cwd=PKG, capture_output=True, text=True, timeout=300,
        )
        check(cli_i.returncode == 0 and cli_i.stdout == api_i and GOLDEN_LINE in api_i,
              f"golden -I 1: CLI rc={cli_i.returncode} out={cli_i.stdout!r} "
              f"api={api_i!r} err={cli_i.stderr[-2000:]}")
        g2 = MerPCR(mismatches=2)
        check(g2.load_sts_file(g_sts), "golden STS load failed (-N 2)")
        api_2, _, _ = search_bytes(g2, g2.load_fasta_file(g_fa))
        cli_2 = subprocess.run(
            [sys.executable, "-m", "merpcr_tpu_torch", g_sts, g_fa, "-N", "2"],
            cwd=PKG, capture_output=True, text=True, timeout=300,
        )
        check(cli_2.returncode == 0 and cli_2.stdout == api_2 and GOLDEN_LINE in api_2
              and not g2.last_scans[0][0].strict,
              f"golden -N 2: CLI rc={cli_2.returncode} out={cli_2.stdout!r} "
              f"api={api_2!r} err={cli_2.stderr[-2000:]}")
        gw = MerPCR(wordsize=13, margin=300)
        check(gw.load_sts_file(g_sts), "golden STS load failed (-W 13 -M 300)")
        api_w, _, _ = search_bytes(gw, gw.load_fasta_file(g_fa))
        cli_w = subprocess.run(
            [sys.executable, "-m", "merpcr_tpu_torch", g_sts, g_fa, "-W", "13", "-M", "300"],
            cwd=PKG, capture_output=True, text=True, timeout=300,
        )
        check(cli_w.returncode == 0 and cli_w.stdout == api_w and GOLDEN_LINE in api_w
              and gw.last_scans[0][0].stride == 2,
              f"golden -W 13 -M 300: CLI rc={cli_w.returncode} out={cli_w.stdout!r} "
              f"api={api_w!r} err={cli_w.stderr[-2000:]}")
        emit({"phase": "golden", "api": True, "cli": True, "cli_iupac": True,
              "cli_n2": True, "n2_lines": api_2.count("\n"), "cli_w13_m300": True})
        del eng, g, gi, g2, gw

        # 11. assembly
        t0 = time.perf_counter()
        a_sts, a_clean, a_dirty, a_bp, a_expect, a_expect_i = make_assembly(
            tmp, args.seed, args.nsts, args.planted)
        emit({"phase": "assembly_workload", "seconds": time.perf_counter() - t0,
              "bases": a_bp, "records": ASM_RECORDS, "sts": args.nsts,
              "planted_lines": len(a_expect), "planted_iupac_lines": len(a_expect_i)})
        stream_launches = {}
        for variant, fa_v, iupac, bloom, n_mm in (("a_clean_I0", a_clean, 0, False, 0),
                                                  ("b_dirty_I0", a_dirty, 0, True, 0),
                                                  ("c_dirty_I1", a_dirty, 1, True, 0),
                                                  ("d_dirty_I1_N2", a_dirty, 1, False, 2)):
            expect, absent = (a_expect + a_expect_i, []) if iupac else (a_expect, a_expect_i)
            a_eng, a_recs, launched, a_out = phase_assembly(
                MerPCR, wrappers, a_sts, fa_v, iupac, expect, absent, a_bp,
                card, variant, bloom, n_mm)
            if variant.startswith("c"):
                stream_launches, c_out = launched, a_out
                emit({"phase": "assembly_breakdown", "variant": variant, "card": card,
                      **stream_breakdown(a_eng, a_recs)})
                # 12. stream kernels on one real stream tile of variant (c)
                s_res = phase_kernels(a_eng, stream_tile(a_eng, a_recs), card,
                                      "stream_kernels", "stream+dirty_bloom+iupac")
            if variant.startswith("d"):
                d_launches = launched
                emit({"phase": "assembly_breakdown", "variant": variant, "card": card,
                      **stream_breakdown(a_eng, a_recs)})
                # and the loose kernels on the same stream tile at -N 2
                d_res = phase_kernels(a_eng, stream_tile(a_eng, a_recs), card,
                                      "stream_kernels", "stream+iupac+N2")
            del a_eng, a_recs
        # variant (e): (c) with every 100th scaffold rendered as RNA
        phase_assembly_rna(MerPCR, wrappers, a_sts, a_dirty, c_out, a_bp, card)
        # variant (c) at W = 13 (stride-2 ptab, bloom as a prefix filter)
        # and W = 14 (no ptab: every valid phase, pruned by the bloom); the
        # R/Y/N letters may fall into the wider W-mer, so only the
        # ACGT-primer lines are held
        sw = []
        for W in (13, 14):
            a_eng, a_recs, launched, _ = phase_assembly(
                MerPCR, wrappers, a_sts, a_dirty, 1, a_expect, [], a_bp, card,
                f"c_dirty_I1_W{W}", True, 0, W)
            # and that path's kernels on one real stream tile
            sw.append((phase_kernels(a_eng, stream_tile(a_eng, a_recs), card,
                                     "stream_kernels", f"stream+dirty_bloom+iupac+W{W}"),
                       launched))
            del a_eng, a_recs

        # 13. the sharded search (K15): meshes on the card, two processes
        phase_sharded(MerPCR, recs, wrappers, sts, fa, warm, a_sts, a_dirty, c_out, n,
                      a_bp, card)

        # 14. the host fast path, its gate and floods, and the trace hook
        if PKG == ROOT or os.path.exists(
                os.path.join(PKG, "merpcr_tpu_torch", "ops", "host_scan.py")):
            phase_host_path(MerPCR, wrappers, sts, recs, plants, warm, n, card, build_s, tmp)
        else:
            emit({"phase": "host_path", "ran": False,
                  "reason": f"--package-root {PKG} has no merpcr_tpu_torch/ops/host_scan.py"})

        # 15. the warm-search path: caches, the deferred scan, reruns, prefetch
        set_gate(0)
        _, rerun_launches = phase_warm_path(MerPCR, wrappers, sts, recs, a_sts,
                                            {"clean": a_clean, "dirty": a_dirty}, tmp, card,
                                            True)

    rows = []
    for kern, launched in ((res, launches), (s_res, stream_launches), *mm.values(),
                           (d_res, d_launches), *ws, *mg, *sw, rw):
        for k, r in kern.items():
            # a search launches a count-first wrapper only to rerun a tile past
            # a buffer: those rows count phase 15's floods, which do
            r["launches"] = rerun_launches.get(k, 0) if k in COUNT_FIRST else launched[k]
            r["launches_of"] = "phase 15 floods" if k in COUNT_FIRST else "warm search"
            rows.append(r)
    check(PKG != ROOT or all(r["launches"] > 0 for r in rows),
          f"kernels launched no time: {[r['name'] for r in rows if not r['launches']]}")
    emit({"kernels": rows, "card": card, "seconds": time.perf_counter() - t_start})
    print(smi())
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
