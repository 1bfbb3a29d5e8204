"""STS file loading + searchable-entry construction.

Replicates every loader quirk of the reference (``engine.py:193-329``), which
is the single source of truth for hit-list equality:

* skip blank lines and '#' comments; line numbers count ALL lines
  (engine.py:216-222)
* a non-comment line with < 4 tab-separated fields fails the WHOLE load
  (engine.py:225-230)
* primers uppercased (engine.py:233-234)
* PCR size: "a-b" -> (a+b)//2; non-positive or unparsable -> default -Z size
  (engine.py:304-322)
* primer shorter than wordsize -> STS dropped entirely (engine.py:241-243)
* len(p1)+len(p2) > pcr_size -> size clamped UP, counted (engine.py:245-247)
* TWO entries per line: forward '+' (primer1, primer2 as written) and
  reverse '-' (primer1 = primer2 as written, primer2 = revcomp(original
  primer1)) — the reference never reverse-complements primer2 for the
  forward record (engine.py:253-281); this "as-written" orientation is part
  of the output contract.
* each entry is keyed by the FIRST ambiguity-free W-mer of its primer1;
  primers with no valid W-mer are dropped per-direction and counted
  (engine.py:264-281, 331-355)

The result keeps both the user-facing ``STSRecord`` list (insertion order ==
the reference's ``sts_records``) and NumPy struct-of-arrays columns that the
table compiler (``merpcr_tpu_torch.ops.table``) turns into device arrays.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..models import STSRecord
from ..ops.encoding import AMBIG, COMPL, SCODE, decode_bytes, encode_bytes

logger = logging.getLogger(__name__)


def _batch_hash(
    pad: np.ndarray, inrow: np.ndarray, wordsize: int
) -> tuple[np.ndarray, np.ndarray]:
    """First-valid-W-mer offset + hash for every row of a padded primer
    byte matrix at once (the batched form of reference engine.py:331-355).

    Returns (offs int64[R] with -1 where no ambiguity-free window exists,
    hashes int64[R] with 0 there). Hash packs 2-bit codes big-endian.
    """
    R, Lmax = pad.shape
    codes = SCODE[pad]
    ok = (codes != AMBIG) & inrow
    if Lmax < wordsize:  # callers filter short primers; degenerate guard
        return np.full(R, -1, dtype=np.int64), np.zeros(R, dtype=np.int64)
    c = np.zeros((R, Lmax + 1), dtype=np.int32)
    np.cumsum(ok, axis=1, out=c[:, 1:])
    wins = c[:, wordsize:] - c[:, :-wordsize]  # (R, Lmax-W+1)
    valid = wins == wordsize
    offs = np.argmax(valid, axis=1).astype(np.int64)
    has = np.take_along_axis(valid, offs[:, None], axis=1)[:, 0]
    cols = offs[:, None] + np.arange(wordsize)[None, :]
    vals = np.take_along_axis(codes, cols, axis=1).astype(np.int64)
    w = (4 ** np.arange(wordsize - 1, -1, -1, dtype=np.int64))[None, :]
    hs = np.where(has, (vals * w).sum(axis=1), 0)
    offs = np.where(has, offs, -1)
    return offs, hs


@dataclass
class STSLoadResult:
    """Parsed STS set: user-facing records + SoA columns for table building."""

    ok: bool = False
    records: List[STSRecord] = field(default_factory=list)
    # Per searchable entry (same order as `records`):
    hashes: np.ndarray = None  # int64[E]  first-valid W-mer hash of entry primer1
    hash_offsets: np.ndarray = None  # int32[E]
    p1_lens: np.ndarray = None  # int32[E]
    p2_lens: np.ndarray = None  # int32[E]
    pcr_sizes: np.ndarray = None  # int32[E]
    # Per-entry primer byte arrays — populated only on hand-built results
    # (the loader leaves these empty and fills p1_pad/p2_pad instead).
    p1_list: List[np.ndarray] = field(default_factory=list)
    p2_list: List[np.ndarray] = field(default_factory=list)
    # Zero-padded (E, Lmax) primer byte matrices (same rows as `records`);
    # lets the table compiler skip a per-entry padding loop.
    p1_pad: np.ndarray = None  # uint8[E, Lmax] | None
    p2_pad: np.ndarray = None  # uint8[E, Lmax] | None
    max_pcr_size: int = 0
    bad_primers_short: int = 0
    bad_primers_ambig: int = 0
    bad_pcr_size: int = 0


def _parse_pcr_size(pcr_size_str: str, default_pcr_size: int) -> int:
    """Reference engine.py:304-322."""
    if "-" in pcr_size_str:
        try:
            size_range = pcr_size_str.split("-")
            if len(size_range) == 2 and size_range[0] and size_range[1]:
                low = int(size_range[0])
                high = int(size_range[1])
                return (low + high) // 2
            return default_pcr_size
        except ValueError:
            return default_pcr_size
    try:
        pcr_size = int(pcr_size_str)
        return pcr_size if pcr_size > 0 else default_pcr_size
    except ValueError:
        return default_pcr_size


class STSLoader:
    """Parses an STS file into searchable entries (reference engine.py:193-302)."""

    @staticmethod
    def load_file(filename: str, wordsize: int, default_pcr_size: int) -> STSLoadResult:
        start_time = time.time()
        res = STSLoadResult()

        file_size = os.path.getsize(filename)
        if file_size == 0:
            logger.error(f"STS file '{filename}' is empty")
            return res

        logger.info(f"Reading STS file: {filename}")

        # Pass 1 (strings): exact reference parse semantics per line; all
        # numeric primer work (encode, first-valid-W-mer hash, revcomp) is
        # deferred and batched across the whole file — per-primer NumPy
        # calls cost more in dispatch overhead than the math itself
        # (~20 us/primer -> the whole-file batch is ~30x cheaper).
        rows: list[tuple] = []  # (sts_id, primer1, primer2, pcr_size, alias, line_no)
        with open(filename, "r") as fh:
            line_no = 0
            for line in fh:
                line_no += 1
                line = line.strip()
                if not line or line.startswith("#"):
                    continue

                fields = line.split("\t")
                if len(fields) < 4:
                    logger.error(
                        f"Bad STS file format at line {line_no}. Expected at least 4 fields."
                    )
                    return STSLoadResult()  # whole load fails (engine.py:225-230)

                sts_id = fields[0]
                primer1 = fields[1].upper()
                primer2 = fields[2].upper()
                pcr_size = _parse_pcr_size(fields[3], default_pcr_size)
                alias = fields[4] if len(fields) > 4 else ""

                if len(primer1) < wordsize or len(primer2) < wordsize:
                    res.bad_primers_short += 1
                    continue

                if len(primer1) + len(primer2) > pcr_size:
                    res.bad_pcr_size += 1
                    pcr_size = len(primer1) + len(primer2)

                if pcr_size > res.max_pcr_size:
                    res.max_pcr_size = pcr_size

                rows.append((sts_id, primer1, primer2, pcr_size, alias, line_no))

        # Pass 2 (batch): pad primers into one (2N, Lmax) byte matrix,
        # compute every first-valid-offset/hash/revcomp in a few NumPy ops.
        N = len(rows)
        if N:
            texts = [r[1] for r in rows] + [r[2] for r in rows]
            flat = encode_bytes("".join(texts))
            lens = np.fromiter(map(len, texts), dtype=np.int64, count=2 * N)
            Lmax = int(lens.max())
            j = np.arange(Lmax)
            inrow = j[None, :] < lens[:, None]
            pad = np.zeros((2 * N, Lmax), dtype=np.uint8)
            pad[inrow] = flat  # row-major fill order == concatenation order

            offs, hs = _batch_hash(pad, inrow, wordsize)
            # revcomp of primer1, per-row reversed within its own length
            rcpad1 = COMPL[pad[:N]]
            ridx = np.clip(lens[:N, None] - 1 - j[None, :], 0, Lmax - 1)
            rcpad1 = np.take_along_axis(rcpad1, ridx, axis=1)
            rcpad1[~inrow[:N]] = 0

            vf = offs[:N] >= 0  # forward entry valid (primer1 hash exists)
            vr = offs[N:] >= 0  # reverse entry valid (primer2 hash exists)
            res.bad_primers_ambig = int(np.sum(~vf) + np.sum(~vr))

            # Interleave entries in reference order: per line, forward
            # ('+') first, then reverse ('-'), skipping invalid directions.
            tag = np.concatenate([
                2 * np.flatnonzero(vf), 2 * np.flatnonzero(vr) + 1
            ])
            tag.sort(kind="stable")
            li = tag >> 1  # line row index per entry
            isr = (tag & 1).astype(bool)  # reverse-direction entry?
            E = len(tag)

            src1 = np.where(isr, li + N, li)  # entry primer1 row in `pad`
            res.hashes = hs[src1]
            res.hash_offsets = offs[src1].astype(np.int32)
            res.p1_lens = lens[src1].astype(np.int32)
            res.p2_lens = lens[np.where(isr, li, li + N)].astype(np.int32)
            res.pcr_sizes = np.fromiter(
                (rows[i][3] for i in li), dtype=np.int32, count=E
            )
            res.p1_pad = pad[src1]
            res.p2_pad = np.where(isr[:, None], rcpad1[li], pad[li + N])
            # p1_list/p2_list stay empty: the table compiler reads the
            # padded matrices directly; the per-entry list form exists
            # only for hand-built STSLoadResults (p1_pad is None).

            rc1_strs = {}
            for k in range(E):
                i = int(li[k])
                sts_id, primer1, primer2, pcr_size, alias, lno = rows[i]
                if isr[k]:
                    s = rc1_strs.get(i)
                    if s is None:
                        s = decode_bytes(rcpad1[i, : lens[i]])
                        rc1_strs[i] = s
                    rec = STSRecord(
                        id=sts_id, primer1=primer2, primer2=s,
                        pcr_size=pcr_size, alias=alias, offset=lno,
                        hash_offset=int(res.hash_offsets[k]), direct="-",
                    )
                else:
                    rec = STSRecord(
                        id=sts_id, primer1=primer1, primer2=primer2,
                        pcr_size=pcr_size, alias=alias, offset=lno,
                        hash_offset=int(res.hash_offsets[k]), direct="+",
                    )
                res.records.append(rec)

        if res.bad_primers_short > 0:
            logger.warning(
                f"{res.bad_primers_short} STSs have primer shorter than word size "
                f"({wordsize}): not included in search"
            )
        if res.bad_primers_ambig > 0:
            logger.warning(
                f"{res.bad_primers_ambig} primers have ambiguities which prevent "
                f"computation of a hash value: not included in search"
            )
        if res.bad_pcr_size > 0:
            logger.warning(
                f"{res.bad_pcr_size} STSs have a primer length sum greater than "
                f"the pcr size: expected pcr size adjusted"
            )

        if not N:
            res.hashes = np.zeros(0, dtype=np.int64)
            res.hash_offsets = np.zeros(0, dtype=np.int32)
            res.p1_lens = np.zeros(0, dtype=np.int32)
            res.p2_lens = np.zeros(0, dtype=np.int32)
            res.pcr_sizes = np.zeros(0, dtype=np.int32)
        res.ok = True

        logger.info(
            f"Loaded {len(res.records)} STS records in "
            f"{time.time() - start_time:.2f} seconds"
        )
        return res
