"""FASTA loading, vectorized for whole-genome inputs.

Behavioral contract mirrors the reference ``src/merpcr/io/fasta.py:19-71``:

* empty file -> error log + ``[]``            (fasta.py:32-34)
* a stripped line starting with '>' begins a new record (fasta.py:49-57)
* sequence lines keep only characters whose uppercase is in
  ``ACGTBDHKMNRSVWXY``, original case preserved (fasta.py:60)
* blank lines are skipped (fasta.py:46-47)
* label = first word of the defline sans '>'  (models.py:40-49)

Unlike the reference's per-character Python loop, the filter runs once per
record as a NumPy boolean gather over the joined byte buffer (identical
result: the filter is per-character and newlines/whitespace are removed by
the line split/strip in both implementations).
"""

from __future__ import annotations

import logging
import os
import time
from typing import List

import numpy as np

from ..models import FASTARecord
from ..ops.encoding import FASTA_KEEP

logger = logging.getLogger(__name__)


class FASTALoader:
    """FASTA file loader (API parity with reference fasta.py:15-71)."""

    @staticmethod
    def load_file(filename: str) -> List[FASTARecord]:
        start_time = time.time()
        file_size = os.path.getsize(filename)

        if file_size == 0:
            logger.error(f"FASTA file '{filename}' is empty")
            return []

        logger.info(f"Reading FASTA file: {filename}")

        with open(filename, "rb") as fh:
            data = fh.read()

        records = _parse_segments(data)
        if records is None:  # pathological '>' density: line-loop fallback
            records = _parse_lines(data)

        logger.info(
            f"Loaded {len(records)} sequences in {time.time() - start_time:.2f} seconds"
        )
        return records


def _make_record(defline_bytes: bytes, seg: np.ndarray) -> FASTARecord:
    """Filter a raw segment (newlines/whitespace die in the keep-set filter,
    exactly like the reference's per-line strip + per-char filter) and wrap
    it with the cached byte view the device path reads."""
    from ..native import fasta_filter

    filtered = fasta_filter(seg, FASTA_KEEP)
    rec = FASTARecord(
        defline=defline_bytes.strip().decode("latin-1"),
        sequence=filtered.tobytes().decode("latin-1"),
    )
    # device-path fast access, held with the str it was made from (see
    # record_seq_bytes); the str is kept for the API
    rec._seq_bytes = (rec.sequence, filtered)
    return rec


def _parse_segments(data: bytes) -> "List[FASTARecord] | None":
    """Vectorized parse: one scan finds defline positions ('>' at a line
    start, or preceded only by whitespace — the reference strips each line
    before the startswith('>') test); each record's WHOLE raw segment then
    goes through the byte filter in one native pass. Behaviorally identical
    to the reference's line loop: line splitting/stripping only removes
    whitespace, which the keep-set filter also removes, and non-defline
    lines are sequence lines in both. Returns None when '>' density is
    pathological (not realistic FASTA) so the caller can use the exact
    line-loop fallback."""
    buf = np.frombuffer(data, dtype=np.uint8)
    cand = np.flatnonzero(buf == ord(">"))
    if len(cand) > 100_000:
        return None
    starts: list[int] = []
    for p in cand.tolist():
        if p == 0 or data[p - 1] == 10:  # column 0
            starts.append(p)
        else:  # '>' after only whitespace still deflines (strip semantics)
            ls = data.rfind(b"\n", 0, p) + 1
            if not data[ls:p].strip():
                starts.append(p)
    records: List[FASTARecord] = []
    for i, p in enumerate(starts):
        e = data.find(b"\n", p)
        if e < 0:
            e = len(data)
        nxt = starts[i + 1] if i + 1 < len(starts) else len(data)
        records.append(_make_record(data[p:e], buf[e + 1 : nxt]))
    return records


def _parse_lines(data: bytes) -> List[FASTARecord]:
    """Reference-shaped line loop (fasta.py:19-71) — fallback path."""
    records: List[FASTARecord] = []
    defline: bytes | None = None
    parts: list[bytes] = []

    def flush():
        if defline is None:
            return
        raw = np.frombuffer(b"".join(parts), dtype=np.uint8)
        records.append(_make_record(defline, raw))

    for line in data.split(b"\n"):
        s = line.strip()
        if not s:
            continue
        if s.startswith(b">"):
            flush()
            defline = s
            parts = []
        else:
            parts.append(s)
    flush()
    return records


def record_seq_bytes(record: FASTARecord) -> np.ndarray:
    """uint8 view of a record's sequence, cached on the instance (the loader
    sets it; a record made through the API gets it on first use), so that a
    record's bytes are one array across searches, the key of the engine's
    caches of its raw-byte planes. The cache holds the ``sequence`` string
    it was made from and is used only while ``record.sequence`` is that very
    object (a str is immutable): a record given new bases, even of the same
    length, is encoded anew."""
    cached = getattr(record, "_seq_bytes", None)
    if cached is not None and cached[0] is record.sequence:
        return cached[1]
    seq = np.frombuffer(
        record.sequence.encode("latin-1", errors="replace"), dtype=np.uint8
    )
    record._seq_bytes = (record.sequence, seq)
    return seq


def record_packed(record: FASTARecord):
    """(packed_nibbles | None) for a record, cached on the instance.

    Returns None when the sequence contains bytes outside the 16-letter
    FASTA alphabet (engine then uses the exact byte pipeline). The packed
    array holds the record's 4-bit codes two-per-byte starting at an even
    position boundary (one trailing pad nibble for odd lengths).
    """
    seq = record_seq_bytes(record)
    cached = getattr(record, "_packed_cache", None)
    if cached is not None and cached[0] is seq:  # same string, see above
        return cached[1]
    # deferred imports (native ctypes lib): resolved once, then cached on
    # the module so the per-record fast path above stays import-free —
    # scaffold FASTA calls this thousands of times per search
    global _nibble_pack, _NIB_LUT
    if _nibble_pack is None:
        from ..native import nibble_pack as _np_
        from ..ops.encoding import NIB_LUT as _lut_

        _nibble_pack, _NIB_LUT = _np_, _lut_
    packed = _nibble_pack(seq, _NIB_LUT)
    record._packed_cache = (seq, packed)
    return packed


_nibble_pack = None
_NIB_LUT = None
