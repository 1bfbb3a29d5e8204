"""The port's hit-line emission (``MerPCR._write_hits``, ``native.format_hits``).

Every case holds the bytes to the per-line formula the engine used to
print, written out here as the reference (``old_lines``): one
``print(f"{label}\\t{pos1 + 1}..{pos2 + 1}\\t{sts.id}\\t{sts.alias}\\t({sts.direct})")``
a row, over NumPy int64 rows. Each runs with the native codec and with
``native.get_lib`` patched to return None (the Python join), tolerance 0.

* One plan item: random rows past one ``EMIT_ROWS`` chunk; a stream item of
  several records, some with no rows; non-ASCII and surrogate labels and
  aliases; positions at 0, 2^31 - 1, 2^31, 2^40 and the int64 ends; both
  ``direct`` values.
* ``format_hits``'s digits against ``str(int)`` over the int64 range.
* ``MerPCR.search`` on the host path, and on the device path's plain
  kernels over a stream item of three records: the same bytes to a file and
  to a redirected stdout, equal to the formula over ``host_scan_record``'s
  rows.
* The line tails are built anew after an STS reload or a reassigned
  ``sts_records``; ``lines_native`` counts the lines the codec wrote.
"""

from __future__ import annotations

import dataclasses
import io
import locale
import types
from contextlib import redirect_stdout

import numpy as np
import pytest

from merpcr_tpu_torch import MerPCR, native
from merpcr_tpu_torch.engine import EMIT_ROWS
from merpcr_tpu_torch.io.fasta import record_seq_bytes
from merpcr_tpu_torch.models import STSRecord
from merpcr_tpu_torch.ops.host_scan import host_scan_record

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
I64 = np.iinfo(np.int64)
EDGES = [0, 2**31 - 1, 2**31, 2**40, I64.max - 1, I64.max, I64.min, -1, -2**31]


@pytest.fixture(params=["native", "fallback"])
def path(request, monkeypatch):
    """The codec's formatter, or the Python join with the codec patched away."""
    if request.param == "native":
        assert native.get_lib() is not None, "g++ codec should build when g++ exists"
    else:
        monkeypatch.setattr(native, "get_lib", lambda: None)
    return request.param


def old_lines(labelled, e2r, sts_records) -> str:
    """The engine's former emission loop, row by row."""
    out = io.StringIO()
    with np.errstate(over="ignore"):  # int64 max + 1 wraps, as it did
        for label, arr in labelled:
            for pos1, pos2, entry, _t, _o, _r in arr:
                sts = sts_records[int(e2r[int(entry)])]
                print(f"{label}\t{pos1 + 1}..{pos2 + 1}\t{sts.id}\t{sts.alias}\t({sts.direct})",
                      file=out)
    return out.getvalue()


def _sts(n: int, rng, odd: str = "") -> list:
    return [STSRecord(id=f"S{i}{odd if i % 3 == 0 else ''}", primer1="ACGTACGTACGT",
                      primer2="TTGCATTGCATT", pcr_size=200,
                      alias=f"alias {i}{odd if i % 2 else ''}", direct="+-"[int(rng.integers(2))])
            for i in range(n)]


def _rows(rng, n: int, n_entries: int, positions=None) -> np.ndarray:
    pos1 = (np.sort(rng.integers(0, 2**28, n)) if positions is None
            else np.asarray(positions, dtype=np.int64))
    n = len(pos1)
    pos2 = pos1 + rng.integers(100, 400, n)
    if positions is not None:
        pos2 = pos1[::-1].copy()
    entry = rng.integers(0, n_entries, n)
    return np.stack([pos1, pos2, entry, np.zeros(n, np.int64), np.arange(n),
                     np.zeros(n, np.int64)], axis=1).astype(np.int64)


def _engine(sts_records, rng, n_entries: int) -> MerPCR:
    eng = MerPCR(device="cpu")
    eng.sts_records = sts_records
    eng._meta = types.SimpleNamespace(
        entry_to_record=rng.integers(0, len(sts_records), n_entries).astype(np.int32))
    return eng


ITEMS = {
    # (labels, rows per record, STS text suffix)
    "random": (["chr1"], [EMIT_ROWS + 4_465], ""),
    "stream": ([f"scaf{i}" for i in range(7)], [3, 0, 0, 41, 1, 0, 17], ""),
    "non_ascii": (["chré_ÿ", "染色体", "\udcff\ud800x", ""], [5, 0, 9, 4], " éé✓😀\udc80"),
    "edges": (["edge"], [len(EDGES)], ""),
}


@pytest.mark.parametrize("item", sorted(ITEMS))
def test_item_lines_equal_old_formula(path, item):
    rng = np.random.default_rng(sorted(ITEMS).index(item) + 11)
    labels, counts, odd = ITEMS[item]
    n_entries = 64
    eng = _engine(_sts(20, rng, odd), rng, n_entries)
    labelled = [(lab, _rows(rng, k, n_entries, EDGES if item == "edges" else None))
                for lab, k in zip(labels, counts) if k]
    assert {s.direct for s in eng.sts_records} == {"+", "-"}
    out = io.StringIO()
    eng._write_hits(out, labelled)
    want = old_lines(labelled, eng._meta.entry_to_record, eng.sts_records)
    assert out.getvalue() == want
    assert want.count("\n") == sum(counts)


def test_digits_equal_str_int():
    assert native.get_lib() is not None
    rng = np.random.default_rng(5)
    vals = np.concatenate([np.array(EDGES + [9, 10, 99, 100, -9, -10, 10**18, -10**18],
                                    dtype=np.int64),
                           rng.integers(I64.min, I64.max, 2_000, dtype=np.int64, endpoint=True),
                           rng.integers(-10**6, 10**6, 2_000)]).astype(np.int64)
    n = len(vals)
    labels, tails = native.Texts(["L\t", "é\t"]), native.Texts(["\tx\n", "\t\udcff\n", "\n"])
    rec, entry = np.arange(n) % 2, np.arange(n) % 3
    got = native.format_hits(vals, vals[::-1], entry, rec, labels, tails)
    want = "".join(f"{labels.text[r]}{a}..{b}{tails.text[e]}"
                   for a, b, e, r in zip(vals.tolist(), vals[::-1].tolist(), entry, rec))
    assert got == want


def test_format_hits_refuses_bad_rows():
    labels, tails = native.Texts(["L\t"]), native.Texts(["\tx\n"])
    one = np.zeros(1, np.int64)
    with pytest.raises(IndexError):
        native.format_hits(one, one, one + 1, one, labels, tails)
    with pytest.raises(IndexError):
        native.format_hits(one, one, one, one - 1, labels, tails)
    with pytest.raises(ValueError):
        native.format_hits(one, np.zeros(2, np.int64), one, one, labels, tails)
    assert native.format_hits(one[:0], one[:0], one[:0], one[:0], labels, tails) == ""


# ------------------------------------------------------------ whole searches
def _corpus(tmp_path, seed: int, alias_tag: str = ""):
    """An STS file of 30 markers (non-ASCII aliases) and three records, a
    latin-1 label among them; every other marker planted in record 0 or 2
    in either orientation, a slot of 450 bases each, record 1 without
    plants."""
    rng = np.random.default_rng(seed)
    recs = [rng.choice(ACGT, size=n) for n in (9_000, 4_000, 7_000)]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    lines = []
    for i in range(30):
        p1, p2 = (rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes() for _ in range(2))
        size = int(rng.integers(100, 400))
        lines.append(f"M{i}\t{p1.decode()}\t{p2.decode()}\t{size}\t(D{i}S{alias_tag}é ✓)\n")
        if i % 2:
            continue
        seq = recs[2 * (i % 4 == 0)]
        left, right = (p1, p2) if i % 3 else (p2, p1.translate(comp)[::-1])
        amp = left + rng.choice(ACGT, size=size - len(p1) - len(p2)).tobytes() + right
        at = 450 * (i // 4) + int(rng.integers(0, 450 - size))  # no two overlap
        seq[at : at + size] = np.frombuffer(amp, dtype=np.uint8)
    sts = tmp_path / f"m{alias_tag}.sts"
    sts.write_text("".join(lines), encoding=locale.getpreferredencoding(False))
    fa = tmp_path / "g.fa"
    fa.write_bytes(b"".join(b">" + lab + b" x\n" + r.tobytes() + b"\n" for lab, r in
                            zip((b"chr\xe9A", b"empty", b"chrB"), recs)))
    return sts, fa


def _host_lines(eng, recs) -> str:
    """The formula over the host path's rows, sorted as the engine sorts."""
    labelled = []
    for r in recs:
        arr = host_scan_record(eng._table_host, eng._meta, record_seq_bytes(r), eng.margin,
                               eng.mismatches, eng.three_prime_match)
        arr = arr[np.lexsort((arr[:, 5], arr[:, 4], arr[:, 3], arr[:, 0]))]
        labelled.append((r.label, arr))
    return old_lines(labelled, eng._meta.entry_to_record, eng.sts_records)


def _both(eng, recs, tmp_path) -> tuple:
    out = tmp_path / "hits.txt"
    eng.search(recs, str(out))
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs)
    return out.read_text(encoding=locale.getpreferredencoding(False)), buf.getvalue()


@pytest.mark.parametrize("corpus", ["golden", "planted", "stream"])
def test_search_bytes_to_file_and_stdout(path, corpus, tmp_path, monkeypatch):
    if corpus == "stream":  # the device path's plain kernels: one item of three records
        monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    else:  # the host path: an item per record
        monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    sts, fa = (GOLDEN_STS, GOLDEN_FA) if corpus == "golden" else _corpus(tmp_path, 3)
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(str(sts))
    recs = eng.load_fasta_file(str(fa))
    to_file, to_stdout = _both(eng, recs, tmp_path)
    if corpus == "stream":
        assert [(p.cfg.stream, p.records) for p in eng.last_scans] == [(True, 3)]
    else:
        assert not eng._tables and not eng.last_scans  # no device path ran
    assert to_file == to_stdout == _host_lines(eng, recs)
    if corpus == "golden":
        assert to_file == GOLDEN_LINE + "\n"
    else:
        assert to_file.count("\n") == eng.total_hits >= 12
        assert "chréA\t" in to_file and "é ✓)\t(-)\n" in to_file


@pytest.mark.parametrize("change", ["reload", "reassign"])
def test_tails_follow_the_sts_set(change, tmp_path, monkeypatch):
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    sts, fa = _corpus(tmp_path, 4)
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(str(sts))
    recs = eng.load_fasta_file(str(fa))
    first = _both(eng, recs, tmp_path)[0]
    tails = eng._tails
    assert first == _host_lines(eng, recs) and "new" not in first
    if change == "reload":  # the same markers under other aliases
        text = sts.read_text(encoding=locale.getpreferredencoding(False))
        sts2 = tmp_path / "m2.sts"
        sts2.write_text(text.replace("é ✓)", "new)"), encoding=locale.getpreferredencoding(False))
        assert eng.load_sts_file(str(sts2))
    else:
        eng.sts_records = [dataclasses.replace(s, alias=f"new {s.alias}")
                           for s in eng.sts_records]
    second = _both(eng, recs, tmp_path)[0]
    assert eng._tails is not tails
    assert second == _host_lines(eng, recs) != first
    assert second.count("\n") == first.count("\n") == second.count("new")


def test_lines_native_counter(path, tmp_path, monkeypatch):
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    sts, fa = _corpus(tmp_path, 3)
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(str(sts))
    recs = eng.load_fasta_file(str(fa))
    eng.tracing = True
    lines = _both(eng, recs, tmp_path)[1].count("\n")
    c = eng.last_trace.counters
    assert c["lines"] == lines == eng.total_hits > 0
    assert c["lines_native"] == (lines if path == "native" else 0)
    eng.search(recs[1:2], str(tmp_path / "none.txt"))  # a record without hits
    assert eng.last_trace.counters["lines_native"] == eng.last_trace.counters["lines"] == 0
