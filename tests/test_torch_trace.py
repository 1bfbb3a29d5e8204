"""The port's per-search trace record (``merpcr_tpu_torch/trace.py``).

* Tracing off, ``last_trace`` is None and no span site reads the clock.
* Tracing on, on the device path (the plain kernel versions): the spans
  nest as the engine, the tile driver and the emission open them, the
  counters equal what the search did (``last_scans``, the lines printed),
  and the bytes equal those of the same search untraced, on the golden
  corpus and on a plan of a lone record, an empty record and a stream
  run; shrunk buffers give the rerun span.
* One engine at -N 0, 1, 1 and 2 runs the strict0, strict1 and loose
  front ends: ``flagged`` and ``positions`` are the sums of the tiles'
  ``c_total`` and ``pos_total``, ``front_end.<mode>`` counts the tiles, and
  ``table.strict1`` spans the strict1 build in the first -N 1 search alone.
* Each search has the next number; a search that raises leaves no record
  active.
* ``MERPCR_TPU_TRACE``: the Chrome trace holds every span of the record,
  each inside its parent, with the record's duration.
* A host-path search with tracing on loads no torch.

Nothing here compares with the JAX package: the port traced against the
port untraced, tolerance 0 on bytes and counts.
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from collections import Counter
from contextlib import redirect_stdout

import pytest

from merpcr_tpu_torch import MerPCR, engine, trace
from merpcr_tpu_torch.ops import expand as expand_mod
from merpcr_tpu_torch.ops import margin_p2 as margin_mod
from merpcr_tpu_torch.ops import scan as scan_mod

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS
from .test_torch_stream import write_corpus

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# each span's parent, as the engine, ops.scan and the emission open them
PARENT = {"plan": "search", "dispatch": "search", "collect": "search", "emit": "search",
          "dispatch.upload": "dispatch", "dispatch.enqueue": "dispatch",
          "dispatch.host_scan": "dispatch", "collect.wait": "collect",
          "collect.rerun": "collect", "collect.rows": "collect", "emit.sort": "emit",
          "emit.write": "emit", "table.strict1": "dispatch"}


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    monkeypatch.delenv("MERPCR_TPU_TRACE", raising=False)
    engine._OWNERS.clear()  # uploads happen in the first search of each test


def _out(eng, recs) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs)
    return buf.getvalue()


def _engine(sts, fa, **params):
    eng = MerPCR(device="cpu", **params)
    assert eng.load_sts_file(str(sts))
    return eng, eng.load_fasta_file(str(fa))


def _stream_corpus(tmp_path):
    """A lone record, an empty record, then a run of three scaffolds: three
    plan items, one of them a stream plane of three records."""
    return write_corpus(tmp_path, 41, [60_000, 0, 3_000, 4_500, 2_200], n_sts=30)


def _check_nesting(rec: trace.SearchTrace, n_items: int) -> None:
    spans = rec.spans
    assert spans[0].name == "search" and spans[0].parent == -1
    assert all(s.parent >= 0 for s in spans[1:])
    for s in spans[1:]:
        p = spans[s.parent]
        assert p.name == PARENT[s.name], (s.name, p.name)
        assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, s.name
        if p.name != "search":
            assert s.item == p.item
    names = Counter(s.name for s in spans)
    assert names["plan"] == 1
    for name in ("dispatch", "collect", "emit", "emit.sort", "emit.write"):
        assert names[name] == n_items, name
    for name in ("dispatch", "collect", "emit"):
        assert sorted(s.item for s in spans if s.name == name) == list(range(n_items))
    # the search's direct children cover it, but for a few statements
    root = spans[0].end_ns - spans[0].start_ns
    assert sum(s.end_ns - s.start_ns for s in spans if s.parent == 0) <= root


@pytest.mark.parametrize("corpus", ["golden", "stream"])
def test_traced_search_spans_counters_and_bytes(tmp_path, corpus):
    sts, fa = (GOLDEN_STS, GOLDEN_FA) if corpus == "golden" else _stream_corpus(tmp_path)
    eng, recs = _engine(sts, fa)
    eng.tracing = True
    traced = _out(eng, recs)
    rec = eng.last_trace
    assert rec is not None and trace.active() is None
    plan = eng._plan(recs)
    _check_nesting(rec, len(plan))
    names = {s.name for s in rec.spans}
    assert "dispatch.upload" in names and "dispatch.enqueue" in names  # a first search
    assert "collect.wait" not in names  # the CPU has no event to wait on
    c = rec.counters
    assert c["lines"] == traced.count("\n") == eng.total_hits > 0
    assert c["tiles"] == sum(p.tiles for p in eng.last_scans) > 0
    assert c["reruns"] == sum(len(p.reruns) for p in eng.last_scans) == 0
    assert c["pairs"] > 0 and c["cpu_ns"] > 0
    assert c["launches"] == 0 and c["host_reads"] == 0  # plain versions: no launch
    eng.tracing = False
    assert _out(eng, recs) == traced and eng.last_trace is None
    if corpus == "golden":
        assert traced == GOLDEN_LINE + "\n"
    eng.tracing = True
    assert _out(eng, recs) == traced
    assert "dispatch.upload" not in {s.name for s in eng.last_trace.spans}  # kept planes


def test_tracing_off_reads_no_clock(monkeypatch, tmp_path):
    def refuse():
        raise AssertionError("a span read the clock")

    eng, recs = _engine(*_stream_corpus(tmp_path))
    monkeypatch.setattr(trace, "_clock", refuse)
    assert _out(eng, recs).count("\n") > 0
    assert eng.last_trace is None and trace.active() is None
    eng.tracing = True
    with pytest.raises(AssertionError, match="read the clock"):
        _out(eng, recs)
    assert trace.active() is None  # the search's record did not outlive it


@pytest.mark.parametrize("stream", [False, True])
def test_shrunk_buffers_record_the_rerun(tmp_path, monkeypatch, stream):
    lengths = [2_000, 3_000, 2_500, 4_000] if stream else [40_000]
    sts, fa = write_corpus(tmp_path, 59, lengths, n_sts=40)
    eng, recs = _engine(sts, fa, margin=120)
    eng._tile_len_override = 1 << 12
    want = _out(eng, recs)
    monkeypatch.setattr(expand_mod, "_pair_cap_override", 3)
    monkeypatch.setattr(margin_mod, "ROW_CAP", 1)
    eng.tracing = True
    assert _out(eng, recs) == want
    rec = eng.last_trace
    (scan,) = eng.last_scans
    assert rec.counters["reruns"] == len(scan.reruns) > 0
    assert rec.counters["tiles"] == scan.tiles
    (rerun,) = [s for s in rec.spans if s.name == "collect.rerun"]
    assert rec.spans[rerun.parent].name == "collect"
    _check_nesting(rec, 1)


@pytest.mark.parametrize("rerun", [False, True])
def test_front_end_counters_and_strict1_span(tmp_path, monkeypatch, rerun):
    """-N 0, 1, 1, 2 on one traced engine: each search's ``flagged`` and
    ``positions`` are the sums of ``c_total`` and ``pos_total`` over the
    tiles ``collect_stream`` returned (rerun tiles included), and its one
    front end's ``front_end.<mode>`` counts them; the strict1 build is one
    ``table.strict1`` span, inside the dispatch of the first -N 1 search.
    The bytes are those of an untraced engine's search."""
    sts, fa = write_corpus(tmp_path, 73, [50_000], n_sts=40)
    (eng, recs), (plain, precs) = _engine(sts, fa), _engine(sts, fa)
    eng._tile_len_override = plain._tile_len_override = 1 << 13  # several tiles
    if rerun:
        monkeypatch.setattr(expand_mod, "_pair_cap_override", 3)
    outs = []
    real = scan_mod.collect_stream

    def collect(p):
        got, reruns = real(p)
        outs.extend(got)
        return got, reruns

    monkeypatch.setattr(scan_mod, "collect_stream", collect)
    eng.tracing = True
    builds = []
    for n, mode in ((0, "strict0"), (1, "strict1"), (1, "strict1"), (2, "loose")):
        eng.mismatches = plain.mismatches = n
        want = _out(plain, precs)
        outs.clear()
        assert _out(eng, recs) == want and want.count("\n") > 0
        rec, (scan,) = eng.last_trace, eng.last_scans
        _check_nesting(rec, 1)
        c = rec.counters
        assert trace.front_end_mode(scan.cfg) == mode
        assert c[f"front_end.{mode}"] == c["tiles"] == scan.tiles == len(outs) > 1
        assert [k for k in c if k.startswith("front_end.")] == [f"front_end.{mode}"]
        assert c["flagged"] == sum(o.c_total for o in outs) > 0
        assert c["positions"] == sum(o.pos_total for o in outs) > 0
        assert c["pairs"] == sum(o.pair_total for o in outs) > 0
        assert (c["reruns"] > 0) == rerun and c["host_reads"] == 0  # the CPU waits on none
        builds.append([rec.spans[s.parent].name for s in rec.spans if s.name == "table.strict1"])
    assert builds == [[], ["dispatch"], [], []] and eng._meta.strict1


def test_search_numbers_rise_by_one(tmp_path):
    eng, recs = _engine(GOLDEN_STS, GOLDEN_FA)
    eng.tracing = True
    seen = []
    for _ in range(3):
        _out(eng, recs)
        seen.append(eng.last_trace.search)
    other, orecs = _engine(GOLDEN_STS, GOLDEN_FA)
    other.tracing = True
    _out(other, orecs)
    seen.append(other.last_trace.search)
    assert seen == list(range(seen[0], seen[0] + 4))


def _disagreements(events: list, rec: trace.SearchTrace) -> list:
    """The spans of ``rec`` whose Chrome-trace annotation is not inside its
    parent's, or whose length differs from the record's by more than 10 %
    or 50 us."""
    ours = sorted((e for e in events if e.get("ph") == "X"
                   and e.get("name", "").startswith(trace.PREFIX)),
                  key=lambda e: (float(e["ts"]), -float(e["dur"])))
    assert [e["name"][len(trace.PREFIX):] for e in ours] == [s.name for s in rec.spans]
    assert {"merpcr.search", "merpcr.emit.write", "merpcr.collect.rows",
            "merpcr.dispatch.enqueue"} <= {e["name"] for e in ours}
    bad = []
    for e, s in zip(ours, rec.spans):
        a, dur = float(e["ts"]), float(e["dur"])
        dur_us = (s.end_ns - s.start_ns) / 1e3
        if abs(dur - dur_us) > max(0.1 * dur_us, 50.0):
            bad.append((s.name, dur, dur_us))
        if s.parent >= 0:
            pa, pdur = float(ours[s.parent]["ts"]), float(ours[s.parent]["dur"])
            assert pa - 1 <= a and a + dur <= pa + pdur + 1, s.name
    return bad


def test_chrome_trace_holds_the_spans(tmp_path, monkeypatch):
    """``MERPCR_TPU_TRACE`` turns the record on; its spans are the trace's
    ``merpcr.*`` annotations, each inside its parent, of the record's
    length within 10 % or 50 us. The first traced search is not compared
    (the process's first ``record_function`` pays torch's one-time op
    lookups), and of up to three later ones, one must agree in every span:
    the host being taken off the CPU between the record's clock and the
    profiler's stamp splits the two in a search now and then."""
    eng, recs = _engine(*_stream_corpus(tmp_path))
    want = _out(eng, recs)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MERPCR_TPU_TRACE", str(trace_dir))
    assert _out(eng, recs) == want
    seen = []
    for n in range(2, 5):
        assert _out(eng, recs) == want
        rec = eng.last_trace
        assert rec is not None and not eng.tracing
        names = sorted(os.listdir(trace_dir),
                       key=lambda f: int(f.split("_")[-1].split(".")[0]))
        assert len(names) == n
        with open(trace_dir / names[-1]) as fh:
            seen.append(_disagreements(json.load(fh)["traceEvents"], rec))
        if not seen[-1]:
            break
    assert not seen[-1], seen


def test_host_path_tracing_loads_no_torch(tmp_path):
    """A default-gate golden search with tracing on, in a fresh process:
    the host path's spans, no launch and no torch."""
    code = f"""
import sys
from merpcr_tpu_torch import MerPCR
eng = MerPCR(device="cpu")
eng.tracing = True
assert eng.load_sts_file({GOLDEN_STS!r})
assert eng.search(eng.load_fasta_file({GOLDEN_FA!r}), {str(tmp_path / "out.txt")!r}) == 1
rec = eng.last_trace
names = sorted({{s.name for s in rec.spans}})
assert names == ["collect", "dispatch", "dispatch.host_scan", "emit", "emit.sort",
                 "emit.write", "plan", "search"], names
c = rec.counters
assert (c["launches"], c["host_reads"], c["tiles"], c["lines"]) == (0, 0, 0, 1), c
assert "torch" not in sys.modules
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MERPCR_TPU_HOST_MAX", "MERPCR_TPU_PLATFORM", "MERPCR_TPU_TRACE")}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    assert (tmp_path / "out.txt").read_text() == GOLDEN_LINE + "\n"
