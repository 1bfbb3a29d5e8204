"""``pcr_bench/trace_cell.py``: a benchmark cell run with the port's
per-search record on.

* On a synthetic Chrome trace, an idle stretch inside ``merpcr.emit.write``
  lands under ``emit.write``, one cut by a span edge is split between the
  spans, one outside every program span keeps the harness's label; with
  the hook in place ``pcr_bench.trace.read``'s own ``idle_gaps`` are as
  before.
* A CPU run of a small cell, in a fresh process (the benchmark refuses to
  run with JAX loaded): run.py's line holds every per-layer metric a CPU
  run reads, the program's line the two readings a CPU run has
  (``write_us_line``, ``search_cpu_ms``) and none of those that need the
  card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from pcr_bench import trace as bench_trace
from pcr_bench import trace_cell
from pcr_bench.tests import small



def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_idle_lands_under_the_innermost_program_span():
    events = [
        _x("pcr_bench.segment", 0, 1000),
        _x("pcr_bench.search", 0, 900),
        _x("merpcr.search", 10, 880),
        _x("merpcr.dispatch", 20, 100),
        _x("k", 30, 80, cat="kernel"),
        _x("merpcr.emit", 300, 500),
        _x("merpcr.emit.sort", 300, 50),
        _x("merpcr.emit.write", 400, 390),
    ]
    got = trace_cell.idle_by_program_span(events)
    gaps = dict(got["idle_gaps_program"])
    # 0-10 and 890-900 outside the program's spans, inside the harness's
    # search (its "emit"); 900-1000 between searches
    assert gaps == pytest.approx({
        "pcr_bench.emit": 20e-6, "pcr_bench.between_searches": 100e-6,
        "search": (10 + 180 + 90) * 1e-6, "dispatch": 20e-6, "emit.sort": 50e-6,
        "emit": 60e-6, "emit.write": 390e-6})
    assert got["idle_s"] == pytest.approx(920e-6)
    # leaves: dispatch (a kernel but no span inside it), emit.sort, emit.write
    assert got["idle_in_leaf_pct"] == pytest.approx(100 * (20 + 50 + 390) / 920)


def test_hooked_read_keeps_the_harness_gaps(monkeypatch):
    """The hook adds the program's gaps to ``pcr_bench.trace.read``'s
    ``Trace`` and leaves the harness's own reading as it was."""
    events = [_x("pcr_bench.segment", 0, 1000), _x("pcr_bench.search", 0, 900),
              _x("merpcr.search", 10, 880), _x("merpcr.emit.write", 400, 390),
              _x("k", 30, 80, cat="kernel")]
    plain = bench_trace.read(events)
    for obj, name in ((trace_cell.harness.Probe, "__init__"), (trace_cell.harness, "search"),
                      (trace_cell.harness, "window"), (bench_trace, "read")):
        monkeypatch.setattr(obj, name, getattr(obj, name))  # restored after the test
    trace_cell.hook()
    t = bench_trace.read(events)
    assert t.idle_by_span == plain.idle_by_span == pytest.approx({"emit": 920e-6})
    assert (t.busy_s, t.window_s) == (plain.busy_s, plain.window_s)
    assert t.program == trace_cell.idle_by_program_span(events)
    assert dict(t.program["idle_gaps_program"])["emit.write"] == pytest.approx(390e-6)


def test_cpu_run_prints_the_program_readings(tmp_path):
    code = f"""
import os, sys
sys.path.insert(0, {small.REPO!r})
os.environ["MERPCR_TPU_HOST_MAX"] = "0"
from pcr_bench.tests import small
from pcr_bench import trace_cell
root = small.make_root({str(tmp_path)!r})
sys.exit(trace_cell.main(["--workload", "chr_small.sparse", "--seed", str(2**31 + 7),
                          "--seconds", "0.5"], device="cpu", root=root))
"""
    env = {k: v for k, v in os.environ.items() if k != "MERPCR_TPU_TRACE"}
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    *_, bench_line, program_line = r.stdout.strip().splitlines()
    bench, prog = json.loads(bench_line), json.loads(program_line)["program"]
    assert bench["correct"]
    assert {"search_p95_ms", "dispatch_ms", "emit_ms", "collect_ms", "host_reads",
            "tile_reruns", "pairs_per_search", "sts_compile_s",
            "first_search_s"} == set(bench["metrics"])
    m = prog["metrics"]
    assert m["write_us_line"] > 0 and m["search_cpu_ms"] > 0
    assert m["wait_ms"] is m["launches_per_search"] is m["launch_us"] is None
    rec = prog["reconcile"]
    assert rec["per_search"]["lines"] > 0 and rec["per_search"]["launches"] == 0
    assert 90 < rec["children_cover_pct"]["min"] <= 100
