#!/usr/bin/env python3
"""One cell of the benchmark (``pcr_bench``) run with the port's per-search
record on, and what the record says beside the harness's own readings:

    python3 pcr_bench/trace_cell.py --workload <cell> --seed <n> --seconds <s> [--cost <s>]

The run is ``run.py``'s ``--trace 1`` run, with three things set from
here and no other file of ``pcr_bench`` changed: the engine's ``tracing``
is set where the harness makes its probe, each window search keeps its
``last_trace``, and the profiled segment's ``merpcr.*`` annotations are
read. run.py's result line is printed as usual; a line
``{"program": ...}`` follows it, with

* ``metrics``: five readings of the window's records (None where the run
  holds nothing for one, as on the CPU: no card, no launch and no wait):
  ``wait_ms`` (mean ``collect.wait`` ms a search), ``launches_per_search``,
  ``launch_us`` (sum of ``dispatch.enqueue`` over sum of launches),
  ``write_us_line`` (sum of ``emit.write`` over sum of lines),
  ``search_cpu_ms`` (mean main-thread CPU ms a search);
* ``idle_gaps_program``: the segment's stretches with nothing on the card,
  cut at every span's edges and each piece put down to the innermost
  ``merpcr.*`` span that holds it, or outside them all to the harness's own
  label (``pcr_bench.<label>``); ``idle_in_leaf_pct``, the share of that
  idle time inside a span with no span inside it;
* ``reconcile``: per search, the share of the ``search`` span its direct
  children cover (least and median); the window means of the program's
  ``dispatch``, ``collect`` and ``emit`` spans beside the harness's
  ``dispatch_ms``, ``collect_ms`` and ``emit_ms``; mean tiles, reruns and
  launches;
* ``cost`` (with ``--cost``): one warm engine searching the cell's settings
  in rounds of tracing off, on, on, off for that many seconds, after the
  run: the median search ms of each side.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from pcr_bench import generate, harness, run, spec  # noqa: E402
from pcr_bench import trace as profiler  # noqa: E402

OUTSIDE = "pcr_bench."  # the harness's label of idle outside every program span
PROGRAM = "merpcr."  # the prefix of the program's spans (merpcr_tpu_torch.trace.PREFIX)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--cost", type=float, default=0.0,
                    help="seconds of tracing off/on rounds after the run (0: none)")
    return ap.parse_args(argv)


def hook() -> dict:
    """Patch the harness from outside: tracing on where the probe is made,
    each probed search keeping its record, the window's run kept, and the
    segment's events read for the program's spans. Returns what the run
    leaves: ``runs`` and the ``Trace`` objects' ``program`` readings."""
    got: dict = {"runs": []}
    probe_init, search, window, read = (harness.Probe.__init__, harness.search,
                                        harness.window, profiler.read)
    gc_ns = [0, 0]  # collections' ns so far, the current one's start

    def gc_clock(phase, _info):
        if phase == "start":
            gc_ns[1] = time.perf_counter_ns()
        else:
            gc_ns[0] += time.perf_counter_ns() - gc_ns[1]

    def traced_probe(self, eng):
        probe_init(self, eng)
        eng.tracing = True

    def kept_search(eng, recs, setting, settings, bases, probe=None):
        g0 = gc_ns[0]
        s = search(eng, recs, setting, settings, bases, probe)
        s.record = eng.last_trace if probe is not None else None
        s.gc_ms = (gc_ns[0] - g0) / 1e6
        return s

    def kept_window(r, *args, **kwargs):
        got["runs"].append(r)
        return window(r, *args, **kwargs)

    def read_program(events):
        t = read(events)
        t.program = idle_by_program_span(events)
        return t

    harness.Probe.__init__ = traced_probe
    harness.search = kept_search
    harness.window = kept_window
    profiler.read = read_program
    gc.callbacks.append(gc_clock)
    return got


def _mean(xs) -> float:
    return sum(xs) / len(xs)


def readings(window: list) -> dict:
    """The five per-search readings over the window's records."""
    recs = [s.record for s in window if getattr(s, "record", None) is not None]
    if not recs:
        return {}
    c = [r.counters for r in recs]
    launches = sum(x["launches"] for x in c)
    lines = sum(x["lines"] for x in c)
    waits = [r.ms("collect.wait") for r in recs]
    return {
        "wait_ms": _mean(waits) if any(s.name == "collect.wait" for r in recs
                                       for s in r.spans) else None,
        "launches_per_search": launches / len(recs) if launches else None,
        "launch_us": sum(r.ms("dispatch.enqueue") for r in recs) * 1e3 / launches
        if launches else None,
        "write_us_line": sum(r.ms("emit.write") for r in recs) * 1e3 / lines if lines else None,
        "search_cpu_ms": _mean([x["cpu_ns"] for x in c]) / 1e6,
    }


def reconcile(r, window: list) -> dict:
    """The record against itself and against the harness's timers."""
    recs = [s.record for s in window if getattr(s, "record", None) is not None]
    if not recs:
        return {}
    cover = []
    for rec in recs:
        root = rec.spans[0]
        kids = sum(s.end_ns - s.start_ns for s in rec.spans if s.parent == 0)
        cover.append(100.0 * kids / (root.end_ns - root.start_ns))
    low = [(round(c, 2), round(s.gc_ms, 3)) for c, s in zip(cover, window)
           if s.record is not None and c < 95.0]
    bench = {m: spec.load(r.cell.dir, "metrics", m).read(r)
             for m in ("dispatch_ms", "collect_ms", "emit_ms")}
    return {
        "children_cover_pct": {"min": min(cover), "median": statistics.median(cover),
                               "searches": len(cover), "under_95": len(low),
                               "under_95_with_gc_ms": low[:10]},
        "gc_ms_per_search": _mean([getattr(s, "gc_ms", 0.0) for s in window]),
        "program_ms": {k: _mean([rec.ms(k) for rec in recs])
                       for k in ("search", "plan", "dispatch", "collect", "emit")},
        "harness_ms": {**bench, "search": _mean([s.ms for s in window])},
        "per_search": {k: _mean([rec.counters[k] for rec in recs])
                       for k in ("tiles", "reruns", "launches", "host_reads", "pairs",
                                 "lines")},
    }


def idle_by_program_span(events: list) -> dict:
    """The traced segment's idle time (nothing on the card) by the
    innermost program span holding it, each idle stretch cut at the spans'
    edges; outside every program span, the harness's label."""
    spans, bench, ops = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        name = e.get("name", "")
        if e.get("cat") in profiler.DEVICE_CATS:
            ops.append((a, b))
        elif e.get("cat") == "user_annotation":
            if name.startswith(PROGRAM):
                spans.append((a, b, name[len(PROGRAM):]))
            elif name.startswith(profiler.PREFIX):
                bench.append((a, b, name[len(profiler.PREFIX):]))
    seg = [(a, b) for a, b, n in bench if n == "segment"]
    if not seg:
        return {}
    lo, hi = seg[0]
    busy = profiler._union((max(a, lo), min(b, hi)) for a, b in ops if b > lo and a < hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
    spans.sort(key=lambda s: (s[0], -s[1]))
    # a span is a leaf when the next span to start does not start inside it
    leaf = [i + 1 == len(spans) or spans[i + 1][0] >= spans[i][1] for i in range(len(spans))]
    host = sorted((s for s in bench if s[2] != "segment"), key=lambda s: (s[0], -s[1]))
    cuts = sorted({x for a, b, _n in spans + host for x in (a, b)})
    gaps: dict = {}
    in_leaf = 0.0
    for a, b in idle:
        points = [a] + [x for x in cuts if a < x < b] + [b]
        for u, v in zip(points, points[1:]):
            mid, inner = (u + v) / 2, None
            for i, (sa, sb, _n) in enumerate(spans):
                if sa > mid:
                    break
                if sb >= mid:
                    inner = i
            if inner is None:
                name = OUTSIDE + profiler._host_at(mid, host)
            else:
                name = spans[inner][2]
                in_leaf += (v - u) * leaf[inner]
            gaps[name] = gaps.get(name, 0.0) + (v - u) / 1e6
    total = sum(gaps.values())
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:12]
    return {"idle_gaps_program": [list(kv) for kv in top], "idle_s": total,
            "idle_in_leaf_pct": 100.0 * in_leaf / 1e6 / total if total else None}


def cost(cell, seed: int, seconds: float, device: str) -> dict:
    """Median search ms (and main-thread CPU ms) of one warm engine with
    tracing off and on, in rounds of off, on, on, off and on, off, off, on
    in turn over ``seconds``; and the recorder's own cost: an empty span,
    and a record's start and stop, in us."""
    from merpcr_tpu_torch import MerPCR
    from merpcr_tpu_torch import trace as program

    cfg = cell.config
    inp = generate.make_inputs(cfg, cell.traffic, seed, cell.dir)
    settings = inp.searches
    eng = MerPCR(wordsize=cfg["wordsize"], margin=settings[0]["margin"],
                 mismatches=settings[0]["mismatches"],
                 three_prime_match=cfg["three_prime_match"], iupac_mode=cfg["iupac_mode"],
                 device=device)
    with tempfile.TemporaryDirectory(prefix="trace_cell_") as tmp:
        sts, fa = generate.write_inputs(tmp, inp)
        if not eng.load_sts_file(sts):
            raise RuntimeError("the STS file did not load")
        recs = eng.load_fasta_file(fa)
    bases = sum(len(r.sequence) for r in recs)
    for i in range(2 * len(settings)):
        harness.search(eng, recs, i % len(settings), settings, bases)
    ms: dict = {False: [], True: []}
    cpu: dict = {False: [], True: []}
    i, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < seconds or not ms[True]:
        for on in ((False, True, True, False), (True, False, False, True))[i // 4 % 2]:
            eng.tracing = on
            c0 = time.thread_time_ns()
            ms[on].append(harness.search(eng, recs, i % len(settings), settings, bases).ms)
            cpu[on].append((time.thread_time_ns() - c0) / 1e6)
            i += 1
    off, on = statistics.median(ms[False]), statistics.median(ms[True])
    rec = program.start()
    n, t1 = 10_000, time.perf_counter_ns()
    for _ in range(n):
        with program.span("x"):
            pass
    span_us = (time.perf_counter_ns() - t1) / n / 1e3
    program.stop(rec, 0, [])
    t1 = time.perf_counter_ns()
    for _ in range(1000):
        program.stop(program.start(), 0, [])
    return {"searches": len(ms[False]) + len(ms[True]), "median_ms_off": off,
            "median_ms_on": on, "on_over_off_pct": 100.0 * (on / off - 1.0),
            "median_cpu_ms_off": statistics.median(cpu[False]),
            "median_cpu_ms_on": statistics.median(cpu[True]),
            "span_us": span_us, "start_stop_us": (time.perf_counter_ns() - t1) / 1000 / 1e3}


def main(argv=None, device=None, root=ROOT) -> int:
    """``run.main`` with the hooks, then the program's line. ``device``
    None: the card; tests pass ``"cpu"`` with a small benchmark's root."""
    args = parse(argv)
    got = hook()
    rc = run.main(["--workload", args.workload, "--seed", str(args.seed),
                   "--seconds", str(args.seconds), "--trace", "1"], device=device, root=root)
    if rc != 0 or not got["runs"]:
        return rc or 1
    r = got["runs"][-1]
    out = {"metrics": readings(r.window), "reconcile": reconcile(r, r.window)}
    if r.trace is not None:
        out.update(getattr(r.trace, "program", {}))
    if args.cost:
        out["cost"] = cost(spec.Cell(root, args.workload), args.seed, args.cost,
                           device or "cuda")
    print(json.dumps({"program": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
