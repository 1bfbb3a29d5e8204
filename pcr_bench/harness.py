"""The pieces the loops (``loops/<loop>.py``) drive the program under test
(``merpcr_tpu_torch``) with: one search with its lines caught in memory in
place of ``sys.stdout``, the measured window, and the traced segment. In a
traced run the harness times, from outside the program, each search and the engine's plan,
dispatch and collect (``MerPCR._plan``, ``_dispatch_item``, ``_collect``),
reads the host's waits on the card (``ScanState.reads``), the tiles rerun
count first (``last_scans[*].reruns``) and each tile's stage totals (from
``ops.scan.collect_stream``), and profiles a segment of searches after the
window.
"""

from __future__ import annotations

import contextlib
import io
import time
from dataclasses import dataclass, field

from . import trace


@dataclass
class Search:
    setting: int  # index into the traffic's searches
    ms: float
    bases: int
    text: str
    spans: dict = field(default_factory=dict)  # plan, dispatch, collect ms
    reads: int = 0
    reruns: int = 0
    pairs: int = 0


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    cell: object
    seconds: float
    setup_s: float = 0.0
    setup_spans: dict = field(default_factory=dict)  # sts_compile_s, first_search_s
    window_s: float = 0.0
    window: list = field(default_factory=list)  # Search per window search
    segment: list = field(default_factory=list)  # Search per traced search
    tiles: list = field(default_factory=list)  # (packed, n_scan, hits) in the segment
    trace: object = None  # trace.Trace of the segment
    peak_bytes: int = 0
    steps: dict = field(default_factory=dict)  # set-up's steps, seconds
    info: dict = field(default_factory=dict)  # what the loop reports beside the metrics
    texts: dict = field(default_factory=dict)  # setting index -> its first search's lines

    def keep(self, s: Search, into: list) -> None:
        """Append ``s`` to ``into``; lines equal to the first of its setting
        share that one string, so the window holds one copy of each."""
        first = self.texts.setdefault(s.setting, s.text)
        if s.text == first:
            s.text = first
        into.append(s)


class Probe:
    """The traced run's instruments on one engine: spans around its plan,
    dispatch and collect, and the counters around each search."""

    def __init__(self, eng):
        from merpcr_tpu_torch.ops import kernels, scan

        self.kernels = kernels
        self.scan = scan
        self.spans: dict = {}
        self.pairs = 0
        self.tiles = None  # a list while the profiled segment runs
        for method, name in (("_plan", "plan"), ("_dispatch_item", "dispatch"),
                             ("_collect", "collect")):
            setattr(eng, method, self._timed(getattr(eng, method), name))
        real = self.real = scan.collect_stream

        def collect_stream(p, _real=real):
            outs, reruns = _real(p)
            L = p.cfg.tile_len
            for t, o in enumerate(outs):
                self.pairs += o.pair_total
                if self.tiles is not None:
                    n_scan = min(max(p.total_scan - (p.start + t * L), 0), L)
                    self.tiles.append((p.cfg.packed, n_scan, o.hit_total))
            return outs, reruns

        scan.collect_stream = collect_stream

    def _timed(self, fn, name: str):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                with trace.span(name):
                    return fn(*args, **kwargs)
            finally:
                self.spans[name] = self.spans.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return timed

    def close(self) -> None:
        """Give the program its own ``collect_stream`` back."""
        self.scan.collect_stream = self.real

    def reads(self) -> int:
        return sum(s.reads for s in self.kernels._STATES.values())


def apply(eng, setting: dict) -> None:
    eng.mismatches = setting["mismatches"]
    eng.margin = setting["margin"]


def search(eng, recs, setting: int, settings: list, bases: int, probe=None) -> Search:
    """One search of ``recs`` at ``settings[setting]``, its lines kept."""
    apply(eng, settings[setting])
    sink = io.StringIO()
    if probe is not None:
        probe.spans, probe.pairs = {}, 0
        reads = probe.reads()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(sink):
        if probe is not None:
            with trace.span("search"):
                eng.search(recs)
        else:
            eng.search(recs)
    ms = (time.perf_counter() - t0) * 1e3
    s = Search(setting, ms, bases, sink.getvalue())
    if probe is not None:
        s.spans = probe.spans
        s.reads = probe.reads() - reads
        s.reruns = sum(len(p.reruns) for p in eng.last_scans)
        s.pairs = probe.pairs
    return s


def window(run: Run, eng, recs, settings: list, bases: int, start: int,
           probe=None) -> int:
    """Search in a closed loop for ``run.seconds``, from setting ``start``
    on; returns the next setting's index."""
    i = start
    t0 = time.perf_counter()
    while True:
        run.keep(search(eng, recs, i % len(settings), settings, bases, probe), run.window)
        i += 1
        if time.perf_counter() - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    return i


def segment(run: Run, eng, recs, settings: list, bases: int, start: int,
            probe, count: int) -> None:
    """``count`` searches under the profiler, after the window."""
    out = []
    probe.tiles = run.tiles
    with trace.traced(out):
        for i in range(start, start + count):
            run.keep(search(eng, recs, i % len(settings), settings, bases, probe), run.segment)
    probe.tiles = None
    run.trace = out[0]
