"""The per-search trace record: where a search's host time goes, measured
inside the program.

``MerPCR.search`` fills one ``SearchTrace`` when ``MerPCR.tracing`` is set
(or ``MERPCR_TPU_TRACE`` is) and leaves it in ``eng.last_trace``. The
engine, the tile driver (``ops.scan``) and the emission mark their work
with ``span(name)``: one span per search or per plan item, never per
record, tile or line. While a torch profiler runs, each span is also a
``torch.profiler.record_function("merpcr." + name)``, so it shows in the
profiler's Chrome trace beside the kernels, on the profiler's clock.

With no record active, ``span`` returns one shared no-op and reads no
clock: tracing off costs a global read per span site. The counters are
read just outside the ends of the ``search`` span, as the change over the
search of those the port keeps (the wrappers' launch counts, ``ScanState.reads``,
``last_scans``); ``pairs``, ``flagged`` and ``positions`` are added in
``ops.scan.collect_stream`` and ``lines_native`` in the engine's emission
while a record is active.

The recorder is one per process and not thread-safe: the active record is
a module global, so two engines searching at once in two threads, with
tracing on, would put their spans in one record.

This module imports no torch: a host-path search with tracing on never
loads it, and torch is loaded whenever a profiler runs.
"""

from __future__ import annotations

import contextlib
import itertools
import sys
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

PREFIX = "merpcr."
# the kernel wrappers whose launch counts a search reads, by module of
# ``merpcr_tpu_torch.ops``
WRAPPERS = {
    "front_end": ("front_end", "front_end_loose", "front_end_raw"),
    "expand": ("expand", "expand_loose", "expand_raw"),
    "verify_p1": ("verify_p1", "verify_p1_raw"),
    "margin_p2": ("margin_p2", "margin_p2_raw"),
}
_OPS = __name__.rpartition(".")[0] + ".ops."

_clock = time.perf_counter_ns
_active: Optional["SearchTrace"] = None  # the record being filled
_searches = itertools.count(1)  # a search's number in this process


class Span(NamedTuple):
    name: str  # without PREFIX
    parent: int  # index of the enclosing span in ``spans``, -1 for none
    item: Optional[int]  # plan item index, None outside the plan items
    start_ns: int  # time.perf_counter_ns
    end_ns: int


@dataclass
class SearchTrace:
    """One search's spans, in the order they opened, and its counters:
    ``launches`` (and ``launches.<wrapper>`` per stage), ``host_reads``,
    ``tiles`` (and ``front_end.<mode>``, the tiles each front end scanned:
    ``strict0``, ``strict1``, ``loose`` or ``raw``), ``reruns``, ``flagged``
    (the tiles' ``c_total``: units the strict front end flagged, groups the
    loose one did, positions the raw one did), ``positions`` (their
    ``pos_total``: the (unit or group, phase) positions before the t16
    filter, 0 on a raw plane), ``pairs``, ``lines``, ``lines_native`` (the
    lines the native codec formatted) and ``cpu_ns``, the main thread's
    CPU time over the ``search`` span."""

    search: int
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    _open: list = field(default_factory=list, repr=False)  # the open spans, outermost first
    _base: dict = field(default_factory=dict, repr=False)  # counters at the start
    _root: object = field(default=None, repr=False)  # its open search span

    def ms(self, name: str) -> float:
        """Milliseconds of the spans called ``name``, summed."""
        return sum(s.end_ns - s.start_ns for s in self.spans if s.name == name) / 1e6

    def add(self, counter: str, n: int) -> None:
        self.counters[counter] = self.counters.get(counter, 0) + n


_NO_SPAN = contextlib.nullcontext()  # reusable: it keeps no state


class _Span:
    __slots__ = ("rec", "name", "item", "index", "parent", "start", "fn")

    def __init__(self, rec: SearchTrace, name: str, item: Optional[int]):
        self.rec, self.name, self.item = rec, name, item

    def __enter__(self):
        rec = self.rec
        if rec._open:
            up = rec._open[-1]
            self.parent = up.index
            if self.item is None:
                self.item = up.item
        else:
            self.parent = -1
        self.index = len(rec.spans)
        rec.spans.append(None)  # its place in open order, filled when it closes
        rec._open.append(self)
        self.start = _clock()
        self.fn = None
        torch = sys.modules.get("torch")
        if torch is not None and torch.autograd._profiler_enabled():
            self.fn = torch.profiler.record_function(PREFIX + self.name)
            self.fn.__enter__()
        return self

    def __exit__(self, *exc):
        if self.fn is not None:
            self.fn.__exit__(*exc)
        rec = self.rec
        rec.spans[self.index] = Span(self.name, self.parent, self.item, self.start, _clock())
        rec._open.pop()
        return False


def front_end_mode(cfg) -> str:
    """The front end a scan config runs: ``strict0``, ``strict1``,
    ``loose`` or ``raw`` (a raw-byte plane)."""
    if not cfg.packed:
        return "raw"
    return f"strict{cfg.strict_n}" if cfg.strict else "loose"


def span(name: str, item: Optional[int] = None):
    """A context manager that records ``name`` as a span of the active
    record, inside the innermost open span; ``item`` is the plan item it
    works on (default: its parent's). The shared no-op without a record."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name, item)


def active() -> Optional[SearchTrace]:
    """The record being filled, or None."""
    return _active


def _launches() -> dict:
    """Each wrapper's launches so far, read only from the wrapper modules
    already loaded (a host-path search loads none)."""
    out = {}
    for mod, names in WRAPPERS.items():
        m = sys.modules.get(_OPS + mod)
        if m is not None:
            for n in names:
                w = getattr(m, n, None)
                out[n] = getattr(w, "launches", 0) + getattr(w, "launches_deferred", 0)
    return out


def _host_reads() -> int:
    k = sys.modules.get(_OPS + "kernels")
    return 0 if k is None else sum(st.reads for st in k._STATES.values())


def start() -> SearchTrace:
    """Make a fresh record the active one and open its ``search`` span,
    the counters read just before it opens."""
    global _active
    rec = SearchTrace(next(_searches))
    rec._base = {"launches": _launches(), "host_reads": _host_reads(),
                 "cpu_ns": time.thread_time_ns()}
    rec._root = _Span(rec, "search", None)
    rec._root.__enter__()
    _active = rec
    return rec


def stop(rec: SearchTrace, lines: int, scans) -> SearchTrace:
    """Close the record's ``search`` span, make no record active and read
    the counters' change over the search. ``lines``: the hit lines
    emitted; ``scans``: the search's ``last_scans``."""
    global _active
    try:
        rec._root.__exit__(None, None, None)
    finally:
        _active = rec._root = None
    c, base = rec.counters, rec._base
    c["cpu_ns"] = time.thread_time_ns() - base["cpu_ns"]
    per = {n: v - base["launches"].get(n, 0) for n, v in _launches().items()}
    c["launches"] = sum(per.values())
    c.update((f"launches.{n}", v) for n, v in per.items() if v)
    c["host_reads"] = _host_reads() - base["host_reads"]
    c["tiles"] = sum(p.tiles for p in scans)
    for p in scans:
        rec.add(f"front_end.{front_end_mode(p.cfg)}", p.tiles)
    c["reruns"] = sum(len(p.reruns) for p in scans)
    for k in ("pairs", "flagged", "positions"):
        c.setdefault(k, 0)
    c.setdefault("lines_native", 0)
    c["lines"] = lines
    return rec
