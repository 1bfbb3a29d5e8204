"""torch.profiler over the traced searches, and what its trace says.

The harness marks the traced segment and each search, plan, dispatch and
collect with ``record_function`` spans (``pcr_bench.<name>``). From the
exported trace this module reads, inside the segment: every device
operation (kernels, copies, fills), the time some operation ran (their
union), the port's kernels by name, and for each stretch with nothing on the
card the host span it fell in. CUPTI's first start costs seconds, so
``warm`` starts and stops the profiler once during set-up.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STAGES = ("front_end", "expand", "verify_p1", "margin_p2")  # the port's kernels
PREFIX = "pcr_bench."
HOST_SPANS = ("plan", "dispatch", "collect")  # inside a search; the rest is emit


@dataclass
class Trace:
    window_s: float = 0.0  # the traced segment's length
    busy_s: float = 0.0  # time with some device operation running
    kernel_s: float = 0.0  # device time of the port's kernels (a sum)
    device_ops: dict = field(default_factory=dict)  # name -> seconds
    idle_by_span: dict = field(default_factory=dict)  # host span -> idle seconds
    searches: int = 0


def warm() -> None:
    """Start and stop the profiler once, so that the traced segment does not
    pay CUPTI's start."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


@contextmanager
def span(name: str):
    import torch

    with torch.profiler.record_function(PREFIX + name):
        yield


@contextmanager
def traced(out: list):
    """Profile the body; append its ``Trace`` to ``out`` when it ends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with prof:
        with span("segment"):
            yield
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.unlink(path)
    out.append(read(events))


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def read(events: list) -> Trace:
    """The ``Trace`` of a Chrome trace's events (times in microseconds)."""
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            ops.append((a, b, e["name"], e["cat"]))
        elif e.get("cat") == "user_annotation" and e["name"].startswith(PREFIX):
            spans.append((a, b, e["name"][len(PREFIX):]))
    seg = [s for s in spans if s[2] == "segment"]
    if not seg:
        return Trace()
    lo, hi = seg[0][0], seg[0][1]
    t = Trace(window_s=(hi - lo) / 1e6)
    t.searches = sum(1 for s in spans if s[2] == "search")
    inside = [(max(a, lo), min(b, hi), name, cat) for a, b, name, cat in ops if b > lo and a < hi]
    for a, b, name, cat in inside:
        key = name.replace("(anonymous namespace)::", "").removeprefix("void ").split("(")[0][:60]
        t.device_ops[key] = t.device_ops.get(key, 0.0) + (b - a) / 1e6
        if cat == "kernel" and any(s in name for s in STAGES):
            t.kernel_s += (b - a) / 1e6
    busy = _union((a, b) for a, b, _n, _c in inside)
    t.busy_s = sum(b - a for a, b in busy) / 1e6
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host = sorted((s for s in spans if s[2] != "segment"), key=lambda s: (s[0], -s[1]))
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            name = _host_at((a + b) / 2, host)
            t.idle_by_span[name] = t.idle_by_span.get(name, 0.0) + (b - a) / 1e6
    return t


def _host_at(ts: float, host: list) -> str:
    """What the host was doing at ``ts``: the innermost span holding it;
    inside a search but in none of its parts, emit."""
    inner = None
    for a, b, name in host:
        if a > ts:
            break
        if b >= ts:
            inner = name
    if inner is None:
        return "between_searches"
    return inner if inner in HOST_SPANS else "emit"
