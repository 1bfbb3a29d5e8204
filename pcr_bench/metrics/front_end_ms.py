"""Device ms per traced search of the front-end kernels: every device
operation whose name starts with ``front_end`` (the strict, strict1, loose
and raw front ends), summed from the profiler's trace, over the segment's
searches."""


def read(run):
    t = run.trace
    if t is None or not t.searches:
        return None
    s = sum(v for k, v in t.device_ops.items() if k.startswith("front_end"))
    return s / t.searches * 1e3 if s else None
