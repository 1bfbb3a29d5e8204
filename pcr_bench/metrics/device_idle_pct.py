"""Share of the traced segment in which no kernel, copy or fill ran on the
card (the union of the profiler's device intervals), in %."""


def read(run):
    t = run.trace
    if t is None or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
