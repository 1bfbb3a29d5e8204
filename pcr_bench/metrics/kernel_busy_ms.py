"""Device ms per traced search of the port's kernels (front end, expand,
verify_p1, margin_p2 and their forms), summed from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or not t.kernel_s or not run.segment:
        return None
    return t.kernel_s / len(run.segment) * 1e3
