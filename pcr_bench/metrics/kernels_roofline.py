"""Share of the memory roofline over every launch of the port's kernels in
the traced searches: the least time of the tiles they scanned
(``roofline.least_seconds``) over the kernels' device time, in %."""

from pcr_bench import roofline


def read(run):
    t = run.trace
    if t is None or not t.kernel_s or not run.tiles:
        return None
    return 100.0 * roofline.least_seconds(run.tiles) / t.kernel_s
