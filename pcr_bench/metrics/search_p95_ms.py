"""95th percentile (nearest rank) of the window's searches, each timed on
the host clock around ``MerPCR.search`` as its caller sees it."""

import math


def read(run):
    ms = sorted(s.ms for s in run.window)
    if not ms:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
