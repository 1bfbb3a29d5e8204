"""Bases of every search completed in the window over the window's seconds,
in Mbp/s: one rate over all the window's work and time."""


def read(run):
    if not run.window_s:
        return None
    return sum(s.bases for s in run.window) / run.window_s / 1e6
