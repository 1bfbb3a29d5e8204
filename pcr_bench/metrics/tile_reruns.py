"""Mean tiles rerun count first per window search (``last_scans[*].reruns``:
tiles whose pairs or hits passed the deferred scan's buffers)."""


def read(run):
    if not run.window or "collect" not in run.window[0].spans:
        return None
    return sum(s.reruns for s in run.window) / len(run.window)
