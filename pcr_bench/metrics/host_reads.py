"""Mean host waits on the card per window search: the change in the
program's ``ScanState.reads`` counters over each search."""


def read(run):
    if not run.window or "collect" not in run.window[0].spans:
        return None
    return sum(s.reads for s in run.window) / len(run.window)
