"""Mean ms per window search inside ``MerPCR._collect``: the waits on the
card, the host reads of each plane, count-first reruns and the rows'
assembly."""


def read(run):
    if not run.window or "collect" not in run.window[0].spans:
        return None
    return sum(s.spans.get("collect", 0.0) for s in run.window) / len(run.window)
