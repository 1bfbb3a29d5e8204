"""Mean ms per window search inside ``MerPCR._dispatch_item``: the plan
items' host preparation and kernel launches (a span the harness wraps
around the method)."""


def read(run):
    if not run.window or "dispatch" not in run.window[0].spans:
        return None
    return sum(s.spans.get("dispatch", 0.0) for s in run.window) / len(run.window)
