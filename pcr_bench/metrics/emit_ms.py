"""Mean ms per window search outside the plan, dispatch and collect spans:
sorting each record's rows and printing its lines, and the rest of the
search's own loop."""


def read(run):
    if not run.window or "collect" not in run.window[0].spans:
        return None
    rest = [s.ms - sum(s.spans.get(k, 0.0) for k in ("plan", "dispatch", "collect"))
            for s in run.window]
    return sum(rest) / len(rest)
