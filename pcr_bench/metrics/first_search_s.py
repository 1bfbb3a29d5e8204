"""Seconds of the fresh engine's first search: packing, dirty rate, table and
plane upload, the kernels' load (and their build, in a checkout's first
run)."""


def read(run):
    return run.setup_spans.get("first_search_s")
