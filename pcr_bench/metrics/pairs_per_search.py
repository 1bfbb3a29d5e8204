"""Mean (position, entry) pairs per window search: the sum of the tiles'
``pair_total``, the work that the verify and margin kernels get."""


def read(run):
    if not run.window or "collect" not in run.window[0].spans:
        return None
    return sum(s.pairs for s in run.window) / len(run.window)
