"""``"mismatch": {"k": count, ...}``: ``count`` amplicons with k transitions
in each primer, off the hashed word and the -X protected ends: found at
-N >= k."""


def add(plan, params) -> None:
    for k, count in sorted(params.items()):
        for j in range(int(count)):
            plan.wanted.append((plan.fresh(), "+-"[j % 2], "mismatch", int(k), 0))
