"""``"exact": count``: STS 0 .. count-1 planted as they are, in free slots,
strands in turn: found at every -N and -M (a degenerate one at -I 1)."""


def add(plan, count) -> None:
    for i in range(int(count)):
        plan.used.add(i)
        plan.wanted.append((i, "+-"[i % 2], "exact", 0, 0))
