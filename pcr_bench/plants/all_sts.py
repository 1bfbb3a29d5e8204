"""``"all_sts": {"mismatch_every": m}``: every STS that no earlier kind took,
once, one in ``m`` (not degenerate) with one mismatch per primer: a marker
panel mapped onto its own genome."""


def add(plan, params) -> None:
    every = int(params.get("mismatch_every", 0))
    rest = [i for i in range(len(plan.inp.sts)) if i not in plan.used]
    for j, i in enumerate(rest):
        plan.used.add(i)
        k = 1 if every and j % every == every - 1 and i not in plan.inp.degenerate else 0
        plan.wanted.append((i, "+-"[j % 2], "all_sts", k, 0))
