"""``"boundary": {"every": bases}``: two amplicons at every multiple of
``every`` bases of each record, one across it with its primers clear of it,
and inside that one a shorter one whose anchor word straddles it. With
``every`` a power of two, the multiples are the edges of the program's
record tiles for any tile length of ``every`` or more (the run reports the
tile length the program took)."""


def add(plan, params) -> None:
    rows, every = plan.inp.sts, int(params["every"])
    for r, n in enumerate(plan.inp.lengths.tolist()):
        for b in range(every, n, every):
            plan.fixed.append((r, b - 100, plan.fresh(lambda i: rows[i][3] >= 330), "+",
                               "boundary"))
            plan.fixed.append((r, b - 5, plan.fresh(lambda i: rows[i][3] <= 150), "-",
                               "boundary"))
            plan.reserved.append((r, b - 1024, b + 1024))
