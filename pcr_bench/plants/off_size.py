"""``"off_size": {"deltas": [...], "per_delta": count}``: ``count``
amplicons at each real-minus-stated size in ``deltas``, on STS whose stated
size leaves room for a negative one: found at -M >= |delta|."""


def add(plan, params) -> None:
    rows = plan.inp.sts
    for delta in params.get("deltas", []):
        for j in range(int(params.get("per_delta", 0))):
            plan.wanted.append((plan.fresh(lambda i: rows[i][3] >= 250), "+-"[j % 2],
                                "off_size", 0, int(delta)))
