"""The comparison that decides ``correct``: every search's printed lines
against the plain reference's lines for the same records and settings.

Per search it counts lines the reference has and the search lacks
(``lines_missing``), lines the search printed and the reference has not
(``lines_extra``, duplicates counted), places where the search's lines go
back in record or pos1 order (``order_breaks``: the output is the records in
FASTA order, each sorted by pos1), and planted amplicons the search lacks
(``planted_missing``, a check of the reference as much as of the search).
Lines of one pos1 are compared as a set: their order follows the program's
table layout, which the reference does not model. Every limit is 0.
"""

from __future__ import annotations

from collections import Counter

LIMITS = {"lines_missing": 0, "lines_extra": 0, "order_breaks": 0, "planted_missing": 0}


def order_breaks(lines: list, rank: dict) -> int:
    """How often (record, pos1) goes down from one line to the next."""
    breaks, last = 0, (-1, -1)
    for line in lines:
        label, span = line.split("\t", 2)[:2]
        key = (rank.get(label, -1), int(span.split("..", 1)[0]))
        breaks += key < last
        last = key
    return breaks


def judge(text: str, ref: list, planted: list, rank: dict) -> dict:
    """The numbers of one search's output ``text`` against the reference's
    lines ``ref`` and the lines of the plants it must hold."""
    got = text.splitlines()
    have, want = Counter(got), Counter(ref)
    return {
        "lines_missing": sum((want - have).values()),
        "lines_extra": sum((have - want).values()),
        "order_breaks": order_breaks(got, rank),
        "planted_missing": len(set(planted) - set(got)),
    }


def judge_all(outputs: list, refs: dict, planted: dict, labels: list) -> tuple:
    """(totals over every search, searches that failed): ``outputs`` is
    (setting index, text) per search; ``refs`` and ``planted`` the lines per
    setting index. Equal texts are judged once."""
    rank = {label: i for i, label in enumerate(labels)}
    seen, totals, failed = {}, dict.fromkeys(LIMITS, 0), 0
    for idx, text in outputs:
        key = (idx, text)
        if key not in seen:
            seen[key] = judge(text, refs[idx], planted[idx], rank)
        nums = seen[key]
        for k, v in nums.items():
            totals[k] += v
        failed += any(nums[k] > LIMITS[k] for k in LIMITS)
    return totals, failed
