"""The plain reference: the original me-PCR's golden line, and on small
corpora the planted lines and only those."""

import os

import pytest
import torch

from pcr_bench import generate
from pcr_bench.reference import mepcr
from pcr_bench.tests import small

DATA = os.path.join(small.REPO, "tests", "data")
GOLDEN = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"
KEEP = set(b"ACGTBDHKMNRSVWXYacgtbdhkmnrsvwxy")


def _search(inp, margin, mismatches, iupac, x=1):
    ent = mepcr.Entries(inp.sts, 11)
    rows = mepcr.search(torch.from_numpy(inp.genome), torch.from_numpy(inp.starts),
                        torch.from_numpy(inp.lengths), ent, margin, mismatches, x, iupac)
    return mepcr.lines(rows, inp.labels, ent, inp.sts)


@pytest.mark.parametrize("margin", [50, 100])
def test_golden_line(margin):
    rows = []
    for line in open(os.path.join(DATA, "test.sts")):
        f = line.rstrip("\n").split("\t")
        rows.append((f[0], f[1], f[2], int(f[3]), f[4]))
    text = open(os.path.join(DATA, "test.fa"), "rb").read().split(b"\n")
    seq = bytes(c for c in b"".join(text[1:]) if c in KEEP)
    ent = mepcr.Entries(rows, 11)
    got = mepcr.search(torch.frombuffer(bytearray(seq), dtype=torch.uint8),
                       torch.tensor([0]), torch.tensor([len(seq)]), ent, margin, 0, 1, False)
    assert mepcr.lines(got, ["L78833"], ent, rows) == [GOLDEN]


@pytest.mark.parametrize("mismatches,margin", [(0, 50), (1, 50), (2, 800)])
def test_planted_lines_and_only_those(mismatches, margin):
    inp = generate.make_inputs(small.CHR, small.TRAFFIC["sparse"], 21)
    got = _search(inp, margin, mismatches, False)
    assert sorted(got) == sorted(inp.expected(mismatches, margin, 0))


@pytest.mark.parametrize("iupac", [0, 1])
def test_degenerate_primers_need_iupac(iupac):
    inp = generate.make_inputs(small.ASM, small.TRAFFIC["msweep"], 22)
    got = set(_search(inp, 100, 0, bool(iupac)))
    want = set(inp.expected(0, 100, iupac))
    assert want <= got
    degenerate = {inp.line(p) for p in inp.plants if p.sts in inp.degenerate}
    assert bool(degenerate & got) == bool(iupac)


def test_three_prime_end_is_protected():
    """A mismatch at the last base of primer 1 hides the amplicon at any -N
    while -X 1 holds, and shows it at -X 0."""
    inp = generate.make_inputs(small.CHR, {"searches": [{}], "plants": {"exact": 1}}, 4)
    p = inp.plants[0]
    left = inp.sts[p.sts][1] if p.strand == "+" else inp.sts[p.sts][2]
    s = int(inp.starts[p.record]) + p.pos + len(left) - 1
    inp.genome[s] = generate.TRANSITION[inp.genome[s]]
    line = inp.line(p)
    assert line not in _search(inp, 50, 3, False)
    assert line in _search(inp, 50, 3, False, x=0)


def test_entries_follow_the_loader_rules():
    rows = [("a", "ACGTACGTACGTACGTAC", "TTTTGGGGCCCCAAAATT", 10, ""),  # size raised
            ("b", "ACGT", "ACGTACGTACGTACGT", 100, ""),  # a primer under W: dropped
            ("c", "NNNNNNNNNNNNNNNNNN", "ACGTACGTACGTACGTAA", 100, "")]  # (+) has no word
    ent = mepcr.Entries(rows, 11)
    assert ent.sts == [0, 0, 2] and ent.strand == ["+", "-", "-"]
    assert ent.size.tolist() == [36, 36, 100]
    assert mepcr.revcomp("ACGRYN") == "NRYCGT"
