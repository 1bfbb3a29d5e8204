"""The generator: the same inputs from the same seed, the same work from
every seed, and every plant where it says."""

import json
import os

import numpy as np
import pytest

from pcr_bench import generate, spec
from pcr_bench.tests import small


def _bench(name: str, kind: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, kind, f"{name}.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cfg,traffic", [(small.CHR, "sparse"), (small.ASM, "msweep"),
                                         (small.CHR, "dense")])
def test_same_seed_same_inputs(cfg, traffic):
    a = generate.make_inputs(cfg, small.TRAFFIC[traffic], 2**31 + 7)
    b = generate.make_inputs(cfg, small.TRAFFIC[traffic], 2**31 + 7)
    c = generate.make_inputs(cfg, small.TRAFFIC[traffic], 2**31 + 8)
    assert np.array_equal(a.genome, b.genome) and a.sts == b.sts and a.plants == b.plants
    assert not np.array_equal(a.genome, c.genome)
    # another seed: the same records, the same plants by kind
    assert a.lengths.tolist() == c.lengths.tolist()
    kinds = lambda inp: sorted((p.kind, p.k, p.delta) for p in inp.plants)  # noqa: E731
    assert kinds(a) == kinds(c)


def test_records_follow_the_configuration():
    assert _bench("chr1_sts50k", "configs")["records"] == [["chr1", 248_956_422]]
    asm = generate.make_inputs(small.ASM, small.TRAFFIC["msweep"], 2)
    assert asm.bases == len(asm.genome) and asm.lengths.tolist() == small.SCAFFOLDS
    assert asm.labels == [label for label, _n in small.ASM["records"]]
    assert asm.starts.tolist() == np.cumsum([0] + small.SCAFFOLDS[:-1]).tolist()


@pytest.mark.parametrize("every", [1 << 16, 1 << 17])
def test_boundary_plants_sit_on_every_edge(every):
    traffic = {**small.TRAFFIC["sparse"], "plants": {"boundary": {"every": every}}}
    inp = generate.make_inputs(small.CHR, traffic, 4)
    n = int(inp.lengths[0])
    edges = list(range(every, n, every))
    spans = sorted((p.pos, p.pos + p.size) for p in inp.plants)
    assert len(spans) == 2 * len(edges)
    for b, (outer, inner) in zip(edges, zip(spans[::2], spans[1::2])):
        assert outer[0] == b - 100 < b < outer[1] and inner[0] == b - 5 < b < inner[1]


@pytest.mark.parametrize("cfg,traffic", [(small.CHR, "sparse"), (small.ASM, "msweep"),
                                         (small.CHR, "dense")])
def test_plants_lie_where_they_say(cfg, traffic):
    inp = generate.make_inputs(cfg, small.TRAFFIC[traffic], 11)
    spans = []
    for p in inp.plants:
        _sid, p1, p2, stated, _alias = inp.sts[p.sts]
        assert p.size == stated + p.delta
        s = int(inp.starts[p.record]) + p.pos
        left = bytes(inp.genome[s : s + 12])
        want = (p1 if p.strand == "+" else p2)[:12]
        if p.sts not in inp.degenerate:  # mismatches lie past the first 12
            assert left == want
        spans.append((p.record, p.pos, p.pos + p.size))
        assert p.pos + p.size <= inp.lengths[p.record]
    spans.sort()
    for (r0, _a0, b0), (r1, a1, _b1) in zip(spans, spans[1:]):
        # only a boundary plant's inner plant lies inside another
        assert r0 != r1 or a1 >= b0 or traffic == "sparse"
    plants = small.TRAFFIC[traffic]["plants"]
    n = len(inp.plants)
    if traffic == "dense":
        assert n == cfg["sts_count"]  # every STS once
    else:
        assert n >= plants["exact"]


def test_expected_lines_follow_the_settings():
    inp = generate.make_inputs(small.CHR, small.TRAFFIC["sparse"], 5)
    n0 = inp.expected(0, 50, 0)
    n1 = inp.expected(1, 50, 0)
    n2 = inp.expected(2, 1000, 0)
    assert set(n0) < set(n1) < set(n2)
    assert len(n1) - len(n0) == 5 and len(n2) == len(inp.plants)
    asm = generate.make_inputs(small.ASM, small.TRAFFIC["msweep"], 5)
    assert len(asm.expected(0, 50, 1)) > len(asm.expected(0, 50, 0))
    assert len(asm.expected(0, 100, 1)) == len(asm.expected(0, 50, 1)) + 6


def test_inputs_written_as_made(tmp_path):
    inp = generate.make_inputs(small.ASM, small.TRAFFIC["msweep"], 3)
    sts, fa = generate.write_inputs(str(tmp_path), inp)
    body = open(fa, "rb").read().split(b">")[1:]
    assert len(body) == len(inp.labels)
    first = body[0].split(b"\n", 1)
    assert first[0].split()[0].decode() == inp.labels[0]
    seq = first[1].replace(b"\n", b"")
    assert seq == inp.genome[: inp.lengths[0]].tobytes()
    rows = [line.split("\t") for line in open(sts).read().splitlines()]
    assert len(rows) == len(inp.sts) and rows[0][4] == inp.sts[0][4]
