"""The ``chr21_sts5k.n0_n1`` cell's files and the two front-end readers.

* A whole CPU run of a chr21-shaped copy of the cell: the real
  configuration and traffic mix with the record cut to 1 Mbp, the panel to
  300 STS and the plants to match, under a small benchmark's root. The
  port's lines equal the plain reference's at -N 0 and at -N 1, the
  searches run the strict0 and strict1 front ends, and the control is not
  correct.
* ``front_end_ms`` and ``front_end_roofline`` on synthetic runs: every
  front end's kernel counted by its name's prefix and no other operation,
  the share computed from ``run.tiles``, None without a trace, without a
  front-end operation or without a tile.
"""

import json
import os

import pytest

from pcr_bench import harness, roofline, run, spec
from pcr_bench import trace as bench_trace
from pcr_bench.tests import small

CELL = "chr21_small.n0_n1"


def _real(kind: str, name: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, kind, f"{name}.json")) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A small benchmark's root with the cell's configuration and traffic
    mix cut to a size the CPU scans in seconds."""
    root = small.make_root(str(tmp_path_factory.mktemp("chr21")))
    cfg = {**_real("configs", "chr21_sts5k"), "name": "chr21_small",
           "records": [["chr21", 1_000_000]], "sts_count": 300}
    traffic = _real("traffic", "n0_n1")
    traffic = {**traffic, "trace_searches": 2,
               "plants": {**traffic["plants"], "exact": 30, "boundary": {"every": 1 << 17},
                          "mismatch": {"1": 5, "2": 5},
                          "off_size": {**traffic["plants"]["off_size"], "per_delta": 1}}}
    small.write(os.path.join(root, "pcr_bench", "configs", "chr21_small.json"), cfg)
    small.write(os.path.join(root, "pcr_bench", "traffic", "n0_n1.json"), traffic)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    bench["configs"].append({"name": "chr21_small", "source": "test", "reduced": [],
                             "file": "pcr_bench/configs/chr21_small.json", "why": "test"})
    bench["workloads"].append({"name": CELL, "config": "chr21_small", "traffic": "n0_n1",
                               "chips": 1, "why": "test"})
    small.write(os.path.join(root, "BENCHMARK.json"), bench)
    return root


@pytest.fixture(autouse=True)
def device_path(monkeypatch):
    # a 1 Mbp record would take the program's host path, not its tile scan
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _result(root, capsys, *extra):
    argv = ["--workload", CELL, "--seed", str(2**31 + 2024), "--seconds", "0.5", *extra]
    assert run.main(argv, device="cpu", root=root) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", ["0", "1"])
def test_cell_runs_strict0_and_strict1_and_is_correct(root, capsys, monkeypatch, trace):
    """Every search's lines equal the reference's at its -N; the searches
    alternate the strict0 and strict1 front ends (read from each search's
    ``last_scans``: the line's ``scan_paths`` holds the last warm-up
    search's, here -N 0's)."""
    paths = []
    real = harness.search

    def search(eng, recs, setting, settings, bases, probe=None):
        s = real(eng, recs, setting, settings, bases, probe)
        paths.append((settings[setting]["mismatches"],
                      [(p.cfg.strict, p.cfg.strict_n) for p in eng.last_scans]))
        return s

    monkeypatch.setattr(harness, "search", search)
    res = _result(root, capsys, "--trace", trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 3
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert res["scan_paths"] == ["strict0"]
    assert {n for n, _p in paths} == {0, 1}
    assert all(p == [(True, n)] for n, p in paths), paths


def test_control_is_not_correct(root, capsys):
    """The -N 1 searches' reference run at -N 0 loses the one-mismatch
    plants."""
    res = _result(root, capsys, "--control", "1")
    assert not res["correct"] and res["checks"]["lines_missing"]["value"] >= 5


def _reader(name: str):
    return spec.load(spec.BENCH_DIR, "metrics", name).read


def _run(ops: dict, searches: int, tiles: list):
    r = harness.Run(cell=None, seconds=1.0)
    r.trace = bench_trace.Trace(device_ops=ops, searches=searches)
    r.tiles = tiles
    return r


OPS = {"front_end_kernel": 0.004, "front_end_loose_kernel<4, false>": 0.002,
       "front_end_raw_kernel": 0.001, "expand_kernel<1>": 0.5, "verify_p1_kernel": 0.25,
       "Memcpy DtoH (Device -> Pinned)": 0.125}


@pytest.mark.parametrize("names", [["front_end_kernel"],
                                   ["front_end_loose_kernel<4, false>"],
                                   ["front_end_raw_kernel"], list(OPS)])
def test_front_end_readers_count_the_front_ends_alone(names):
    ops = {k: OPS[k] for k in names}
    fe = sum(v for k, v in ops.items() if k.startswith("front_end"))
    tiles = [(True, 1 << 23, 700), (True, 5_000_001, 3), (False, 1 << 15, 0)]
    r = _run(ops, 4, tiles)
    assert _reader("front_end_ms")(r) == pytest.approx(fe / 4 * 1e3)
    least = ((1 << 22) + 2_500_001 + (1 << 15)) / roofline.HBM_BYTES_PER_S  # no hit bytes
    assert _reader("front_end_roofline")(r) == pytest.approx(100 * least / fe)


def test_front_end_readers_read_nothing_without_a_trace_or_a_front_end():
    for name in ("front_end_ms", "front_end_roofline"):
        read = _reader(name)
        assert read(harness.Run(cell=None, seconds=1.0)) is None  # no trace: the CPU
        assert read(_run({"expand_kernel<1>": 0.5}, 4, [(True, 100, 0)])) is None
        assert read(_run({}, 0, [])) is None
    assert _reader("front_end_roofline")(_run(OPS, 4, [])) is None
