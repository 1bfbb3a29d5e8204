"""Whole runs of the harness on the CPU, at small sizes: the port's plain
PyTorch stages in place of its kernels, the card check skipped. A sound run
is correct; the control and every fault the cells can have are not."""

import json

import pytest

from merpcr_tpu_torch import MerPCR
from merpcr_tpu_torch.ops import scan
from pcr_bench import run
from pcr_bench.tests import small


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small.make_root(str(tmp_path_factory.mktemp("bench")))


@pytest.fixture(autouse=True)
def device_path(monkeypatch):
    # small inputs would take the program's host path, not its tile scan
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def result(root, capsys, cell, *extra, seed=2**31 + 99, rc=0):
    argv = ["--workload", cell, "--seed", str(seed), "--seconds", "0.5", *extra]
    assert run.main(argv, device="cpu", root=root) == rc
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1]) if out else None


@pytest.mark.parametrize("cell", sorted(small.CELLS))
@pytest.mark.parametrize("trace", ["0", "1"])
def test_sound_run_is_correct(root, capsys, cell, trace):
    res = result(root, capsys, cell, "--trace", trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 2
    assert list(res)[-1] == "checks"
    assert all(c["value"] == 0 and c["limit"] == 0 for c in res["checks"].values())
    names = {"0": {"scan_mbp_s", "setup_s"},  # no card: no peak
             "1": {"search_p95_ms", "dispatch_ms", "collect_ms", "emit_ms",
                   "sts_compile_s", "first_search_s"}}[trace]
    assert names <= set(res["metrics"])
    # a device metric is never read from a CPU run
    assert not {"peak_device_mib", "kernel_busy_ms", "device_idle_pct"} & set(res["metrics"])


@pytest.mark.parametrize("cell", sorted(small.CELLS))
def test_control_is_not_correct(root, capsys, cell):
    res = result(root, capsys, cell, "--control", "1")
    assert not res["correct"] and res["checks"]["lines_missing"]["value"] > 0


def _drop_half(monkeypatch):
    real = scan.collect_stream

    def collect(p):
        outs, reruns = real(p)
        halved = []
        for o in outs:
            keep = slice(0, None, 2)  # every other hit of the tile
            rows = [t[keep] for t in o[5:]]
            halved.append(o._replace(hit_total=len(rows[0]), pos1=rows[0], pos2=rows[1],
                                     entry=rows[2], pair_order=rows[3], rank=rows[4],
                                     rec=rows[5]))
        return halved, reruns

    monkeypatch.setattr(scan, "collect_stream", collect)


def _alter_one(monkeypatch):
    real = scan.collect_stream

    def collect(p):
        outs, reruns = real(p)
        for o in outs:
            if o.hit_total:
                o.pos2[0] += 1  # one answer altered where it is made
                break
        return outs, reruns

    monkeypatch.setattr(scan, "collect_stream", collect)


def _search_prints_nothing(monkeypatch):
    monkeypatch.setattr(MerPCR, "search", lambda self, recs, output_file=None: 0)


def _settings_kept(monkeypatch):
    """The engine keeps its first -M: each search returns the state the
    last one left."""
    real = MerPCR._runtime_params
    first = {}

    def kept(self):
        first.setdefault(id(self), real(self))
        return first[id(self)]

    monkeypatch.setattr(MerPCR, "_runtime_params", kept)


FAULTS = {"half_left_out": _drop_half, "answer_altered": _alter_one,
          "nothing_printed": _search_prints_nothing}


@pytest.mark.parametrize("cell", sorted(small.CELLS))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(root, capsys, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    res = result(root, capsys, cell)
    assert not res["correct"] and res["failed"] > 0


def test_kept_settings_are_not_correct(root, capsys, monkeypatch):
    _settings_kept(monkeypatch)
    res = result(root, capsys, "asm_small.msweep")
    assert not res["correct"] and res["checks"]["lines_missing"]["value"] > 0


def test_no_card_no_result(root, capsys):
    """Without ``device`` the run looks for the card, and this machine has
    none: an error, no result line."""
    argv = ["--workload", "chr_small.sparse", "--seed", "1", "--seconds", "1"]
    assert run.main(argv, root=root) == 2
    assert capsys.readouterr().out == ""
