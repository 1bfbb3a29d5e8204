"""The port's host fast path (``merpcr_tpu_torch/ops/host_scan.py``), its
``MERPCR_TPU_HOST_MAX`` gate and flood fallback, and the
``MERPCR_TPU_TRACE`` hook, against the JAX package.

* ``host_scan_record`` of the port and of ``merpcr_tpu.ops.host_scan``,
  each over its own package's compiled table, give equal int64 rows
  (tolerance 0), or both None past a cap.
* Whole searches: the port on its default gate (the host path), the port
  at ``MERPCR_TPU_HOST_MAX=0`` (its plain kernel versions) and
  ``merpcr_tpu`` on its default gate (its host path) print the same bytes.
* The gate's edges, the flood fallback to the record path, the trace, and
  a host-path run that builds, uploads and launches nothing.

The JAX side of every non-flood comparison is its NumPy host path, which
compiles nothing; only the two flood searches compile a JAX device program.
"""

from __future__ import annotations

import io
import json
import os
import random
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest

pytest.importorskip("jax")

import merpcr_tpu  # noqa: E402
import merpcr_tpu_torch  # noqa: E402
from merpcr_tpu.io.sts import STSLoader as JaxSTSLoader  # noqa: E402
from merpcr_tpu.models import FASTARecord as JaxRecord  # noqa: E402
from merpcr_tpu.ops import host_scan as jax_host_scan  # noqa: E402
from merpcr_tpu.ops.table import compile_table as jax_compile_table  # noqa: E402
from merpcr_tpu_torch import MerPCR, engine  # noqa: E402
from merpcr_tpu_torch.io.sts import STSLoader  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402
from merpcr_tpu_torch.ops import host_scan  # noqa: E402
from merpcr_tpu_torch.ops.table import compile_table  # noqa: E402
from merpcr_tpu_torch.parallel import make_mesh  # noqa: E402

from chip_smoke import flood_corpus  # noqa: E402
from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMB = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(autouse=True)
def _default_gate(monkeypatch):
    """Every test sets the gate it means; none inherits the suite's 0."""
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX", raising=False)
    monkeypatch.delenv("MERPCR_TPU_TRACE", raising=False)


# ---------------------------------------------------------------- corpora
def _corpus(seed: int, W: int, n_sts: int = 24, lengths=(6_000, 9_000)):
    """(STS text, [(label, record bytes)]) from a numpy seed: random ACGT
    records with a lowercase run and scattered IUPAC letters, a record of W
    and one of W + 1 bases, and an RNA/junk-byte rendering of the first
    record; STS of 18-25-base primers, every fifth with R/Y/N letters and
    every seventh with primers shorter than W (the loader drops those),
    every other one planted in a random orientation, some off their stated
    size and a quarter each with one and two mismatches per primer (any
    base, the protected ends too), and one amplicon whose
    stated size runs past the first record's end (the clamp)."""
    rng = np.random.default_rng(seed)
    recs = [rng.choice(ACGT, size=n) for n in lengths]
    lines = []
    for i in range(n_sts):
        l1, l2 = (int(v) for v in rng.integers(18, 26, size=2))
        if i % 7 == 6:
            l1 = l2 = max(1, W - 2)
        p1 = bytearray(rng.choice(ACGT, size=l1).tobytes())
        p2 = bytearray(rng.choice(ACGT, size=l2).tobytes())
        size = int(rng.integers(100, 400))
        site1, site2 = bytes(p1), bytes(p2)
        if i % 5 == 4:  # IUPAC primer letters; the sites hold A, which only N or R match
            for p in (p1, p2):
                for j in rng.integers(0, len(p) - W, size=2) if len(p) > W else ():
                    p[j] = int(rng.choice(list(b"RYN")))
        lines.append(f"H{i}\t{p1.decode()}\t{p2.decode()}\t{size}\t(alias {i})\n")
        if i % 2 or i % 7 == 6:
            continue
        seq = recs[i % len(recs)]
        real = size + int(rng.integers(-60, 61)) * (i % 3 == 0)
        left, right = (site1, site2) if i % 4 else (site2, site1.translate(COMP)[::-1])
        left, right = bytearray(left), bytearray(right)
        for s in (left, right):  # half the plants exact, the rest 1 or 2 off
            for j in rng.integers(0, len(s), size=(0, 0, 1, 2)[(i // 2) % 4]):
                s[j] = int(rng.choice(ACGT))
        pos = int(rng.integers(0, len(seq) - real))
        seq[pos : pos + len(left)] = np.frombuffer(bytes(left), dtype=np.uint8)
        seq[pos + real - len(right) : pos + real] = np.frombuffer(bytes(right), dtype=np.uint8)
    # the clamp: primer 1 150 bases before the end, primer 2 at the very end
    p1 = rng.choice(ACGT, size=20).tobytes()
    p2 = rng.choice(ACGT, size=20).tobytes()
    lines.append(f"CLAMP\t{p1.decode()}\t{p2.decode()}\t300\n")
    seq = recs[0]
    n = len(seq)
    seq[n - 150 : n - 130] = np.frombuffer(p1, dtype=np.uint8)
    seq[n - 20 :] = np.frombuffer(p2, dtype=np.uint8)
    for seq in recs:
        a = int(rng.integers(0, len(seq) - 400))
        seq[a : a + 300] = np.frombuffer(seq[a : a + 300].tobytes().lower(), dtype=np.uint8)
        seq[rng.integers(0, len(seq), size=len(seq) // 500)] = rng.choice(AMB, size=len(seq) // 500)
    out = [(f"rec{r}", seq.tobytes()) for r, seq in enumerate(recs)]
    out += [("shortW", rng.choice(ACGT, size=W).tobytes()),
            ("shortW1", rng.choice(ACGT, size=W + 1).tobytes())]
    rna = out[0][1].replace(b"T", b"U").replace(b"t", b"u")
    out.append(("rna", rna[:500] + b"-\xe9" + rna[502:]))
    return "".join(lines), out


def _write(tmp_path, name: str, sts_text: str, records):
    sts = tmp_path / f"{name}.sts"
    sts.write_text(sts_text)
    fa = tmp_path / f"{name}.fa"
    with open(fa, "wb") as fh:
        for label, seq in records:
            fh.write(f">{label} synthetic\n".encode())
            fh.write(b"".join(seq[i : i + 60] + b"\n" for i in range(0, len(seq), 60)))
    return str(sts), str(fa)


# ------------------------------------------------------------ unit: rows
def _rows_both(sts: str, records, W: int, M: int, N: int, X: int, I: int):
    """[(port rows, JAX rows)] per record, each package over its own table."""
    res = STSLoader.load_file(sts, W, 240)
    table, meta = compile_table(res, W, bool(I))
    jres = JaxSTSLoader.load_file(sts, W, 240)
    jtable, jmeta = jax_compile_table(jres, W, bool(I), device=False)
    assert meta.n_entries == jmeta.n_entries
    out = []
    for _label, seq in records:
        b = np.frombuffer(seq, dtype=np.uint8)
        out.append((host_scan.host_scan_record(table, meta, b, M, N, X),
                    jax_host_scan.host_scan_record(jtable, jmeta, b, M, N, X)))
    return out


UNIT_CASES = [  # (seed, W, -M, -N, -X, -I)
    (0, 11, 50, 0, 1, 0),
    (1, 11, 50, 1, 1, 1),
    (2, 11, 300, 2, 3, 0),
    (3, 3, 0, 0, 0, 0),
    (4, 3, 50, 1, 1, 1),
    (5, 8, 50, 1, 1, 1),
    (6, 8, 300, 2, 0, 0),
    (7, 12, 50, 0, 1, 1),
    (8, 12, 0, 2, 3, 0),
    (9, 13, 50, 1, 1, 0),
    (10, 14, 300, 1, 0, 0),
    (11, 14, 50, 0, 1, 1),
    (12, 16, 50, 2, 1, 1),
    (13, 16, 300, 0, 3, 0),
]


@pytest.mark.parametrize("seed,W,M,N,X,I", UNIT_CASES)
def test_host_rows_equal_jax(tmp_path, seed, W, M, N, X, I):
    sts_text, records = _corpus(seed, W)
    sts, _ = _write(tmp_path, "u", sts_text, [])
    pairs = _rows_both(sts, records, W, M, N, X, I)
    for (label, _), (got, want) in zip(records, pairs):
        assert got is not None and want is not None, label
        assert got.dtype == np.int64 and got.shape[1:] == (6,)
        np.testing.assert_array_equal(got, want, err_msg=label)
    assert sum(len(got) for got, _ in pairs) > 0  # the plants were found
    assert all(len(got) == 0 for (label, _), (got, _w) in zip(records, pairs)
               if label.startswith("shortW"))


@pytest.mark.parametrize("over", [False, True])
def test_window_cap_edge(monkeypatch, tmp_path, over):
    """Ten exact amplicons at -M 50: each anchors the STS's forward entry
    at primer 1 and its reverse entry at primer 2, so 20 x 101 ranks of
    window work. At a cap of exactly that both packages give the same ten
    rows, one below it both give None."""
    rng = np.random.default_rng(40)
    p1, p2 = (rng.choice(ACGT, size=20).tobytes() for _ in range(2))
    seq = rng.choice(ACGT, size=12_000)
    for i in range(10):
        a = 500 + 1_100 * i
        seq[a : a + 20] = np.frombuffer(p1, dtype=np.uint8)
        seq[a + 180 : a + 200] = np.frombuffer(p2, dtype=np.uint8)
    sts, _ = _write(tmp_path, "w", f"W1\t{p1.decode()}\t{p2.decode()}\t200\n", [])
    cap = 20 * 101 - over
    for mod in (host_scan, jax_host_scan):
        monkeypatch.setattr(mod, "MAX_WINDOW_WORK", cap)
    ((got, want),) = _rows_both(sts, [("w", seq.tobytes())], 11, 50, 0, 1, 0)
    if over:
        assert got is None and want is None
    else:
        assert len(got) == 10
        np.testing.assert_array_equal(got, want)


# --------------------------------------------------------- whole searches
def _out(eng, recs) -> str:
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs)
    return buf.getvalue()


def _gate(monkeypatch, value) -> None:
    """MERPCR_TPU_HOST_MAX, or unset (the default gate) for None."""
    if value is None:
        monkeypatch.delenv("MERPCR_TPU_HOST_MAX", raising=False)
    else:
        monkeypatch.setenv("MERPCR_TPU_HOST_MAX", value)


def _three(monkeypatch, sts: str, fa: str = None, records=None, **params):
    """(port default gate, port at MERPCR_TPU_HOST_MAX=0, JAX default gate)
    outputs and the two port engines; ``records``: (label, bytes) passed
    through the API instead of ``fa``."""
    outs, engines = [], []
    for pkg, gate in ((merpcr_tpu_torch, None), (merpcr_tpu_torch, "0"), (merpcr_tpu, None)):
        _gate(monkeypatch, gate)
        eng = (pkg.MerPCR(device="cpu", **params) if pkg is merpcr_tpu_torch
               else pkg.MerPCR(**params))
        assert eng.load_sts_file(sts)
        if records is None:
            recs = eng.load_fasta_file(fa)
        else:
            rec_type = FASTARecord if pkg is merpcr_tpu_torch else JaxRecord
            recs = [rec_type(defline=f">{lb}", sequence=s.decode("latin-1")) for lb, s in records]
        outs.append(_out(eng, recs))
        engines.append(eng)
    return outs, engines[:2]


def test_golden_api(monkeypatch):
    (host, dev, ref), (e_host, e_dev) = _three(monkeypatch, GOLDEN_STS, GOLDEN_FA)
    assert host == dev == ref == GOLDEN_LINE + "\n"
    assert e_host.last_scans == [] and e_host._tables == {}
    assert len(e_dev.last_scans) == 1


def test_golden_cli(monkeypatch, tmp_path):
    from merpcr_tpu import cli as jax_cli
    from merpcr_tpu_torch import cli

    outs = []
    for main, gate, kw in ((cli.main, None, {"device": "cpu"}), (cli.main, "0", {"device": "cpu"}),
                           (jax_cli.main, None, {})):
        _gate(monkeypatch, gate)
        out = tmp_path / f"o{len(outs)}.txt"
        assert main([GOLDEN_STS, GOLDEN_FA, "-O", str(out)], **kw) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] == outs[2] == GOLDEN_LINE + "\n"


@pytest.mark.parametrize("seed,W,M,N,I", [(20, 11, 50, 0, 0), (21, 11, 300, 1, 1), (22, 13, 50, 2, 0)])
def test_multi_record_corpus(monkeypatch, tmp_path, seed, W, M, N, I):
    """Every record a host item of its own: no stream run, no plane."""
    sts_text, records = _corpus(seed, W)
    sts, fa = _write(tmp_path, "m", sts_text, records[:-1])  # FASTA holds no RNA record
    (host, dev, ref), (e_host, e_dev) = _three(monkeypatch, sts, fa, wordsize=W, margin=M,
                                               mismatches=N, iupac_mode=I)
    assert host == dev == ref and host.count("\n") > 2
    assert e_host.last_scans == [] and e_host._tables == {}
    assert any(scan.cfg.stream for scan in e_dev.last_scans)


@pytest.mark.parametrize("render,I", [("rna", 1), ("junk", 0)])
def test_record_outside_the_alphabet(monkeypatch, tmp_path, render, I):
    """A record only the API can pass: the first record as RNA (T -> U,
    which -I 1 matches to T) or as DNA with bytes outside the 16 letters."""
    sts_text, records = _corpus(30, 11)
    sts, _ = _write(tmp_path, "r", sts_text, [])
    seq = records[0][1]
    if render == "rna":
        seq = seq.replace(b"T", b"U").replace(b"t", b"u")
    seq = seq[:500] + b"-\xe9" + seq[502:4000] + b".0\xff" + seq[4003:]
    (host, dev, ref), (e_host, e_dev) = _three(monkeypatch, sts, records=[("x", seq)],
                                               iupac_mode=I)
    assert host == dev == ref and host.count("\n") > 0
    assert e_host.last_scans == [] and not e_dev.last_scans[0].cfg.packed


def test_sts_set_with_no_entries(monkeypatch, tmp_path):
    """Every primer shorter than W: no entry, so no host path and no scan."""
    sts, fa = _write(tmp_path, "e", "S1\tACGTACG\tTTGCAAC\t120\n",
                     [("e", b"ACGTACGTTGCAAC" * 100)])
    (host, dev, ref), (e_host, e_dev) = _three(monkeypatch, sts, fa)
    assert host == dev == ref == ""
    assert e_host._meta.n_entries == 0
    assert e_host.last_scans == e_dev.last_scans == []


# ----------------------------------------------------------------- gate
@pytest.mark.parametrize("delta,host", [(0, True), (-1, False)])
def test_gate_cutoff(monkeypatch, delta, host):
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    recs = eng.load_fasta_file(GOLDEN_FA)
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", str(sum(len(r.sequence) for r in recs) + delta))
    assert _out(eng, recs) == GOLDEN_LINE + "\n"
    assert (eng.last_scans == []) == host
    assert (eng._tables == {}) == host


def test_gate_off_under_a_mesh():
    eng = MerPCR(device="cpu").use_mesh(make_mesh(("cpu", "cpu")))
    assert eng.load_sts_file(GOLDEN_STS)
    assert _out(eng, eng.load_fasta_file(GOLDEN_FA)) == GOLDEN_LINE + "\n"
    (scan,) = eng.last_scans
    assert scan.shards == 2


def test_strict1_built_by_the_first_device_search(monkeypatch):
    """A -N 1 host search builds no strict1 table and uploads nothing; a
    later device search on the same engine builds it once."""
    built = []
    real = engine.build_strict1

    def counting(*args):
        built.append(1)
        return real(*args)

    monkeypatch.setattr(engine, "build_strict1", counting)
    eng = MerPCR(device="cpu", mismatches=1)
    assert eng.load_sts_file(GOLDEN_STS)
    recs = eng.load_fasta_file(GOLDEN_FA)
    host = _out(eng, recs)
    assert built == [] and not eng._strict1_tried and eng._tables == {}
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    assert _out(eng, recs) == host and GOLDEN_LINE in host
    assert built == [1] and eng._strict1_tried
    assert _out(eng, recs) == host and built == [1]


def test_warm_engine_keeps_small_searches_on_the_device_path(monkeypatch):
    """Once a search has put the table on the engine's device, a small
    search on the default gate runs the kernels there; a new STS set drops
    the table, and the host path returns."""
    calls = []
    real = engine.host_scan_record
    monkeypatch.setattr(engine, "host_scan_record",
                        lambda *a: calls.append(1) or real(*a))
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    recs = eng.load_fasta_file(GOLDEN_FA)
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    assert _out(eng, recs) == GOLDEN_LINE + "\n" and len(eng._tables) == 1
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    assert _out(eng, recs) == GOLDEN_LINE + "\n"
    assert calls == [] and len(eng.last_scans) == 1
    assert eng.load_sts_file(GOLDEN_STS)
    assert _out(eng, recs) == GOLDEN_LINE + "\n"
    assert calls == [1] and eng.last_scans == [] and eng._tables == {}


# ---------------------------------------------------------------- floods
@pytest.mark.parametrize("flood", ["candidates", "window"])
def test_flood_falls_back_to_the_record_path(monkeypatch, tmp_path, flood):
    """A corpus past each cap: ``host_scan_record`` returns None in both
    packages, and the record runs on the record path, with the bytes of
    the port's device path and of JAX's default gate."""
    sts, fa, params = flood_corpus(tmp_path, flood)
    returned = []
    for mod in (engine, jax_host_scan):  # the names each engine calls
        real = mod.host_scan_record

        def spy(*args, _real=real):
            returned.append(_real(*args))
            return returned[-1]

        monkeypatch.setattr(mod, "host_scan_record", spy)
    (host, dev, ref), (e_host, _) = _three(monkeypatch, sts, fa, **params)
    assert returned == [None, None]  # the port's default gate, then JAX's
    assert host == dev == ref
    (scan,) = e_host.last_scans  # the record path ran for the one record
    assert scan.records == 1 and not scan.cfg.stream
    if flood == "window":
        assert host.count("\n") > 8192  # past margin_p2's row buffer on the card


# ---------------------------------------------------------------- trace
@pytest.mark.parametrize("gate", [None, "0"])
def test_trace_written(monkeypatch, tmp_path, gate):
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    recs = eng.load_fasta_file(GOLDEN_FA)
    _gate(monkeypatch, gate)
    plain = _out(eng, recs)
    trace_dir = tmp_path / "trace" / "new"  # made by the search
    monkeypatch.setenv("MERPCR_TPU_TRACE", str(trace_dir))
    assert _out(eng, recs) == plain == GOLDEN_LINE + "\n"
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as fh:
        assert "traceEvents" in json.load(fh)
    assert _out(eng, recs) == plain
    assert len(os.listdir(trace_dir)) == 2  # a file of its own per search
    assert (eng.last_scans == []) == (gate is None)


@pytest.mark.parametrize("value", [None, ""])
def test_no_trace_no_profiler(monkeypatch, tmp_path, value):
    import torch.profiler

    def refuse(*_a, **_k):
        raise AssertionError("a profiler was made")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.chdir(tmp_path)
    if value is not None:
        monkeypatch.setenv("MERPCR_TPU_TRACE", value)
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    assert _out(eng, eng.load_fasta_file(GOLDEN_FA)) == GOLDEN_LINE + "\n"
    assert os.listdir(tmp_path) == []


# ------------------------------------------------- no kernel on the path
def test_host_path_builds_uploads_and_launches_nothing(tmp_path):
    """A default-gate golden run through the API and the CLI, in a fresh
    process: no wrapper launches, no kernel build, no table upload, no
    tile scan."""
    code = f"""
from merpcr_tpu_torch import MerPCR, cli
from merpcr_tpu_torch.ops import kernels, scan, table
from merpcr_tpu_torch.ops.expand import expand, expand_loose, expand_raw
from merpcr_tpu_torch.ops.front_end import front_end, front_end_loose, front_end_raw
from merpcr_tpu_torch.ops.margin_p2 import margin_p2, margin_p2_raw
from merpcr_tpu_torch.ops.verify_p1 import verify_p1, verify_p1_raw

def refuse(*a, **k):
    raise AssertionError("device-path work on the host path")

# the engine imports table_from_numpy from ops.table when it uploads
kernels.build = scan.scan_tile = table.table_from_numpy = refuse
eng = MerPCR(device="cpu")
assert eng.load_sts_file({GOLDEN_STS!r})
assert eng.search(eng.load_fasta_file({GOLDEN_FA!r}), {str(tmp_path / "api.txt")!r}) == 1
assert cli.main([{GOLDEN_STS!r}, {GOLDEN_FA!r}, "-O", {str(tmp_path / "cli.txt")!r}],
                device="cpu") == 0
wrappers = (expand, expand_loose, expand_raw, front_end, front_end_loose, front_end_raw,
            margin_p2, margin_p2_raw, verify_p1, verify_p1_raw)
assert [w.launches for w in wrappers] == [0] * 10
assert eng._tables == {{}} and eng.last_scans == []
"""
    env = {k: v for k, v in os.environ.items() if k != "MERPCR_TPU_HOST_MAX"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    for name in ("api.txt", "cli.txt"):
        assert (tmp_path / name).read_text() == GOLDEN_LINE + "\n"


@pytest.mark.parametrize("seed", [7, 99])
def test_chip_smoke_flood_generators_are_workloads(seed):
    """``chip_smoke.py`` keeps its own copies of ``tools/workloads.py``'s
    flood generators (the tests use its floods): the same draws give the
    same STS text and the same genome."""
    import chip_smoke

    sys.path.insert(0, os.path.join(REPO, "tools"))
    import workloads  # imports neither jax nor merpcr_tpu

    for n_buckets in (1, 3):
        a, b = random.Random(seed), random.Random(seed)
        assert (chip_smoke.gen_shared_wmer_sts(a, 200, n_buckets=n_buckets)
                == workloads.gen_shared_wmer_sts(b, 200, n_buckets=n_buckets))
        unit = "".join(a.choices("ACGT", k=20))
        assert unit == "".join(b.choices("ACGT", k=20))
        assert (chip_smoke.gen_tandem_tract(a, 5_000, unit, tract_frac=0.8)
                == workloads.gen_tandem_tract(b, 5_000, unit, tract_frac=0.8))
