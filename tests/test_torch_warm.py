"""The port's warm-search path against the JAX package: one engine, many
searches.

* one warm port engine through -N 0, 1, 2, 0, then -M 50, 300, 50, then
  -I 0, 1, then a reload of the STS file: every search's bytes equal a
  fresh ``merpcr_tpu`` engine's at ``MERPCR_TPU_HOST_MAX=0`` (the JAX
  package's caches are keyed by ``id()``, so each corpus gets its own); a
  new -N, -X or -I uploads no plane, a new -M does;
* a new record of the same length and other bases, or the same record
  given such bases, is never served from the cache;
* plans that mix a lone record, a stream run, a raw (RNA) record, an
  empty record and a host-path record keep FASTA order under the depth-1
  prefetch;
* with the deferred scan's buffers shrunk, the tiles past them take the
  count-first rerun, exactly those tiles, and the bytes stay JAX's;
* the deferred scan equals the count-first one tile by tile;
* a three-shard CPU mesh gives the single-device bytes, warm too.

Everything is made from seeds with numpy; tolerance 0.
"""

from __future__ import annotations

import os
import re

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR, engine as engine_mod  # noqa: E402
from merpcr_tpu_torch.io.fasta import record_packed  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402
from merpcr_tpu_torch.ops import expand as expand_mod  # noqa: E402
from merpcr_tpu_torch.ops import margin_p2 as margin_mod  # noqa: E402
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.parallel import make_mesh  # noqa: E402
from merpcr_tpu_torch.parallel import sharded  # noqa: E402

from .conftest import run_search  # noqa: E402
from .test_torch_stream import write_corpus  # noqa: E402

PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "merpcr_tpu_torch")


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _jax(sts, recs, **params) -> str:
    """A fresh JAX engine's bytes (its caches are keyed by ``id()``)."""
    jeng = JaxMerPCR(**params)
    assert jeng.load_sts_file(sts)
    return run_search(jeng, [FASTARecord(defline=r.defline, sequence=r.sequence)
                             for r in recs])


def _corpus(tmp_path, seed: int = 41):
    """A 60 kb dirty lone record, an empty record, then a run of three
    scaffolds: the record path and the stream path in one plan."""
    return write_corpus(tmp_path, seed, [60_000, 0, 3_000, 4_500, 2_200], n_sts=30,
                        dirty=0.01, ambiguous_sts=True)


def _count_uploads(monkeypatch) -> list:
    calls = []
    real = engine_mod.upload

    def counted(arr, dev):
        calls.append(arr.nbytes)
        return real(arr, dev)

    monkeypatch.setattr(engine_mod, "upload", counted)
    return calls


def test_warm_engine_sweeps_equal_jax(tmp_path, monkeypatch):
    """-N 0, 1, 2, 0; -M 50, 300, 50; -I 0, 1; an STS reload: one port
    engine, each search equal to a fresh JAX engine's. The planes are
    uploaded on the first search and again only when -M changes the
    halos."""
    sts, fa = _corpus(tmp_path)
    eng = MerPCR(device="cpu")
    eng._tile_len_override = 1 << 14
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    uploads = _count_uploads(monkeypatch)
    steps = [("mismatches", 0), ("mismatches", 1), ("mismatches", 2), ("mismatches", 0),
             ("margin", 50), ("margin", 300), ("margin", 50), ("iupac_mode", 0),
             ("iupac_mode", 1), ("reload", None), ("three_prime_match", 3)]
    params = {"mismatches": 0, "margin": 50, "iupac_mode": 0, "three_prime_match": 1}
    seen = []
    for name, value in steps:
        before = len(uploads)
        if name == "reload":
            assert eng.load_sts_file(sts)
        else:
            setattr(eng, name, value)
            params[name] = value
            if name == "iupac_mode":  # the table's -I is compiled in
                assert eng.load_sts_file(sts)
        got = run_search(eng, recs)
        want = _jax(sts, recs, **params)
        assert got == want, (name, value)
        assert got.count("\n") >= 4
        new = len(uploads) - before
        key = (params["margin"] > 64,)
        # two planes (the lone record and the run), 2 + 3 arrays each time
        assert new == (0 if key in seen else 5), (name, value, new)
        seen.append(key)
    assert len(eng._owners) == 2


def test_same_length_new_record_is_not_served_from_cache(tmp_path):
    """A new FASTARecord of the same length with other bases (the old one
    dropped first, so that its id() may be reused) scans its own bytes."""
    sts, fa = write_corpus(tmp_path, 43, [30_000], n_sts=20)
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    first = run_search(eng, recs)
    assert first == _jax(sts, recs)
    seq = recs[0].sequence
    del recs
    rng = np.random.default_rng(44)
    other = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=len(seq))
    half = len(seq) // 2  # the first half's plants stay, the rest changes
    other[:half] = np.frombuffer(seq[:half].encode(), dtype=np.uint8)
    new = [FASTARecord(defline=">scaf0 scaffold 0", sequence=other.tobytes().decode())]
    got = run_search(eng, new)
    assert got == _jax(sts, new) and got != first
    assert len(eng._owners) == 2


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("gate", ["default", "0"])
def test_reassigned_sequence_is_not_served_from_cache(tmp_path, monkeypatch, gate, raw):
    """The same record object given other bases of the same length
    (``rec.sequence = ...``) scans its new bases: its byte and packed caches
    hold the string they were made from. On the default gate (the host
    path) and at ``MERPCR_TPU_HOST_MAX=0`` (the kernels, whose plane and
    dirty-rate caches are found through those arrays), for a packable and a
    raw (RNA) record; each search equals a fresh JAX engine's device path."""
    sts, fa = write_corpus(tmp_path, 43, [30_000], n_sts=20)
    params = {"iupac_mode": 1} if raw else {}
    eng = MerPCR(device="cpu", **params)
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    if raw:
        recs[0].sequence = recs[0].sequence.replace("T", "U")

    def search() -> str:
        if gate == "default":
            monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
        got = run_search(eng, recs)
        monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
        assert got == _jax(sts, recs, **params)
        return got

    first = search()
    assert search() == first  # warm: served from the caches
    seq = recs[0].sequence
    rng = np.random.default_rng(44)
    other = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=len(seq))
    half = len(seq) // 2  # the first half's plants stay, the rest changes
    other[:half] = np.frombuffer(seq[:half].encode("latin-1"), dtype=np.uint8)
    new = other.tobytes().decode("latin-1")
    recs[0].sequence = new.replace("T", "U") if raw else new
    got = search()
    assert got != first and got.count("\n") >= 1
    assert bool(eng.last_scans) == (gate == "0")


def _rna(rec: FASTARecord) -> FASTARecord:
    return FASTARecord(defline=rec.defline, sequence=rec.sequence.replace("T", "U"))


def test_mixed_plan_keeps_fasta_order(tmp_path):
    """A lone record, a stream run, an RNA record (raw bytes), an empty
    record and a lone record again, in one plan under the prefetch: the
    port's lines are JAX's, in FASTA order, on a cold and a warm search."""
    sts, fa = write_corpus(tmp_path, 47, [20_000, 0, 3_000, 4_000, 2_500, 9_000, 0,
                                          15_000], n_sts=30)
    eng = MerPCR(device="cpu", iupac_mode=1)
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    recs[5] = _rna(recs[5])  # a raw record: it ends the run and scans alone
    kinds = [k for k, *_ in eng._plan(recs)]
    assert kinds == ["single", "single", "stream", "single", "single", "single"]
    want = _jax(sts, recs, iupac_mode=1)
    labels = [ln.split("\t")[0] for ln in want.splitlines()]
    assert labels == sorted(labels, key=lambda s: int(s[4:])) and len(set(labels)) >= 3
    assert run_search(eng, recs) == want
    assert run_search(eng, recs) == want
    assert [s.records for s in eng.last_scans] == [1, 3, 1, 1]
    assert [s.cfg.packed for s in eng.last_scans] == [True, True, False, True]


def test_mixed_host_plan_keeps_fasta_order(tmp_path, monkeypatch):
    """On the default gate a fresh engine scans on the host, item by item;
    a record past the host path's caps (a tandem-primer tract) is
    dispatched to the kernels between host items. Bytes equal JAX's
    device path."""
    sts, fa = write_corpus(tmp_path, 53, [5_000, 3_000, 0, 4_000], n_sts=20)
    rng = np.random.default_rng(53)
    unit = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=20).tobytes().decode()
    tract = "".join(rng.choice(list("ACGT"), size=2_000)) + unit * 800
    with open(sts, "a") as fh:
        fh.write(f"TAND\t{unit}\t{unit}\t200\n")
    eng = MerPCR(device="cpu", margin=300)
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    recs.insert(2, FASTARecord(defline=">tract repeat", sequence=tract))
    want = _jax(sts, recs, margin=300)
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    got = run_search(eng, recs)
    assert got == want and "tract\t" in got
    assert len(eng.last_scans) == 1 and eng.last_scans[0].records == 1


@pytest.mark.parametrize("stream", [False, True])
def test_shrunk_buffers_take_the_rerun(tmp_path, monkeypatch, stream):
    """Pair buffers of 3 and row buffers of 1: the tiles whose count-first
    pair_total or hit_total passes them, and only those, are rerun; the
    bytes equal JAX's."""
    lengths = [2_000, 3_000, 2_500, 4_000] if stream else [40_000]
    sts, fa = write_corpus(tmp_path, 59, lengths, n_sts=40)
    eng = MerPCR(device="cpu", margin=120)
    eng._tile_len_override = 1 << 12
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    monkeypatch.setattr(expand_mod, "_pair_cap_override", 3)
    monkeypatch.setattr(margin_mod, "ROW_CAP", 1)
    got = run_search(eng, recs)
    assert got == _jax(sts, recs, margin=120)
    (scan,) = eng.last_scans
    cfg = scan.cfg
    assert cfg.stream == stream
    if stream:
        (_, _, items), = eng._plan(recs)
        _, plane, total, slen, rmeta, recmap = eng._stream_plane(items)
        recmap = torch.from_numpy(recmap)
    else:
        packed = record_packed(recs[0])
        slen = len(recs[0].sequence)
        total = slen - eng.wordsize + 1
        plane = eng._plane(packed, cfg.lead + scan.tiles * cfg.tile_len + cfg.tail,
                           cfg.lead, packed=True)
        rmeta, recmap = np.asarray([[0, slen]], np.int32), None
    outs = tscan.scan_stream(cfg, eng._table, torch.from_numpy(plane), total, slen,
                             torch.from_numpy(rmeta), recmap, eng._runtime_params(),
                             scan.tiles)
    past = tuple(t for t, o in enumerate(outs) if o.pair_total > 3 or o.hit_total > 1)
    assert scan.reruns == past
    assert any(o.pair_total > 3 for o in outs) and any(o.hit_total > 1 for o in outs)
    if not stream:  # tiles on both sides of the buffers
        assert len(past) < scan.tiles


@pytest.mark.parametrize("caps", [None, (6, 2)])
@pytest.mark.parametrize("mismatches,iupac", [(0, 0), (2, 1)])
def test_deferred_scan_equals_count_first(tmp_path, monkeypatch, caps, mismatches,
                                            iupac):
    """``dispatch_stream``/``collect_stream`` against ``scan_stream`` tile by
    tile on a dirty stream plane: equal totals and rows, with the default
    buffers and with buffers shrunk so that some tiles rerun."""
    sts, fa = write_corpus(tmp_path, 61, [900, 2_000, 3_300, 1_700, 2_600], n_sts=30,
                           dirty=0.01, ambiguous_sts=True)
    eng = MerPCR(device="cpu", mismatches=mismatches, iupac_mode=iupac)
    eng._tile_len_override = 1 << 11
    assert eng.load_sts_file(sts)
    (_, _, items), = eng._plan(eng.load_fasta_file(fa))
    cfg, plane, total, slen, rmeta, recmap = eng._stream_plane(items)
    args = (cfg, eng._table, torch.from_numpy(plane), total, slen, torch.from_numpy(rmeta),
            torch.from_numpy(recmap), eng._runtime_params(), -(-total // cfg.tile_len))
    if caps:
        monkeypatch.setattr(expand_mod, "_pair_cap_override", caps[0])
        monkeypatch.setattr(margin_mod, "ROW_CAP", caps[1])
    want = tscan.scan_stream(*args)
    got, reruns = tscan.collect_stream(tscan.dispatch_stream(*args))
    assert len(got) == len(want) and sum(o.hit_total for o in want) > 0
    for g, w in zip(got, want):
        assert list(g[:5]) == list(w[:5])
        assert all(torch.equal(a, b) for a, b in zip(g[5:], w[5:]))
    assert bool(reruns) == bool(caps)


@pytest.mark.parametrize("caps", [None, (3, 1)])
def test_three_shard_mesh_equals_one_device(tmp_path, monkeypatch, caps):
    """A mesh of three CPU shards: the single-device bytes, which are JAX's,
    on a cold and a warm search, with the default buffers and with shrunk
    ones (reruns under the mesh, at global tile indices)."""
    sts, fa = _corpus(tmp_path, 67)
    if caps:
        monkeypatch.setattr(expand_mod, "_pair_cap_override", caps[0])
        monkeypatch.setattr(margin_mod, "ROW_CAP", caps[1])
    one = MerPCR(device="cpu")
    one._tile_len_override = 1 << 13
    assert one.load_sts_file(sts)
    recs = one.load_fasta_file(fa)
    want = run_search(one, recs)
    assert want == _jax(sts, recs)
    mesh = MerPCR(device="cpu").use_mesh(make_mesh(("cpu",) * 3))
    mesh._tile_len_override = 1 << 13
    assert mesh.load_sts_file(sts)
    assert run_search(mesh, recs) == want
    calls = []
    real = sharded.upload
    monkeypatch.setattr(sharded, "upload", lambda a, d: calls.append(d) or real(a, d))
    assert run_search(mesh, recs) == want
    assert calls == []  # the warm search uploads no shard
    assert [s.shards for s in mesh.last_scans] == [3, 3]
    assert any(s.reruns for s in mesh.last_scans) == bool(caps)


def test_no_cache_is_keyed_by_id():
    """No source of the port calls ``id()``: its caches hold the arrays
    they were made from (the JAX package's ``id()`` keys are its C2/C3
    faults)."""
    found = []
    for root, _dirs, files in os.walk(PKG):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn)) as fh:
                    found += [f"{fn}:{i}" for i, line in enumerate(fh, 1)
                              if re.search(r"(?<![\w.])id\(", line)]
    assert found == []
