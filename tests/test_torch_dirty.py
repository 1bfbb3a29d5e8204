"""The port's dirty rates, which decide whether the dirty-span filter (K10)
arms, against the JAX package's.

* ``MerPCR._dirty_of`` reads only the sampled windows, and returns the
  JAX ``_dirty_of``'s (w_unit, w_pos) exactly on packed and raw records of
  the lengths at its branch edges, clean, with scattered ambiguity letters
  (0.1 % to 50 %) and with N runs;
* ``MerPCR._run_dirty_pos``, the vectorised pass over a stream run, equals
  the per-record loop of the JAX engine (``merpcr_tpu/engine.py:949-962``),
  float for float, and K10 arms on the same runs;
* the rates are computed once per record or run, then come from the cache.

Everything is made from seeds with numpy; tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402

from .conftest import run_search  # noqa: E402
from .test_torch_stream import write_corpus  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMB = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)
RAW_JUNK = np.frombuffer(b"U-*.0xZ", dtype=np.uint8)  # outside the 16 letters
LENGTHS = [0, 1, 12, 13, 14, 26, 27, 28, (1 << 15) - 1, (1 << 15) + 1, (1 << 17) + 7]
DIRT = [("clean", 0.0), ("p001", 0.001), ("p01", 0.01), ("p1", 0.1), ("p5", 0.5),
        ("nruns", None)]


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _genome(rng, n: int, dirt, letters=AMB) -> np.ndarray:
    """n random ACGT bases; ``dirt`` of them scattered ambiguity letters, or
    (None) a few runs of N of 1 to 200 bases."""
    g = rng.choice(ACGT, size=n)
    if dirt is None:
        for _ in range(max(1, n // 2000)):
            if n:
                a = int(rng.integers(0, n))
                g[a : a + int(rng.integers(1, 201))] = ord("N")
    elif dirt:
        k = rng.random(n) < dirt
        g[k] = rng.choice(letters, size=int(k.sum()))
    return g


def _record(g: np.ndarray) -> FASTARecord:
    return FASTARecord(defline=">r", sequence=g.tobytes().decode("latin-1"))


@pytest.mark.parametrize("n", LENGTHS)
def test_dirty_of_packed_equals_jax(n):
    """Packed records: equal (w_unit, w_pos) at every length and dirt."""
    rng = np.random.default_rng(n + 1)
    for _name, dirt in DIRT:
        rec = _record(_genome(rng, n, dirt))
        seq, packed = record_seq_bytes(rec), record_packed(rec) if n else None
        assert MerPCR._dirty_of(seq, packed) == JaxMerPCR._dirty_of(seq, packed)


@pytest.mark.parametrize("n", LENGTHS)
def test_dirty_of_raw_equals_jax(n):
    """Raw-byte records (packed None): bytes outside the 16 letters and
    ambiguity letters, equal (w_unit, w_pos)."""
    rng = np.random.default_rng(n + 2)
    for _name, dirt in DIRT:
        g = _genome(rng, n, dirt, letters=np.concatenate([AMB, RAW_JUNK]))
        assert MerPCR._dirty_of(g, None) == JaxMerPCR._dirty_of(g, None)


def test_dirty_of_reads_no_whole_record_prefix_sum(monkeypatch):
    """The sample reads windows: no prefix sum over the record."""
    rng = np.random.default_rng(5)
    rec = _record(_genome(rng, 1 << 17, 0.01))
    seq, packed = record_seq_bytes(rec), record_packed(rec)
    want = JaxMerPCR._dirty_of(seq, packed), JaxMerPCR._dirty_of(seq, None)

    def refuse(*args, **kwargs):
        raise AssertionError("cumsum")

    monkeypatch.setattr(np, "cumsum", refuse)
    assert (MerPCR._dirty_of(seq, packed), MerPCR._dirty_of(seq, None)) == want


def _jax_run_rate(items) -> float:
    """The JAX engine's length-weighted w_pos of a run, its loop's order."""
    wps = tsum = 0.0
    for seq, pk in items:
        wps += JaxMerPCR._dirty_of(seq, pk)[1] * len(seq)
        tsum += len(seq)
    return wps / tsum


@pytest.mark.parametrize("dirt", [0.0, 0.0005, 0.002, 0.01, 0.2, None])
def test_run_rate_equals_the_per_record_loop(dirt):
    """A run of records from 1 base to past 2^17 (strides 1 to 4, records
    below the 13-byte branch): the vectorised pass gives the loop's float,
    and the per-record counts its integers."""
    rng = np.random.default_rng(17)
    lengths = [1, 5, 24, 25, 26, 27, 60, 3_000, 40_000, (1 << 15) + 3, 70_001,
               (1 << 17) + 9, 7, 900]
    recs = [_record(_genome(rng, n, dirt)) for n in lengths]
    items = [(record_seq_bytes(r), record_packed(r)) for r in recs]
    assert MerPCR._run_dirty_pos(items) == _jax_run_rate(items)
    for one in items:  # each record's count on its own
        assert MerPCR._run_dirty_pos([one]) == _jax_run_rate([one])


@pytest.mark.parametrize("dirt", [0.0, 0.001, 0.003, 0.006, 0.01])
def test_stream_dirty_bloom_arms_as_jax(tmp_path, dirt):
    """Scaffold runs around the K10 threshold (w_pos 1/256): the port's
    stream config arms the dirty-span filter exactly where the JAX
    engine's does."""
    sts, fa = write_corpus(tmp_path, 23, np.random.default_rng(23).integers(
        50, 6_000, size=30).tolist(), n_sts=10, dirty=dirt)
    eng, jeng = MerPCR(device="cpu"), JaxMerPCR()
    assert eng.load_sts_file(sts) and jeng.load_sts_file(sts)
    (_, _, items), = eng._plan(eng.load_fasta_file(fa))
    cfg = eng._stream_plane(items)[0]
    jcfg = jeng._base_config(cfg.tile_len, packed=True, stream=True,
                             dirty_pos=jeng._quantize_dirty(_jax_run_rate(items)))
    assert cfg.dirty_bloom == jcfg.dirty_bloom
    if dirt in (0.0, 0.01):  # the ends of the sweep: off, and on
        assert cfg.dirty_bloom == bool(dirt)


def test_rates_are_computed_once(tmp_path, monkeypatch):
    """Repeat searches take a record's and a run's rate from the cache: one
    ``_dirty_of`` and one ``_run_dirty_pos`` call over three searches, and
    none for a loose (-N 2) search."""
    calls = {"record": 0, "run": 0}
    real_of, real_run = MerPCR._dirty_of, MerPCR._run_dirty_pos

    def count_of(seq, packed):
        calls["record"] += 1
        return real_of(seq, packed)

    def count_run(items):
        calls["run"] += 1
        return real_run(items)

    monkeypatch.setattr(MerPCR, "_dirty_of", staticmethod(count_of))
    monkeypatch.setattr(MerPCR, "_run_dirty_pos", staticmethod(count_run))
    sts, fa = write_corpus(tmp_path, 29, [20_000, 0, 3_000, 4_000], n_sts=10, dirty=0.01)
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(sts)
    recs = eng.load_fasta_file(fa)
    outs = [run_search(eng, recs) for _ in range(3)]
    assert outs[0] == outs[1] == outs[2] and calls == {"record": 1, "run": 1}
    eng.mismatches = 2
    run_search(eng, recs)
    assert calls == {"record": 1, "run": 1}
