"""What a sweep of engines and a repeat search reuse, against the JAX package.

* an engine whose -W changes between searches scans planes of the new
  number of tiles (a plane's cache key holds it): the bytes of a fresh
  ``merpcr_tpu`` engine at each -W, on the record path, on a stream run
  and under a three-shard CPU mesh;
* the record store (dirty rates, stream layouts, uploaded planes) is one
  per process, as the JAX package's ``_DEVICE_PLANE_CACHE``: a second fresh
  engine over the same records uploads no plane and samples no dirty rate;
  a sweep with a fresh engine per -M uploads planes only where the margin
  cap (and so the halos) moves; engines of two -W share one record;
* the store holds at most ``OWNERS_MAX`` owners, found by identity;
* a repeat search over the same record objects builds no plan; a
  reassigned ``sequence``, another list or an appended record does.

The JAX side runs its device path (``MERPCR_TPU_HOST_MAX=0``) on a fresh
engine per search, given copies of the records (its caches are keyed by
``id()``). Everything compared is bytes: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch import engine as engine_mod  # noqa: E402
from merpcr_tpu_torch.io.fasta import record_packed  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.parallel import make_mesh, sharded  # noqa: E402

from .conftest import run_search  # noqa: E402
from .test_torch_stream import write_corpus  # noqa: E402

# A lone record, an empty record, then a run of two: with 2^12-position
# tiles the lone record and the run (12,299 laid-out positions each: the
# run's second record starts at 6,008) scan 3 tiles at W = 12 and 4 at
# W = 11, which on three shards is 1 and 2 tiles per shard.
LENGTHS = [12_299, 0, 6_000, 6_291]
TILE = 1 << 12
# -I 1, BASELINE config 4's verify; every search of this file at -W 11 and
# -M <= 64 shares the JAX package's compiled programs
PARAMS = {"iupac_mode": 1}
_JAX: dict = {}


@pytest.fixture(autouse=True)
def _fresh_store(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    engine_mod._OWNERS.clear()


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(tmp_path_factory.mktemp("shared"), 73, LENGTHS, n_sts=30,
                        dirty=0.01, ambiguous_sts=True)


@pytest.fixture
def counts(monkeypatch) -> dict:
    """Uploads (``parallel.sharded.upload``: planes, record tables) and
    dirty-rate samples (``_dirty_of``, ``_run_dirty_pos``) of the port."""
    got = {"uploads": 0, "dirty": 0}
    real_up, real_of, real_run = sharded.upload, MerPCR._dirty_of, MerPCR._run_dirty_pos

    def upload(arr, dev):
        got["uploads"] += 1
        return real_up(arr, dev)

    def dirty_of(seq, packed):
        got["dirty"] += 1
        return real_of(seq, packed)

    def run_dirty_pos(items):
        got["dirty"] += 1
        return real_run(items)

    monkeypatch.setattr(sharded, "upload", upload)
    monkeypatch.setattr(MerPCR, "_dirty_of", staticmethod(dirty_of))
    monkeypatch.setattr(MerPCR, "_run_dirty_pos", staticmethod(run_dirty_pos))
    return got


def _jax(sts, recs, **params) -> str:
    """A fresh JAX engine's bytes, kept per input for this file's reuse."""
    params = {**PARAMS, **params}
    key = (sts, tuple((r.defline, r.sequence) for r in recs), tuple(sorted(params.items())))
    if key not in _JAX:
        jeng = JaxMerPCR(**params)
        assert jeng.load_sts_file(sts)
        _JAX[key] = run_search(jeng, [FASTARecord(defline=r.defline, sequence=r.sequence)
                                      for r in recs])
    return _JAX[key]


def _engine(sts, **params) -> MerPCR:
    eng = MerPCR(device="cpu", **{**PARAMS, **params})
    eng._tile_len_override = TILE
    assert eng.load_sts_file(sts)
    return eng


@pytest.mark.parametrize("what", ["record", "stream", "mesh"])
def test_wordsize_change_between_searches(corpus, monkeypatch, what):
    """One engine at -W 12, 11, 12 (the STS set reloaded for each): every
    search equals a fresh JAX engine's at that -W, and each plane's scan
    is dispatched over its tiles at that -W, 3 at W 12 and 4 at W 11 (on
    three shards 1 and 2 per shard). A plane kept under a key without its
    number of tiles made the W 11 search raise ("plane shorter than its
    tiles") or, under a mesh, scan the W 12 tiles per shard."""
    sts, fa = corpus
    dispatched = []
    real = tscan.dispatch_stream

    def spy(*args, **kw):  # n_tiles is the ninth argument
        dispatched.append(args[8])
        return real(*args, **kw)

    monkeypatch.setattr(tscan, "dispatch_stream", spy)
    monkeypatch.setattr(sharded, "dispatch_stream", spy)
    eng = _engine(sts, wordsize=12)
    recs = eng.load_fasta_file(fa)
    shards = 3 if what == "mesh" else 1
    if what == "record":
        recs = recs[:1]
    elif what == "stream":
        recs = recs[2:]
    else:
        eng.use_mesh(make_mesh(("cpu",) * shards))
    for W in (12, 11, 12):
        eng.wordsize = W
        assert eng.load_sts_file(sts)
        dispatched.clear()
        got = run_search(eng, recs)
        assert got == _jax(sts, recs, wordsize=W), W
        assert got.count("\n") >= 4
        tiles = 4 if W == 11 else 3
        planes = {"record": [1], "stream": [2], "mesh": [1, 2]}[what]
        assert [(s.tiles, s.records) for s in eng.last_scans] == [(tiles, r) for r in planes]
        per_shard = -(-tiles // shards)
        assert dispatched == [per_shard] * (shards * len(planes)), W


def test_second_fresh_engine_uploads_and_samples_nothing(corpus, counts):
    """A fresh engine's first search over records another engine searched:
    no plane or record table uploaded, no dirty rate sampled, JAX's
    bytes."""
    sts, fa = corpus
    first = _engine(sts)
    recs = first.load_fasta_file(fa)
    want = _jax(sts, recs)
    assert run_search(first, recs) == want
    # the lone record's plane and rmeta, the run's plane, rmeta and recmap
    assert counts == {"uploads": 5, "dirty": 2}
    assert run_search(_engine(sts), recs) == want
    assert counts == {"uploads": 5, "dirty": 2}
    assert len(engine_mod._OWNERS) == 2


def test_margin_sweep_of_fresh_engines(corpus, counts):
    """``tools/margin_sweep.py``'s workflow over the run of two records: a
    fresh engine per -M, at M = 50, 60, ..., 100 and -I 1. The plane and its
    record tables are uploaded at M 50 (cap 64) and M 70 (cap 128) only, the
    run's dirty rate sampled at M 50 only, and every search equals a fresh
    JAX engine's at that -M."""
    sts, fa = corpus
    recs = MerPCR(device="cpu").load_fasta_file(fa)[2:]
    uploads, samples, caps = [], [], []
    for margin in range(50, 101, 10):
        before = dict(counts)
        eng = _engine(sts, margin=margin)
        got = run_search(eng, recs)
        assert got == _jax(sts, recs, margin=margin), margin
        assert got.count("\n") >= 2
        uploads.append(counts["uploads"] - before["uploads"])
        samples.append(counts["dirty"] - before["dirty"])
        caps.append(eng.last_scans[0].cfg.margin)
    assert caps == [64, 64, 128, 128, 128, 128]
    assert uploads == [3, 0, 3, 0, 0, 0]
    assert samples == [1, 0, 0, 0, 0, 0]


def test_engines_of_two_wordsizes_share_a_record(corpus, counts):
    """Engines at -W 11 and -W 12 take turns over the same records: each
    search equals JAX's at its -W; the dirty rates are sampled once per
    record or run and shared, each -W's planes uploaded once."""
    sts, fa = corpus
    engines = {W: _engine(sts, wordsize=W) for W in (11, 12)}
    recs = engines[11].load_fasta_file(fa)
    for turn in range(2):
        for W, eng in engines.items():
            before = counts["uploads"]
            assert run_search(eng, recs) == _jax(sts, recs, wordsize=W), (turn, W)
            assert counts["uploads"] - before == (5 if turn == 0 else 0), (turn, W)
    assert counts["dirty"] == 2
    assert len(engine_mod._OWNERS) == 2


def test_store_holds_at_most_owners_max():
    """``OWNERS_MAX`` (64, the JAX package's bound) owners are kept; the
    next one clears the store. Entries are found by the identity of every
    array they hold, never by equal contents."""
    arrays = [np.full(4, i, dtype=np.uint8) for i in range(engine_mod.OWNERS_MAX + 1)]
    entries = [engine_mod._owned((a,)) for a in arrays[:-1]]
    assert len(engine_mod._OWNERS) == engine_mod.OWNERS_MAX == 64
    assert all(engine_mod._owned((a,)) is e for a, e in zip(arrays, entries))
    assert engine_mod._owned((arrays[0].copy(),)) is not entries[0]  # store cleared
    assert len(engine_mod._OWNERS) == 1
    assert engine_mod._owned((arrays[1],)) is not entries[1]
    run = engine_mod._owned((arrays[2], arrays[3]))
    assert engine_mod._owned((arrays[2], arrays[3])) is run
    assert engine_mod._owned((arrays[3], arrays[2])) is not run
    assert engine_mod._owned((arrays[2],)) is not run
    assert len(engine_mod._OWNERS) == 5


def test_search_after_the_store_was_cleared(corpus, counts):
    """Owners past the bound clear the store between two searches: the
    second search samples and uploads again, with JAX's bytes."""
    sts, fa = corpus
    eng = _engine(sts)
    recs = eng.load_fasta_file(fa)
    want = _jax(sts, recs)
    assert run_search(eng, recs) == want
    for _ in range(engine_mod.OWNERS_MAX - 1):  # the last one clears the store
        engine_mod._owned((np.zeros(1, dtype=np.uint8),))
    assert len(engine_mod._OWNERS) == 1
    assert run_search(eng, recs) == want
    assert counts == {"uploads": 10, "dirty": 4}
    assert len(engine_mod._OWNERS) == 3


def test_repeat_search_reuses_its_plan(corpus, monkeypatch):
    """A repeat search over the same record objects, also in another list,
    builds no plan; a reassigned ``sequence`` (same length, other bases), a
    reordered list and an appended record each build one, and every search
    equals JAX's."""
    sts, fa = corpus
    eng = _engine(sts)
    recs = eng.load_fasta_file(fa)
    built = []
    real = MerPCR._build_plan
    monkeypatch.setattr(MerPCR, "_build_plan",
                        lambda self, rs: built.append(len(rs)) or real(self, rs))

    def search(rs) -> str:
        got = run_search(eng, rs)
        assert got == _jax(sts, rs)
        return got

    first = search(recs)
    assert search(recs) == first and search(list(recs)) == first
    assert built == [4]

    def other_bases(seq: str) -> str:
        """The same length and letters: the first half's plants stay, the
        second half is reversed."""
        return seq[: len(seq) // 2] + seq[len(seq) // 2 :][::-1]

    old_packed = record_packed(recs[3])
    recs[3].sequence = other_bases(recs[3].sequence)
    changed = search(recs)
    assert changed != first and built == [4, 4]
    assert record_packed(recs[3]) is not old_packed
    # another record object in the list, of the same length
    recs[0] = FASTARecord(defline=recs[0].defline, sequence=other_bases(recs[0].sequence))
    assert search(recs) not in (first, changed) and built == [4, 4, 4]
    recs += [FASTARecord(defline=">empty", sequence=""),
             FASTARecord(defline=">again scaffold 0 again", sequence=recs[0].sequence)]
    got = search(recs)
    assert built == [4, 4, 4, 6] and "\nagain\t" in got
    assert [item[:2] for item in eng._plan(recs)] == [
        ("single", 0), ("single", 1), ("stream", [2, 3]), ("single", 4), ("single", 5)]
    assert built == [4, 4, 4, 6]
