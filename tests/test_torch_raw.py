"""The raw-byte path (K9) of the port against the JAX package.

Records with a byte outside the 16-letter FASTA alphabet (RNA ``U``,
alignment ``-``/``.``, digits, latin-1 letters; only the API can pass
them, the FASTA loader drops such bytes) are scanned as raw-byte planes,
one byte per position (``merpcr_tpu/ops/scan.py`` with ``cfg.packed``
False): a per-position W-mer front end over the table's occupancy map
(K9a), one bucket per flagged position (K9b, ``pos_total`` 0), and byte
verifies of both primers (K9c: case-insensitive at -I 0, the reference's
256 x 256 match table at -I 1).

* byte semantics: ``units.scode``/``fold`` on all 256 bytes against
  ``encoding.SCODE`` and the JAX ``_encode_codes``/``_byte_fold``;
* per 2^15-position tile, at W = 3, 11, 12, 13, 14, 16, -I 0/1, -N 0/1/2
  and -M 50/300/2000: all five totals (``pos_total`` 0) and every hit
  row against ``get_scan_fn`` with the JAX engine's
  ``_base_config(tile_len, packed=False)``, the flag words against the
  ``stop="words"`` checksum, and each plain kernel version against its
  JAX stage;
* whole searches (``MERPCR_TPU_HOST_MAX=0``, fresh engines): the
  ``test_edges.py`` record, an all-``U`` rendering at -I 0 and -I 1,
  ``U`` primers, ``ÿ``/``\\x00``/``-`` beside record ends, records no
  longer than a word, packable and unpackable records mixed, and one
  engine swept -N 0/1/0 over a raw and a packed record.

The port runs the plain versions of its kernels (CPU tensors); the JAX
side its XLA program on the CPU. Everything compared is an integer or a
byte: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import merpcr_tpu.ops.scan as jscan  # noqa: E402
from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu.models import FASTARecord as JaxFASTARecord  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.ops.encoding import SCODE  # noqa: E402
from merpcr_tpu_torch.ops.expand import expand_raw_plain  # noqa: E402
from merpcr_tpu_torch.ops.front_end import front_end_raw, front_end_raw_plain  # noqa: E402
from merpcr_tpu_torch.ops.margin_p2 import margin_p2_raw_plain  # noqa: E402
from merpcr_tpu_torch.ops.table import table_from_numpy  # noqa: E402
from merpcr_tpu_torch.ops.units import fold, scode  # noqa: E402
from merpcr_tpu_torch.ops.verify_p1 import verify_p1_raw_plain  # noqa: E402

from .conftest import run_search  # noqa: E402
from .test_edges import P1, P2, _genome  # noqa: E402
from .test_torch_mismatch import _assert_tile_equal  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
JUNK = np.frombuffer(b"-*.0123456789\xe9\xc9ZE\xff\x00 @[`{", dtype=np.uint8)
TILE = 1 << 15
N_STS = 40
CAPS = {"cand_cap": 1 << 17, "anch_cap": 4096, "hit_cap": 8192}


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


# ---------------------------------------------------------------- corpus
def _sts_rows(rng):
    """40 STS of random ACGT primers; every 8th (from 5) has its primer 1
    written in U (an RNA-style primer: its sites match only at -I 1),
    every 8th (from 6) an N in primer 1 off its 3'-end 16 bases."""
    rows = []
    for i in range(N_STS):
        p1 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        p2 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        rows.append([f"R{i}", p1, p2, int(rng.integers(100, 400))])
    return rows


def _written(row, i):
    sid, p1, p2, size = row
    if i % 8 == 5:
        p1 = p1.replace(b"T", b"U")
    elif i % 8 == 6:
        p1 = b"N" + p1[1:]
    return sid, p1, p2, size


def _plant(seq, pos, left, right, size):
    if pos < 0 or pos + size > len(seq):
        return
    seq[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
    seq[pos + size - len(right) : pos + size] = np.frombuffer(right, dtype=np.uint8)


def make_corpus(n: int = TILE + 20_000, seed: int = 11):
    """(sts text, record bytes uint8[n]): random ACGT with every other STS
    planted in both orientations (some off their stated size by 1..40,
    four by 250 and four by 1,500 bases, one across the tile boundary),
    then rendered: one planted site and a 3 kb span in U, a lowercase
    span, 60 junk bytes scattered, 'ÿ' before the first planted site."""
    rng = np.random.default_rng(seed)
    rows = _sts_rows(rng)
    seq = rng.choice(ACGT, size=n)
    for i in range(0, N_STS, 2):
        _, p1, p2, size = rows[i]
        rc1 = p1.translate(COMP)[::-1]
        delta = (250, 1500)[i % 4 // 2] if i in (10, 12, 14, 16, 18, 20, 22, 24) \
            else int(rng.integers(-40, 41)) if i % 3 else 0
        _plant(seq, int(rng.integers(0, n - 2000)), p1, p2, size + delta)
        _plant(seq, int(rng.integers(0, n - 2000)), p2, rc1, size - delta)
    _, p1, p2, size = rows[1]
    _plant(seq, TILE - 60, p1, p2, size)  # across the tile boundary
    _, p1, p2, size = rows[3]
    _plant(seq, 0, p1, p2, size)  # at the record start
    seq[size + 1] = 0xFF
    seq[5000:8000] = np.where(seq[5000:8000] == ord("T"), ord("U"), seq[5000:8000])
    seq[9000:9500] = np.frombuffer(seq[9000:9500].tobytes().lower(), dtype=np.uint8)
    at = rng.integers(400, n, size=60)
    seq[at] = JUNK[rng.integers(0, len(JUNK), size=60)]
    sts = "".join(f"{sid}\t{p1.decode()}\t{p2.decode()}\t{size}\talias {sid}\n"
                  for sid, p1, p2, size in (_written(r, i) for i, r in enumerate(rows)))
    return sts, seq


# ---------------------------------------------------------------- byte semantics
def test_scode_and_fold_on_every_byte():
    b = torch.arange(256, dtype=torch.int64)
    got = scode(b).numpy()
    np.testing.assert_array_equal(got, SCODE)
    np.testing.assert_array_equal(got, np.asarray(jscan._encode_codes(np.arange(256))))
    np.testing.assert_array_equal(fold(b).numpy(),
                                  np.asarray(jscan._byte_fold(np.arange(256))))
    # ASCII letters only: latin-1 letters keep their case, and the bytes
    # next to the letter ranges are no letters
    assert (fold(torch.tensor([0xE9, 0xC9, ord("@"), ord("["), ord("`"), ord("{")]))
            .tolist() == [0xE9, 0xC9, ord("@"), ord("["), ord("`"), ord("{")])
    assert set(got[[0, 0xFF, ord("U"), ord("u"), ord("N")]].tolist()) == {100, 3}


# ---------------------------------------------------------------- per tile
_ENGINES: dict = {}


def _engine(tmp_path_factory, W: int, iupac: int, margin: int):
    key = (W, iupac, margin)
    if key not in _ENGINES:
        sts, _ = make_corpus()
        path = tmp_path_factory.mktemp(f"raw{W}_{iupac}_{margin}") / "r.sts"
        path.write_text(sts)
        eng = JaxMerPCR(wordsize=W, iupac_mode=iupac, margin=margin)
        assert eng.load_sts_file(str(path))
        _ENGINES[key] = (eng, table_from_numpy(eng._table_host, eng._meta, "cpu"))
    return _ENGINES[key]


class _RawTiles:
    """The corpus record as a raw plane, and both packages' configs."""

    def __init__(self, tmp_path_factory, W: int, iupac: int, margin: int):
        _, self.seq = make_corpus()
        eng, self.ttable = _engine(tmp_path_factory, W, iupac, margin)
        cfg = eng._base_config(TILE, packed=False)
        assert not cfg.packed and not cfg.strict and not cfg.dirty_bloom
        self.jcfg = jscan.ScanConfig(**{**cfg.__dict__, "cpos_cap": TILE,
                                        "pos_cap": 1024, **CAPS})
        self.jtable = eng._table
        m = eng._meta
        self.tcfg = tscan.default_config(
            wordsize=W, margin=margin, lead=m.lead, max_pcr_size=eng.max_pcr_size,
            p1_max=m.p1_max, p2_max=m.p2_max, tile_len=TILE, stride=m.stride,
            exact_group=m.exact_group, qbloom_bits=m.qbloom_bits, strict=True,
            bloom_bits=m.bloom_bits, iupac=bool(iupac), dirty_pos_rate=0.5,
            packed=False)
        assert not self.tcfg.strict and not self.tcfg.dirty_bloom  # forced off
        assert (self.tcfg.lead, self.tcfg.tail, self.tcfg.tile_buf_in) == (
            cfg.lead, cfg.tail, cfg.tile_buf_in)
        self.W, self.n = W, len(self.seq)
        self.total_scan = self.n - W + 1
        self.n_tiles = -(-self.total_scan // TILE)
        self.plane = np.zeros(cfg.lead + self.n_tiles * TILE + cfg.tail, dtype=np.uint8)
        self.plane[cfg.lead : cfg.lead + self.n] = self.seq

    def tiles(self):
        for t in range(self.n_tiles):
            tile = self.plane[t * TILE : t * TILE + self.jcfg.tile_buf_in]
            yield t, tile, int(np.clip(self.total_scan - t * TILE, 0, TILE))


_TILES: dict = {}


def _tiles(tmp_path_factory, W, iupac, margin) -> _RawTiles:
    key = (W, iupac, margin)
    if key not in _TILES:
        _TILES[key] = _RawTiles(tmp_path_factory, W, iupac, margin)
    return _TILES[key]


def _compare(c: _RawTiles, runtimes) -> tuple:
    """Every tile through both packages at each runtime (-M, -N, -X).
    Returns (pairs, anchors, hits) sums."""
    fn = jscan.get_scan_fn(c.jcfg)
    pairs = anch = hits = 0
    for rt in runtimes:
        rt = np.asarray(rt, dtype=np.int32)
        for t, tile, n_scan in c.tiles():
            j = jax.device_get(fn(c.jtable, tile, np.int32(t * TILE), np.int32(n_scan),
                                  np.int32(c.n), rt))
            assert int(j.pair_total) <= CAPS["cand_cap"]
            o = tscan.scan_tile(c.tcfg, c.ttable, torch.from_numpy(tile), t * TILE,
                                n_scan, tscan.record_rmeta(c.n, "cpu"), None, tuple(rt))
            _assert_tile_equal(o, j, (c.W, tuple(rt), t))
            assert o.pos_total == 0
            pairs += o.pair_total
            anch += o.anch_total
            hits += o.hit_total
    return pairs, anch, hits


def _words_checksum(c: _RawTiles, tile, n_scan) -> int:
    return int(jax.jit(lambda tb, ns: jscan._scan_tile_impl(
        c.jcfg, c.jtable, tb, np.int32(0), ns, np.int32(c.n), stop="words",
    ).c_total)(tile, np.int32(n_scan)))


@pytest.mark.parametrize("iupac", [0, 1])
@pytest.mark.parametrize("W", [3, 11, 12, 13, 14, 16])
def test_raw_tiles_match_jax(tmp_path_factory, W, iupac):
    """-M 0/50 x -N 0/1/2 (-X 1), and -X 0/3 at -N 2: totals and rows;
    at -I 0 the flag words against the JAX ``stop="words"`` checksum."""
    c = _tiles(tmp_path_factory, W, iupac, 50)
    runtimes = [(m, n, 1) for m in (0, 50) for n in (0, 1, 2)] + [(50, 2, 0), (50, 2, 3)]
    pairs, anch, hits = _compare(c, runtimes)
    assert pairs > 0 and anch > 0
    if W <= 13:  # wider words leave the planted sites' W-mers intact too,
        assert hits > 0  # but the junk bytes may split a few
    if iupac == 0:
        for _t, tile, n_scan in c.tiles():
            words, c_total = front_end_raw(torch.from_numpy(tile), c.ttable.bloom,
                                           c.ttable.bloom_bits, W, c.tcfg.lead, TILE,
                                           n_scan)
            got = int(words.to(torch.int64).sum()) & 0xFFFFFFFF
            assert got == _words_checksum(c, tile, n_scan) & 0xFFFFFFFF
            assert int(c_total) == sum(bin(w & 0xFFFFFFFF).count("1")
                                       for w in words.tolist())


@pytest.mark.parametrize("W,iupac,margin", [(11, 1, 300), (11, 0, 2000), (14, 1, 2000)])
def test_raw_tiles_at_large_margins_match_jax(tmp_path_factory, W, iupac, margin):
    """-M 300 and 2000 (rank-chunked in the JAX stage, K13): the +250 and
    +1,500 plants appear exactly from the margin that admits them."""
    c = _tiles(tmp_path_factory, W, iupac, margin)
    _, _, hits_small = _compare(c, [(50, 0, 1)])
    _, _, hits = _compare(c, [(margin, 0, 1)])
    assert hits > hits_small > 0
    _compare(c, [(margin, 2, 1), (300, 1, 0)])


def test_raw_plain_stages_match_jax_stages(tmp_path_factory):
    """Each plain kernel version alone against the JAX stage it replaces:
    front_end_raw_plain's words and c_total (``stop="words"``), then
    expand_raw_plain (pairs in (position, slot) order, pos_total 0),
    verify_p1_raw_plain (``stop="p1"``) and margin_p2_raw_plain (the rows),
    at -I 1 -N 1."""
    c = _tiles(tmp_path_factory, 11, 1, 50)
    tt, cfg, W = c.ttable, c.tcfg, c.W
    fn = jscan.get_scan_fn(c.jcfg)
    p1_fn = jax.jit(lambda tb, ts, ns, rt: jscan._scan_tile_impl(
        c.jcfg, c.jtable, tb, ts, ns, np.int32(c.n), rt, stop="p1").c_total)
    rt = np.asarray([50, 1, 1], dtype=np.int32)
    hits = 0
    for t, tile, n_scan in c.tiles():
        x = torch.from_numpy(tile)
        j = jax.device_get(fn(c.jtable, tile, np.int32(t * TILE), np.int32(n_scan),
                              np.int32(c.n), rt))
        words, c_total = front_end_raw_plain(x, tt.bloom, tt.bloom_bits, W, cfg.lead,
                                             TILE, n_scan)
        assert int(c_total) == int(j.c_total)
        assert (int(words.to(torch.int64).sum()) & 0xFFFFFFFF
                == _words_checksum(c, tile, n_scan) & 0xFFFFFFFF)
        entry, ppos, pos_total, pair_total = expand_raw_plain(
            x, words, tt.csr, tt.emeta.shape[0], W, cfg.lead, TILE, n_scan)
        assert (pos_total, pair_total) == (int(j.pos_total), int(j.pair_total)) == (0, pair_total)
        assert (ppos[1:] >= ppos[:-1]).all()  # position order
        rm = tscan.record_rmeta(c.n, "cpu")
        a_idx = verify_p1_raw_plain(x, entry, ppos, tt.emeta, tt.p1_bytes, tt.match,
                                    t * TILE, rm, None, cfg.lead, 1, 1)
        assert a_idx.numel() == int(j.anch_total) == int(
            p1_fn(tile, np.int32(t * TILE), np.int32(n_scan), rt))
        rows = margin_p2_raw_plain(x, a_idx, entry, ppos, tt.emeta, tt.p2_bytes,
                                   tt.match, t * TILE, rm, None, cfg.lead, 50, 1, 1)
        h = int(j.hit_total)
        assert rows.shape[0] == h
        for k, name in enumerate(("pos1", "pos2", "entry", "pair_order", "rank", "rec")):
            np.testing.assert_array_equal(rows[:, k].numpy(),
                                          np.asarray(getattr(j, name))[:h], err_msg=name)
        hits += h
    assert hits > 0


def test_byte_reads_outside_the_plane_match_nothing():
    """A read past the plane is -1, never 0xFF: a primer byte 0xFF (ÿ) next
    to the plane's edge must not match it."""
    from merpcr_tpu_torch.ops.units import byte_matches, bytes_at

    plane = torch.tensor([0xFF, ord("A")], dtype=torch.uint8)
    s = bytes_at(plane, torch.tensor([[-1, 0, 1, 2]]))
    assert s.tolist() == [[-1, 0xFF, ord("A"), -1]]
    primer = torch.tensor([[0xFF, 0xFF, ord("a"), 0xFF]], dtype=torch.uint8)
    e = torch.zeros(1, dtype=torch.int64)
    assert byte_matches(s, e, primer, None).tolist() == [[False, True, True, False]]
    from merpcr_tpu_torch.ops.encoding import match_matrix

    match = torch.from_numpy(match_matrix(True).reshape(-1))
    assert byte_matches(s, e, primer, match).tolist() == [[False, True, True, False]]


# ---------------------------------------------------------------- whole searches
def _records(pkg, seqs):
    cls = JaxFASTARecord if pkg == "jax" else FASTARecord
    return [cls(defline=f">{label} test record", sequence=s) for label, s in seqs]


def _search_both(tmp_path, sts: str, seqs, tile_len=None, **params):
    """(port output, JAX output, port engine) of one search over the
    (label, sequence) records, fresh engines."""
    path = tmp_path / "s.sts"
    path.write_text(sts)
    outs = []
    for eng, kind in ((MerPCR(device="cpu", **params), "torch"), (JaxMerPCR(**params), "jax")):
        eng._tile_len_override = tile_len
        assert eng.load_sts_file(str(path))
        outs.append(run_search(eng, _records(kind, seqs)))
        if kind == "torch":
            port = eng
    return outs[0], outs[1], port


def test_edges_record_matches_jax(tmp_path):
    """The ``tests/test_edges.py`` API record: 'uUuU' and 'EéZ9 ' spliced
    into a planted genome."""
    g = _genome(seed=7, n=2000)
    g = g[:100] + "uUuU" + g[104:300] + "EéZ9 " + g[305:]
    for params in ({}, {"iupac_mode": 1}, {"mismatches": 2}):
        port, ref, eng = _search_both(tmp_path, f"S1\t{P1}\t{P2}\t200\n",
                                      [("direct", g)], **params)
        assert port == ref and port.count("\n") >= 1, params
        assert [c.packed for c, _, _ in eng.last_scans] == [False]


def _rna_corpus():
    """(sts, DNA record, its all-U rendering)."""
    sts, seq = make_corpus(n=12_000, seed=3)
    seq = np.where(np.isin(seq, JUNK), ord("A"), seq).astype(np.uint8)
    seq = np.where(seq == ord("U"), ord("T"), seq).astype(np.uint8)
    dna = seq.tobytes().decode("latin-1")
    return sts, dna, dna.replace("T", "U")


@pytest.mark.parametrize("iupac", [0, 1])
def test_all_u_rendering_matches_jax(tmp_path, iupac):
    """An RNA rendering (every T a U): -I 0 finds no site whose primers
    hold a T, -I 1 prints the DNA record's lines."""
    sts, dna, rna = _rna_corpus()
    port, ref, eng = _search_both(tmp_path, sts, [("r", rna)], iupac_mode=iupac)
    assert port == ref
    dna_out, _, _ = _search_both(tmp_path, sts, [("r", dna)], iupac_mode=iupac)
    if iupac:
        assert port == dna_out and port.count("\n") > 5
    else:
        assert port.count("\n") < dna_out.count("\n")
    assert not eng.last_scans[0][0].packed


@pytest.mark.parametrize("iupac", [0, 1])
def test_u_primers_match_jax(tmp_path, iupac):
    """RNA-style primers (U for T) on a DNA record that carries a byte
    outside the alphabet: the hash treats U as T, only the verify decides
    (JAX ``test_u_primers_iupac``)."""
    g = _genome(seed=9, n=3000) + "-"
    port, ref, _ = _search_both(tmp_path, f"S1\t{P1.replace('T', 'U')}\t{P2}\t200\n",
                                [("g", g)], iupac_mode=iupac)
    assert port == ref and port.count("\n") == iupac


@pytest.mark.parametrize("edge", ["\xff", "\x00", "-"])
def test_bytes_beside_record_ends_match_jax(tmp_path, edge):
    """The planted amplicon fills the record from its first to its last
    base, with ``edge`` bytes on both sides inside the record (and the
    zero padding of the plane beyond)."""
    amp = _genome(seed=4, n=200, plant=False)
    amp = P1 + amp[len(P1) : 200 - len(P2)] + P2
    for seq in (edge + amp + edge, amp + edge, edge * 3 + amp):
        for params in ({}, {"iupac_mode": 1}, {"mismatches": 1, "three_prime_match": 0}):
            port, ref, _ = _search_both(tmp_path, f"S1\t{P1}\t{P2}\t200\n"
                                        f"S2\t{P1}\t{P2}\t198\n", [("e", seq)], **params)
            assert port == ref, (repr(seq[:3]), params)
            assert port.count("\n") >= 1


def test_records_no_longer_than_a_word_match_jax(tmp_path):
    """Unpackable records of length <= W give no hits (reference
    engine.py:458-459); W + 1 scans one position."""
    W = 11
    seqs = [(f"s{n}", ("U" + "ACG-ACGTACé")[:n]) for n in (1, 5, W, W + 1)]
    port, ref, eng = _search_both(tmp_path, f"S1\t{P1}\t{P2}\t200\n", seqs)
    assert port == ref == ""
    assert [c.packed for c, _, _ in eng.last_scans] == [False]  # only W + 1 scans


def test_mixed_packable_and_raw_records_match_jax(tmp_path):
    """Scaffolds in the alphabet with unpackable records between them: each
    unpackable record ends a stream run (the plan), and takes the raw path
    alone."""
    sts, seq = make_corpus(n=24_000, seed=5)
    clean = np.where(np.isin(seq, JUNK) | (seq == ord("U")), ord("C"), seq).astype(np.uint8)
    seqs = []
    for r in range(8):
        part = (clean if r % 3 else seq)[r * 3000 : (r + 1) * 3000].copy()
        if r % 3 == 0:
            part[1500] = ord("-")
        seqs.append((f"scaf{r}", part.tobytes().decode("latin-1")))
    port, ref, eng = _search_both(tmp_path, sts, seqs, iupac_mode=1)
    assert port == ref and port.count("\n") > 0
    kinds = [(c.packed, c.stream, n_rec) for c, _, n_rec in eng.last_scans]
    assert kinds == [(False, False, 1), (True, True, 2), (False, False, 1),
                     (True, True, 2), (False, False, 1), (True, False, 1)]


def test_mismatch_sweep_over_raw_and_packed_records(tmp_path):
    """One engine per package swept -N 0, 1, 0 over a raw and a packed
    record: the raw record scans loose at every -N and builds no strict1
    tables; the packed record's -N 1 search builds them, as in JAX."""
    sts, seq = make_corpus(n=14_000, seed=8)
    clean = np.where(np.isin(seq, JUNK) | (seq == ord("U")), ord("G"), seq).astype(np.uint8)
    path = tmp_path / "s.sts"
    path.write_text(sts)
    engines = (MerPCR(device="cpu"), JaxMerPCR())
    for eng in engines:
        assert eng.load_sts_file(str(path))
    built = False
    for n_mm in (0, 1, 0):
        for label, s in (("raw", seq), ("packed", clean)):
            outs = []
            for eng, kind in zip(engines, ("torch", "jax")):
                eng.mismatches = n_mm
                text = s.tobytes().decode("latin-1")
                outs.append(run_search(eng, _records(kind, [(label, text)])))
            assert outs[0] == outs[1] and outs[0], (n_mm, label)
            built |= n_mm == 1 and label == "packed"
            assert [e._strict1_tried for e in engines] == [built, built], (n_mm, label)
            (cfg, _, _), = engines[0].last_scans
            assert cfg.packed == cfg.strict == (label == "packed")  # strict1 arms here
    assert engines[0]._meta.strict1 and engines[1]._meta.strict1
