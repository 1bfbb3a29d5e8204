"""The port's stream path (K14), dirty-span phase filter (K10) and IUPAC
verify (K11) against the JAX package.

* the stream layout, the block -> record map and the dispatch plan equal
  ``merpcr_tpu.MerPCR``'s on a FASTA that mixes empty, short and ordinary
  records;
* per stream tile, the five stage totals and every hit row (``rec``
  included) equal ``get_stream_scan_fn``'s on clean, dirty (K10 armed) and
  ``-I 1`` (K11) scaffold corpora, both packages scanning the identical
  table and tile bytes;
* whole searches are byte-identical on scaffold assemblies at -X 0/1/3,
  and at -I 1.

The JAX side runs its device path (``MERPCR_TPU_HOST_MAX=0``), each
corpus with fresh engines. Everything compared is an integer: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import merpcr_tpu.ops.scan as jscan  # noqa: E402
from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu.ops.scan import ScanConfig as JaxScanConfig  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.ops.expand import phase_nibbles  # noqa: E402
from merpcr_tpu_torch.ops.front_end import front_end  # noqa: E402
from merpcr_tpu_torch.ops.table import table_from_numpy  # noqa: E402

from .conftest import GOLDEN_STS, run_search  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMB = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGTRYN", b"TGCAYRN")
RESOLVE = {ord("R"): b"AG", ord("Y"): b"CT", ord("N"): b"ACGT"}


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _resolved(rng, primer: bytes) -> bytes:
    """A genome site that the (possibly ambiguous) primer matches."""
    return bytes(rng.choice(list(RESOLVE[b])) if b in RESOLVE else b for b in primer)


def write_corpus(tmp_path, seed: int, lengths, n_sts: int = 40,
                 dirty: float = 0.0, ambiguous_sts: bool = False):
    """STS + FASTA files: records of random ACGT with the given lengths,
    ``dirty`` of their bases replaced by scattered ambiguity letters, and
    every second STS planted as an amplicon inside one record (both
    orientations, some off the stated size, some ending at the record's
    last base). ``ambiguous_sts`` puts R/Y/N letters into every third STS's
    primers (the plants resolve them)."""
    rng = np.random.default_rng(seed)
    recs = [rng.choice(ACGT, size=n) for n in lengths]
    for seq in recs:
        k = rng.random(len(seq)) < dirty
        seq[k] = rng.choice(AMB, size=int(k.sum()))
    lines = []
    for i in range(n_sts):
        p1, p2 = (bytearray(rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes())
                  for _ in range(2))
        if ambiguous_sts and i % 3 == 0:
            for p in (p1, p2):
                for j in rng.integers(0, len(p), size=2):
                    p[j] = int(rng.choice(list(b"RYN")))
        p1, p2 = bytes(p1), bytes(p2)
        size = int(rng.integers(100, 400))
        lines.append(f"E{i}\t{p1.decode()}\t{p2.decode()}\t{size}\t(alias {i})\n")
        if i % 2:
            continue
        s = size + (int(rng.integers(-45, 46)) if i % 4 else 0)
        fits = [r for r, seq in enumerate(recs) if len(seq) >= s + 1]
        if not fits:
            continue
        seq = recs[fits[int(rng.integers(0, len(fits)))]]
        left, right = (p1, p2) if i % 3 else (p2, p1.translate(COMP)[::-1])
        pos = len(seq) - s if i % 10 == 0 else int(rng.integers(0, len(seq) - s + 1))
        seq[pos : pos + len(left)] = np.frombuffer(_resolved(rng, left), dtype=np.uint8)
        seq[pos + s - len(right) : pos + s] = np.frombuffer(_resolved(rng, right), dtype=np.uint8)
    sts = tmp_path / "s.sts"
    sts.write_text("".join(lines))
    fa = tmp_path / "s.fa"
    with open(fa, "w") as fh:
        for r, seq in enumerate(recs):
            body = seq.tobytes().decode()
            fh.write(f">scaf{r} scaffold {r}\n")
            fh.write("".join(body[i : i + 60] + "\n" for i in range(0, len(body), 60)))
    return str(sts), str(fa)


def scaffold_lengths(seed: int, n: int):
    """Scaffold-like record lengths, 20 to 5,000 bases."""
    return np.random.default_rng(seed).integers(20, 5_001, size=n).tolist()


def _both(sts, fa, tile_len=None, setup=None, **params):
    """(port output, JAX output, port engine) of one search, fresh engines;
    ``setup(engine)`` runs after the STS load."""
    outs = []
    for eng in (MerPCR(device="cpu", **params), JaxMerPCR(**params)):
        eng._tile_len_override = tile_len
        assert eng.load_sts_file(sts)
        if setup:
            setup(eng)
        outs.append(run_search(eng, eng.load_fasta_file(fa)))
        if isinstance(eng, MerPCR):
            port = eng
    return outs[0], outs[1], port


def _padded_rmeta(rmeta):
    """rmeta padded to a power-of-two row count, as the JAX engine ships it."""
    rb = 1 << (len(rmeta) - 1).bit_length()
    out = np.full((rb, 2), np.iinfo(np.int32).max, dtype=np.int32)
    out[:, 1] = 0
    out[: len(rmeta)] = rmeta
    return out


# ------------------------------------------------- (i) layout, map and plan
class _JaxCapture:
    """The JAX engine's stream dispatches, one list per stream of its
    group calls: (cfg, tiles per call, group plane, rmeta, recmap)."""

    def __init__(self, monkeypatch):
        self.streams = []
        real = jscan.get_stream_scan_fn

        def spy(cfg, n_tiles):
            fn = real(cfg, n_tiles)

            def run(table, padded, start0, total_scan, stream_len, rmeta, recmap, rt):
                if int(start0) == 0:
                    self.streams.append([])
                self.streams[-1].append((cfg, n_tiles, np.asarray(padded),
                                         np.asarray(rmeta), np.asarray(recmap)))
                return fn(table, padded, start0, total_scan, stream_len, rmeta, recmap, rt)

            return run

        monkeypatch.setattr(jscan, "get_stream_scan_fn", spy)


def test_layout_recmap_and_plan_equal_jax(tmp_path, monkeypatch):
    lengths = [3_000, 0, 5, 11, 12, 0, 700, 4_100, 9, 0, 2_500, 1_800, 0, 6_000, 1, 13]
    sts, fa = write_corpus(tmp_path, 21, lengths, n_sts=30)
    jcap = _JaxCapture(monkeypatch)
    ports = []
    real = MerPCR._stream_geometry

    def spy(eng, items):  # the stream planes as the port lays them out
        laid = real(eng, items)
        cfg, total_scan, stream_len, rmeta, recmap, _ = laid
        plane = MerPCR._stream_bytes(cfg, items, rmeta, total_scan)
        ports.append((cfg, plane, total_scan, stream_len, rmeta, recmap))
        return laid

    monkeypatch.setattr(MerPCR, "_stream_geometry", spy)
    port, ref, eng = _both(sts, fa, tile_len=1 << 12)
    assert port == ref and port.count("\n") >= 5
    recs = eng.load_fasta_file(fa)
    jeng = JaxMerPCR()
    assert jeng.load_sts_file(sts)
    run_search(jeng, recs)
    plan = [item[:2] for item in eng._plan(recs)]
    assert plan == [item[:2] for item in jeng._plan_cache[1]]
    assert plan == [("single", 0), ("single", 1), ("stream", [2, 3, 4]), ("single", 5),
                    ("stream", [6, 7, 8]), ("single", 9), ("stream", [10, 11]),
                    ("single", 12), ("stream", [13, 14, 15])]
    streams = [a for a in ports if a[0].stream]
    assert len(streams) == 4 == len(jcap.streams) // 2  # the JAX side ran twice
    for (cfg, plane, total_scan, stream_len, rmeta, recmap), calls in zip(streams, jcap.streams):
        jcfg, G, _, jrmeta, jrecmap = calls[0]
        np.testing.assert_array_equal(rmeta, jrmeta[: len(rmeta)])
        assert (jrmeta[len(rmeta):, 1] == 0).all()
        np.testing.assert_array_equal(recmap, jrecmap)
        assert (cfg.lead, cfg.tail, cfg.tile_len) == (jcfg.lead, jcfg.tail, jcfg.tile_len)
        assert stream_len == int(rmeta[-1].sum())
        L = cfg.tile_len
        for t in range(-(-total_scan // L)):  # each tile's bytes, 0xFF gaps included
            o = (t % G) * L // 2
            np.testing.assert_array_equal(
                plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in],
                calls[t // G][2][o : o + cfg.tile_buf_in], err_msg=f"tile {t}")


def test_runs_of_short_records_give_no_hits():
    """A stream run whose records are all shorter than a word scans no
    position (the reference gives records <= W no hits)."""
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    recs = [FASTARecord(defline=">a", sequence="A"), FASTARecord(defline=">b", sequence="CG")]
    assert run_search(eng, recs) == ""
    assert [item[:2] for item in eng._plan(recs)] == [("stream", [0, 1])]


def test_stream_cuts_at_record_and_position_limits(tmp_path, monkeypatch):
    sts, fa = write_corpus(tmp_path, 22, scaffold_lengths(22, 40), n_sts=30)
    monkeypatch.setattr(MerPCR, "STREAM_MAX_RECORDS", 7)
    monkeypatch.setattr(JaxMerPCR, "STREAM_MAX_RECORDS", 7)
    port, ref, eng = _both(sts, fa)
    assert port == ref
    assert [n for c, _, n in eng.last_scans] == [7] * 5 + [5]
    monkeypatch.setattr(MerPCR, "STREAM_MAX_POSITIONS", 20_000)
    monkeypatch.setattr(JaxMerPCR, "STREAM_MAX_POSITIONS", 20_000)
    port, ref, eng = _both(sts, fa)
    assert port == ref
    # 40 records of ~2.5 kbp need at least 5 planes of <= 20,000 positions
    assert len(eng.last_scans) >= 5


# --------------------------------------------- (ii) per stream tile vs JAX
_KINDS = {
    # kind: (corpus kwargs, engine params)
    "clean": ({}, {}),
    "dirty": ({"dirty": 0.01}, {}),
    "iupac": ({"dirty": 0.004, "ambiguous_sts": True}, {"iupac_mode": 1}),
}
_STREAMS: dict = {}


def _stream_case(tmp_path_factory, kind: str, tile_len: int):
    """Both packages' configs, the shared table and the port's stream
    plane for one corpus at one tile length."""
    key = (kind, tile_len)
    if key in _STREAMS:
        return _STREAMS[key]
    corpus, params = _KINDS[kind]
    tmp = tmp_path_factory.mktemp(f"stream_{kind}{tile_len}")
    sts, fa = write_corpus(tmp, 31, scaffold_lengths(31, 40), **corpus)
    jeng = JaxMerPCR(**params)
    assert jeng.load_sts_file(sts)
    eng = MerPCR(device="cpu", **params)
    eng._tile_len_override = tile_len
    assert eng.load_sts_file(sts)
    (kind0, _, items), = eng._plan(eng.load_fasta_file(fa))
    assert kind0 == "stream" and len(items) == 40
    cfg, plane, total_scan, stream_len, rmeta, recmap = eng._stream_plane(items)
    w = [jeng._dirty_of(s, p) for s, p in items]
    n = np.asarray([len(s) for s, _ in items], dtype=float)
    dirty = tuple(float((np.asarray(col) * n).sum() / n.sum()) for col in zip(*w))
    j0 = jeng._base_config(tile_len, packed=True, stream=True,
                           dirty=jeng._quantize_dirty(dirty[0]),
                           dirty_pos=jeng._quantize_dirty(dirty[1]))
    assert j0.strict and j0.exact_group and j0.stream
    assert (cfg.lead, cfg.tail, cfg.tile_len) == (j0.lead, j0.tail, j0.tile_len)
    assert (cfg.dirty_bloom, cfg.iupac) == (j0.dirty_bloom, j0.iupac)
    units = tile_len // 8
    jcfg = JaxScanConfig(**{**j0.__dict__, "cpos_cap": units, "pos_cap": tile_len,
                            "cand_cap": 1 << 14, "anch_cap": 2048, "hit_cap": 8192})
    case = (cfg, jcfg, jeng._table, table_from_numpy(jeng._table_host, jeng._meta, "cpu"),
            plane, total_scan, stream_len, rmeta, recmap)
    _STREAMS[key] = case
    return case


@pytest.mark.parametrize("margin", [0, 50, 64])
@pytest.mark.parametrize("tile_len", [1 << 12, 1 << 13])
@pytest.mark.parametrize("kind", ["clean", "dirty", "iupac"])
def test_stream_tiles_match_jax(tmp_path_factory, kind, tile_len, margin):
    cfg, jcfg, jtable, ttable, plane, total_scan, stream_len, rmeta, recmap = \
        _stream_case(tmp_path_factory, kind, tile_len)
    assert jcfg.dirty_bloom == (kind != "clean")
    assert jcfg.iupac == (kind == "iupac")
    L = tile_len
    n_tiles = -(-total_scan // L)
    assert n_tiles >= 7
    fn = jscan.get_stream_scan_fn(jcfg, 1)
    rmeta_p = _padded_rmeta(rmeta)
    t_rmeta, t_recmap = torch.from_numpy(rmeta), torch.from_numpy(recmap)
    rt = np.asarray([margin, 0, 1], dtype=np.int32)
    hits, recs_hit, pos_sum = 0, set(), 0
    for t in range(n_tiles):
        tile = plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in]
        j = jax.device_get(fn(jtable, tile, np.int32(t * L), np.int32(total_scan),
                              np.int32(stream_len), rmeta_p, recmap, rt))
        jt = tuple(int(np.asarray(v).reshape(-1)[0]) for v in
                   (j.c_total, j.pos_total, j.pair_total, j.anch_total, j.hit_total))
        assert jt[0] <= jcfg.cpos_cap and jt[1] <= jcfg.pos_cap
        assert jt[2] <= jcfg.cand_cap and jt[3] <= jcfg.anch_cap and jt[4] <= jcfg.hit_cap
        o = tscan.scan_tile(cfg, ttable, torch.from_numpy(tile), t * L,
                            min(L, total_scan - t * L), t_rmeta, t_recmap, tuple(rt))
        assert o[:5] == jt, (kind, tile_len, margin, t)
        h = o.hit_total
        for name in ("pos1", "pos2", "entry", "pair_order", "rank", "rec"):
            np.testing.assert_array_equal(
                getattr(o, name).numpy(), np.asarray(getattr(j, name)).reshape(-1)[:h],
                err_msg=f"{name} tile {t}",
            )
        hits += h
        recs_hit |= set(o.rec.tolist())
        pos_sum += o.pos_total
    if margin:
        assert hits > 0 and len(recs_hit) >= 3, (hits, recs_hit)
    assert pos_sum > 0


@pytest.mark.parametrize("kind", ["dirty", "iupac"])
def test_phase_nibbles_match_jax_stop_nb(tmp_path_factory, kind):
    """The K10-gated phase nibbles of every stream tile against the JAX
    program stopped at its ``nb`` stage (a sum of the nibbles)."""
    cfg, jcfg, jtable, ttable, plane, total_scan, stream_len, rmeta, recmap = \
        _stream_case(tmp_path_factory, kind, 1 << 13)
    assert jcfg.dirty_bloom
    rmeta_p = _padded_rmeta(rmeta)
    rt = np.asarray([50, 0, 1], dtype=np.int32)
    stop = jax.jit(lambda tb, t0, ns: jscan._scan_tile_impl(
        jcfg, jtable, tb, t0, ns, np.int32(stream_len), rt, stop="nb",
        rmeta=rmeta_p, recmap=recmap).c_total)
    L, W = cfg.tile_len, cfg.wordsize
    for t in range(-(-total_scan // L)):
        tile = plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in]
        n_scan = min(L, total_scan - t * L)
        tt = torch.from_numpy(tile)
        words, _ = front_end(tt, ttable.qbloom_s, ttable.gq, W, cfg.lead, L, n_scan)
        _, _, nb = phase_nibbles(tt, words, ttable.ptab, ttable.pf_bits, W, cfg.lead,
                                 n_scan, 4, True, ttable.bloom, ttable.bloom_bits)
        want = int(stop(tile, np.int32(t * L), np.int32(n_scan)))
        assert int(nb.sum()) == want, t


def test_bloom_prunes_dirty_span_phases(tmp_path_factory):
    """K10 changes totals, not lines: on the dirty corpus the filter cuts
    pos_total below the unfiltered scan's and leaves the hit rows alone."""
    cfg, _, _, ttable, plane, total_scan, _, rmeta, recmap = \
        _stream_case(tmp_path_factory, "dirty", 1 << 13)
    assert cfg.dirty_bloom
    off = tscan.ScanConfig(**{**cfg.__dict__, "dirty_bloom": False})
    L, rt = cfg.tile_len, (50, 0, 1)
    t_rmeta, t_recmap = torch.from_numpy(rmeta), torch.from_numpy(recmap)
    pruned = 0
    for t in range(-(-total_scan // L)):
        tile = torch.from_numpy(plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in])
        args = (ttable, tile, t * L, min(L, total_scan - t * L), t_rmeta, t_recmap, rt)
        a, b = tscan.scan_tile(cfg, *args), tscan.scan_tile(off, *args)
        assert a.c_total == b.c_total and a.pos_total <= b.pos_total
        assert a.anch_total == b.anch_total and a.hit_total == b.hit_total
        for x, y in zip(a[5:], b[5:]):
            assert torch.equal(x, y)
        pruned += b.pos_total - a.pos_total
    assert pruned > 0


# ----------------------------------------------- (iii) whole searches vs JAX
@pytest.mark.parametrize("three_prime", [0, 1, 3])
def test_scaffold_assembly_equals_jax(tmp_path, three_prime):
    sts, fa = write_corpus(tmp_path, 41, scaffold_lengths(41, 300), n_sts=60)
    port, ref, eng = _both(sts, fa, three_prime_match=three_prime)
    assert port == ref
    assert len({line.split("\t")[0] for line in port.splitlines()}) >= 10
    # one plane of 2^21-position tiles, not one scan per record
    assert [(c.stream, n_rec) for c, _, n_rec in eng.last_scans] == [(True, 300)]


@pytest.mark.parametrize("tile_len", [1 << 12, None])
def test_dirty_assembly_equals_jax(tmp_path, tile_len):
    sts, fa = write_corpus(tmp_path, 42, scaffold_lengths(42, 120), dirty=0.01)
    port, ref, eng = _both(sts, fa, tile_len=tile_len)
    assert port == ref and port
    assert all(c.dirty_bloom and c.stream for c, _, _ in eng.last_scans)


@pytest.mark.parametrize("three_prime", [0, 1])
def test_iupac_assembly_equals_jax(tmp_path, three_prime):
    sts, fa = write_corpus(tmp_path, 43, scaffold_lengths(43, 120) + [9_000],
                           dirty=0.004, ambiguous_sts=True)
    port, ref, eng = _both(sts, fa, iupac_mode=1, three_prime_match=three_prime)
    assert port == ref and port
    assert [c.iupac for c, _, _ in eng.last_scans] == [True]
    # the same assembly at -I 0 gives other lines (IUPAC matches differ)
    plain, _, _ = _both(sts, fa, three_prime_match=three_prime)
    assert plain != port


def test_iupac_single_record_equals_jax(tmp_path):
    sts, fa = write_corpus(tmp_path, 44, [30_000], dirty=0.004, ambiguous_sts=True)
    port, ref, eng = _both(sts, fa, iupac_mode=1, tile_len=1 << 13)
    assert port == ref and port
    assert [(c.iupac, c.stream, n_tiles) for c, n_tiles, _ in eng.last_scans] == [(True, False, 4)]
