"""The port at word sizes above 11 (K12) against the JAX package.

The word size picks the lookup tables (``merpcr_tpu/ops/table.py:567-574``):
W = 12 and 13 scan with stride-2 exact group and phase tables and look
buckets up through ``bstart`` (12) or a binary search over ``uhash`` (13);
W = 14 to 16 scan with a mult-hash group bloom, no phase table and the
binary search. Strict mode arms at every W.

* per tile, at tile lengths 2^12 and 2^13, for W in 12, 13, 14, 16 and
  -N 0 (strict), -N 1 (strict1 where it arms, else loose) and -N 2
  (loose): all five totals and every hit row against ``get_scan_fn``; the
  flag words and phase nibbles against ``_scan_tile_impl``'s
  ``stop="words"`` and ``stop="nb"`` checksums; a dirty corpus with the
  dirty-span filter (K10) armed at W = 13, 14, 16; a stream tile against
  ``get_stream_scan_fn`` at W = 12 and 14;

Whole searches at these word sizes are in ``test_torch_wordsize_search.py``.
The JAX side runs its device path (``MERPCR_TPU_HOST_MAX=0``); the port
runs the plain versions of its kernels (CPU tensors). Everything compared
is an integer: tolerance 0.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import merpcr_tpu.ops.scan as jscan  # noqa: E402
from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu.ops.encoding import NIB_LUT, pack_nibbles  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.ops.expand import group_nibbles, phase_nibbles  # noqa: E402
from merpcr_tpu_torch.ops.front_end import front_end, front_end_loose  # noqa: E402
from merpcr_tpu_torch.ops.table import table_from_numpy  # noqa: E402

from .test_torch_mismatch import _assert_tile_equal  # noqa: E402
from .test_torch_scan import make_corpus  # noqa: E402
from .test_torch_stream import (  # noqa: E402
    _padded_rmeta,
    scaffold_lengths,
    write_corpus,
)

AMB = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)
WORDSIZES = [12, 13, 14, 16]
CAPS = {"cand_cap": 1 << 14, "anch_cap": 1024, "hit_cap": 4096}


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _tier(cfg):
    return cfg.stride, cfg.exact_group


# ------------------------------------------------------------ per tile
_ENGINES: dict = {}


def _engine(tmp_path_factory, W: int):
    """One JAX engine per word size for the shared STS set of
    ``make_corpus`` (its strict1 tables built by a -N 1 config), and the
    port's copy of that table."""
    if W not in _ENGINES:
        sts, _ = make_corpus("random", 1 << 12)
        path = tmp_path_factory.mktemp(f"w{W}") / "c.sts"
        path.write_text(sts)
        eng = JaxMerPCR(wordsize=W, mismatches=1)
        assert eng.load_sts_file(str(path))
        eng._base_config(1 << 12, packed=True)  # builds strict1 when it can
        assert eng._meta.strict
        _ENGINES[W] = (eng, table_from_numpy(eng._table_host, eng._meta, "cpu"))
    return _ENGINES[W]


def _corpus_seq(kind: str, tile_len: int, W: int) -> np.ndarray:
    if kind == "dirty":  # 1 % scattered ambiguity letters: arms K10
        _, seq = make_corpus("planted", tile_len)
        rng = np.random.default_rng(W)
        at = rng.integers(0, len(seq), size=len(seq) // 100)
        seq[at] = AMB[rng.integers(0, len(AMB), size=len(at))]
        return seq
    _, seq = make_corpus("planted" if kind == "adjacent" else kind, tile_len)
    if kind == "adjacent":
        # N at 8r and 8r + W + 2 flags groups 0 and 1 of unit r on the
        # stride-2 loose path: each span holds one N at an end, so one of
        # its two phases is clean
        for r in range(40, (len(seq) - 40) // 8, 61):
            seq[[8 * r, 8 * r + W + 2]] = ord("N")
    return seq


class _Tiles:
    """One corpus at one tile length and word size: the plane, and both
    packages' configs at one -N."""

    def __init__(self, tmp_path_factory, kind: str, tile_len: int, W: int, n_mm: int):
        self.seq = _corpus_seq(kind, tile_len, W)
        self.W = W
        eng, self.ttable = _engine(tmp_path_factory, W)
        eng.mismatches = n_mm
        dirty = (0.0, 0.0)
        if kind == "dirty":
            dirty = tuple(eng._quantize_dirty(d) for d in eng._dirty_of(self.seq, None))
        cfg = eng._base_config(tile_len, packed=True, dirty=dirty[0], dirty_pos=dirty[1])
        eng.mismatches = 1
        m = eng._meta
        assert _tier(cfg) == (2, W <= 13) and cfg.strict == (n_mm == 0 or (n_mm == 1 and m.strict1))
        self.jcfg = jscan.ScanConfig(**{
            **cfg.__dict__, "cpos_cap": tile_len // cfg.front_stride,
            "pos_cap": tile_len, **CAPS})
        self.jtable = eng._table
        self.tcfg = tscan.default_config(
            wordsize=W, margin=50, lead=m.lead, max_pcr_size=eng.max_pcr_size,
            p1_max=m.p1_max, p2_max=m.p2_max, tile_len=tile_len, stride=m.stride,
            exact_group=m.exact_group, qbloom_bits=m.qbloom_bits,
            strict=cfg.strict, strict_n=cfg.strict_n, t16_bits=cfg.t16_bits,
            bloom_bits=m.bloom_bits, dirty_pos_rate=dirty[1],
        )
        assert (self.tcfg.lead, self.tcfg.tail) == (cfg.lead, cfg.tail)
        assert self.tcfg.dirty_bloom == cfg.dirty_bloom == (kind == "dirty" and cfg.strict)
        assert self.tcfg.qbloom_bits == (0 if W <= 13 else cfg.qbloom_bits)
        self.n = len(self.seq)
        self.total_scan = self.n - W + 1
        self.n_tiles = -(-self.total_scan // tile_len)
        pos = np.zeros(cfg.lead + self.n_tiles * tile_len + cfg.tail, dtype=np.uint8)
        pos[cfg.lead : cfg.lead + self.n] = NIB_LUT[self.seq]
        self.plane = pack_nibbles(pos)

    def tiles(self):
        L = self.jcfg.tile_len
        for t in range(self.n_tiles):
            tile = self.plane[t * L // 2 : t * L // 2 + self.jcfg.tile_buf_in]
            yield t, tile, int(np.clip(self.total_scan - t * L, 0, L))


_TILES: dict = {}


def _tiles(tmp_path_factory, kind, tile_len, W, n_mm) -> _Tiles:
    key = (kind, tile_len, W, n_mm)
    if key not in _TILES:
        _TILES[key] = _Tiles(tmp_path_factory, kind, tile_len, W, n_mm)
    return _TILES[key]


def _scan_and_compare(c: _Tiles, runtimes) -> tuple:
    """Every tile of ``c`` through both packages at each runtime (-M, -N,
    -X): all totals and rows equal. Returns (pos, pairs, hits) sums."""
    fn = jscan.get_scan_fn(c.jcfg)
    L = c.jcfg.tile_len
    pos = pairs = hits = 0
    for rt in runtimes:
        rt = np.asarray(rt, dtype=np.int32)
        for t, tile, n_scan in c.tiles():
            j = jax.device_get(fn(c.jtable, tile, np.int32(t * L), np.int32(n_scan),
                                  np.int32(c.n), rt))
            assert int(j.c_total) <= c.jcfg.cpos_cap and int(j.pair_total) <= c.jcfg.cand_cap
            o = tscan.scan_tile(c.tcfg, c.ttable, torch.from_numpy(tile), t * L, n_scan,
                                tscan.record_rmeta(c.n, "cpu"), None, tuple(rt))
            _assert_tile_equal(o, j, (c.W, tuple(rt), t))
            pos += o.pos_total
            pairs += o.pair_total
            hits += o.hit_total
    return pos, pairs, hits


@pytest.mark.parametrize("n_mm,kind,tile_len", [
    (n_mm, kind, tile_len) for n_mm in (0, 2) for kind, tile_len in (
        ("random", 1 << 12), ("planted", 1 << 12), ("boundary", 1 << 12),
        ("adjacent", 1 << 13))] + [(1, "planted", 1 << 12)])
@pytest.mark.parametrize("W", WORDSIZES)
def test_tile_totals_and_rows_match_jax(tmp_path_factory, W, n_mm, kind, tile_len):
    c = _tiles(tmp_path_factory, kind, tile_len, W, n_mm)
    pos, pairs, hits = _scan_and_compare(c, [(0, n_mm, 1), (50, n_mm, 1)])
    assert pos > 0 and pairs > 0
    if kind != "random":
        assert hits > 0, "planted corpus produced no hits"


@pytest.mark.parametrize("W", [13, 14, 16])
def test_dirty_tiles_with_k10_match_jax(tmp_path_factory, W):
    """1 % scattered ambiguity letters arm the dirty-span filter in strict
    mode: at W = 13 it prunes the dirty spans' phases of the stride-2 phase
    table, at W >= 14 every valid phase (``nbv & wbf``), both as a prefix
    filter (2W > 24 bloom bits). ``pos_total`` must equal JAX's, and fall
    below the unfiltered scan's."""
    c = _tiles(tmp_path_factory, "dirty", 1 << 12, W, 0)
    assert c.jcfg.dirty_bloom and 2 * W > c.tcfg.bloom_bits == 24
    pos, _pairs, hits = _scan_and_compare(c, [(50, 0, 1)])
    assert hits > 0
    off = tscan.ScanConfig(**{**c.tcfg.__dict__, "dirty_bloom": False})
    unfiltered = sum(
        tscan.scan_tile(off, c.ttable, torch.from_numpy(tile), t * (1 << 12), n_scan,
                        tscan.record_rmeta(c.n, "cpu"), None, (50, 0, 1)).pos_total
        for t, tile, n_scan in c.tiles())
    assert pos < unfiltered


_STOPS: dict = {}


def _stop_fn(c: _Tiles, name: str):
    """The JAX tile program cut after stage ``name``, compiled once per
    config."""
    key = (c.jcfg, c.W, name)
    if key not in _STOPS:
        _STOPS[key] = jax.jit(lambda tb, n_scan: jscan._scan_tile_impl(
            c.jcfg, c.jtable, tb, np.int32(0), n_scan, np.int32(c.n), stop=name,
        ).c_total)
    return _STOPS[key]


@pytest.mark.parametrize("kind", ["adjacent", "dirty"])
@pytest.mark.parametrize("n_mm", [0, 2])
@pytest.mark.parametrize("W", WORDSIZES)
def test_words_and_nibbles_match_jax_stops(tmp_path_factory, W, n_mm, kind):
    """Flag words (K1, or K8 at stride 2 over the exact table or the
    mult-hash bloom) and phase nibbles against the JAX program stopped
    after its word packing and after its ``nb`` stage (int32-wrapping
    sums)."""
    c = _tiles(tmp_path_factory, kind, 1 << 13, W, n_mm)

    stop_words, stop_nb = _stop_fn(c, "words"), _stop_fn(c, "nb")
    tt, cfg, L = c.ttable, c.tcfg, c.jcfg.tile_len
    flagged = several = 0
    for _t, tile, n_scan in c.tiles():
        x = torch.from_numpy(tile)
        if cfg.strict:
            words, c_total = front_end(x, tt.qbloom_s, tt.gq, W, cfg.lead, L, n_scan)
            _, _, nb = phase_nibbles(
                x, words, tt.ptab, tt.pf_bits, W, cfg.lead, n_scan,
                cfg.stride, cfg.exact_group,
                tt.bloom if cfg.dirty_bloom else None, tt.bloom_bits)
        else:
            words, c_total = front_end_loose(x, tt.qbloom, tt.q_bits, W, cfg.lead, L,
                                             n_scan, cfg.stride, cfg.qbloom_bits)
            _, _, nb = group_nibbles(x, words, tt.ptab, tt.pf_bits, W, cfg.lead,
                                     n_scan, cfg.stride, cfg.exact_group)
            assert words.numel() == L // 64  # one bit per stride-2 group
            bits = [w & 0xFFFFFFFF for w in words.tolist()]
            several += sum(bin(w & (w >> 1) & 0x55555555).count("1") for w in bits)
        want = int(stop_words(tile, np.int32(n_scan)))
        assert int(words.to(torch.int64).sum()) & 0xFFFFFFFF == want & 0xFFFFFFFF
        n_flags = sum(bin(w & 0xFFFFFFFF).count("1") for w in words.tolist())
        assert n_flags == int(c_total)
        assert int(nb.sum()) == int(stop_nb(tile, np.int32(n_scan)))
        flagged += n_flags
    assert flagged > 0
    if not cfg.strict and kind == "adjacent" and W < 16:
        # units whose groups 0 and 1 both flag (at W = 16 the second N lies
        # past the 16 keyed bases and flags nothing)
        assert several > 0


_STREAM: dict = {}


def _stream_case(tmp_path_factory, W: int, n_mm: int):
    """A dirty 40-scaffold corpus at one word size and -N: both configs,
    the shared table and the port's stream plane (tile length 2^12)."""
    key = (W, n_mm)
    if key in _STREAM:
        return _STREAM[key]
    L = 1 << 12
    tmp = tmp_path_factory.mktemp(f"ws_stream{W}_{n_mm}")
    sts, fa = write_corpus(tmp, 71, scaffold_lengths(71, 40), dirty=0.01)
    params = {"wordsize": W, "mismatches": n_mm}
    jeng = JaxMerPCR(**params)
    assert jeng.load_sts_file(sts)
    eng = MerPCR(device="cpu", **params)
    eng._tile_len_override = L
    assert eng.load_sts_file(sts)
    (_, _, items), = eng._plan(eng.load_fasta_file(fa))
    cfg, plane, total_scan, stream_len, rmeta, recmap = eng._stream_plane(items)
    w = [jeng._dirty_of(s, p) for s, p in items]
    n = np.asarray([len(s) for s, _ in items], dtype=float)
    dirty = [float((np.asarray(col) * n).sum() / n.sum()) for col in zip(*w)]
    j0 = jeng._base_config(L, packed=True, stream=True,
                           dirty=jeng._quantize_dirty(dirty[0]),
                           dirty_pos=jeng._quantize_dirty(dirty[1]))
    assert (cfg.lead, cfg.tail, cfg.tile_len) == (j0.lead, j0.tail, j0.tile_len)
    assert (cfg.strict, cfg.dirty_bloom) == (j0.strict, j0.dirty_bloom) == (n_mm == 0,) * 2
    assert _tier(cfg) == _tier(j0) == (2, W <= 13)
    jcfg = jscan.ScanConfig(**{**j0.__dict__, "cpos_cap": L // j0.front_stride,
                               "pos_cap": L, **CAPS})
    case = (cfg, jcfg, jeng._table, table_from_numpy(jeng._table_host, jeng._meta, "cpu"),
            plane, total_scan, stream_len, rmeta, recmap)
    _STREAM[key] = case
    return case


@pytest.mark.parametrize("n_mm", [0, 2])
@pytest.mark.parametrize("W", [12, 14])
def test_stream_tiles_match_jax(tmp_path_factory, W, n_mm):
    """A 1 % IUPAC scaffold stream: strict with K10 at -N 0, loose at -N 2,
    record-local bounds (K14), per-tile totals and rows with ``rec``."""
    cfg, jcfg, jtable, ttable, plane, total_scan, stream_len, rmeta, recmap = \
        _stream_case(tmp_path_factory, W, n_mm)
    L = cfg.tile_len
    fn = jscan.get_stream_scan_fn(jcfg, 1)
    rmeta_p = _padded_rmeta(rmeta)
    t_rmeta, t_recmap = torch.from_numpy(rmeta), torch.from_numpy(recmap)
    rt = np.asarray([50, n_mm, 1], dtype=np.int32)
    hits, recs = 0, set()
    for t in range(-(-total_scan // L)):
        tile = plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in]
        j = jax.device_get(fn(jtable, tile, np.int32(t * L), np.int32(total_scan),
                              np.int32(stream_len), rmeta_p, recmap, rt))
        o = tscan.scan_tile(cfg, ttable, torch.from_numpy(tile), t * L,
                            min(L, total_scan - t * L), t_rmeta, t_recmap, tuple(rt))
        _assert_tile_equal(o, j, (W, n_mm, t))
        hits += o.hit_total
        recs |= set(o.rec.tolist())
    assert hits > 0 and len(recs) >= 3


def test_scan_tile_refuses_a_table_of_another_tier(tmp_path_factory):
    c = _tiles(tmp_path_factory, "planted", 1 << 12, 12, 0)
    _, other = _engine(tmp_path_factory, 14)
    _t, tile, n_scan = next(c.tiles())
    with pytest.raises(ValueError, match="word size"):
        tscan.scan_tile(c.tcfg, other, torch.from_numpy(tile), 0, n_scan,
                        tscan.record_rmeta(c.n, "cpu"), None, (50, 0, 1))
