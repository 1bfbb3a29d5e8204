"""The port's mismatch-tolerant search against the JAX package: the -N 1
strict1 tables and the loose stride-group front end (K8) with its group
expansion.

* per tile, at tile lengths 2^12 and 2^13: the loose scan at -N 2 and 3
  and the strict1 scan at -N 1 against ``get_scan_fn`` on the random,
  planted and boundary corpora of ``test_torch_scan.py`` (all five totals
  and every hit row), the flag words and phase nibbles against
  ``_scan_tile_impl``'s ``stop="words"`` and ``stop="nb"`` checksums, and
  a dirty stream corpus at -N 2 against ``get_stream_scan_fn`` (where
  neither package arms the dirty-span filter);
* whole searches, byte for byte: -N 1 with strict1 armed, bailed and
  forced off, -N 2 and 3, -N 2 at -I 1 on a dirty assembly, a stream of
  scaffolds at -N 2, a saturated STS set that scans loose at -N 0, the
  golden files at -N 1 and 2, planted k-mismatch amplicons that appear
  exactly at -N >= k, and one engine swept across -N 0, 1, 0.

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

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, run_search  # noqa: E402
from .test_torch_scan import make_corpus  # noqa: E402
from .test_torch_stream import (  # noqa: E402
    _both,
    _padded_rmeta,
    scaffold_lengths,
    write_corpus,
)
from .test_torch_table import _n_rich_sts  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
TRANSITION = bytes.maketrans(b"ACGT", b"GTAC")
W = 11


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _modes(eng):
    return [(c.strict, c.strict_n) for c, _, _ in eng.last_scans]


# ------------------------------------------------------------ per tile
_ENGINE: list = []


def _engine(tmp_path_factory):
    """One JAX engine for the shared STS set of ``make_corpus``, with its
    strict1 tables built (a -N 1 config), and the port's copy of that
    table."""
    if not _ENGINE:
        sts, _ = make_corpus("random", 1 << 12)
        path = tmp_path_factory.mktemp("mm") / "c.sts"
        path.write_text(sts)
        eng = JaxMerPCR(mismatches=1)
        assert eng.load_sts_file(str(path))
        assert eng._base_config(1 << 12, packed=True).strict_n == 1
        assert eng._meta.strict1
        _ENGINE.append((eng, table_from_numpy(eng._table_host, eng._meta, "cpu")))
    return _ENGINE[0]


class _Tiles:
    """One corpus at one tile length: the plane, and both packages'
    configs in one front-end mode ("loose" at -N 2, "strict1" at -N 1)."""

    def __init__(self, tmp_path_factory, kind: str, tile_len: int, mode: str):
        _, self.seq = make_corpus("planted" if kind == "adjacent" else kind, tile_len)
        if kind == "adjacent":
            # N at 8r+1 and 8r+16 flags both stride-4 groups of unit r on
            # the loose path (each span dirty, some phase clean)
            for r in range(40, (len(self.seq) - 24) // 8, 61):
                self.seq[[8 * r + 1, 8 * r + 16]] = ord("N")
        eng, self.ttable = _engine(tmp_path_factory)
        eng.mismatches = 2 if mode == "loose" else 1
        cfg = eng._base_config(tile_len, packed=True)
        eng.mismatches = 1
        assert cfg.exact_group and not cfg.dirty_bloom
        assert (cfg.strict, cfg.strict_n) == ((False, 0) if mode == "loose" else (True, 1))
        self.jcfg = jscan.ScanConfig(**{
            **cfg.__dict__, "cpos_cap": tile_len // cfg.front_stride,
            "pos_cap": tile_len, "cand_cap": 8192, "anch_cap": 1024, "hit_cap": 4096,
        })
        self.jtable = eng._table
        m = eng._meta
        self.tcfg = tscan.default_config(
            wordsize=W, margin=50, lead=m.lead, max_pcr_size=eng.max_pcr_size,
            p1_max=m.p1_max, p2_max=m.p2_max, tile_len=tile_len, stride=m.stride,
            strict=cfg.strict, strict_n=cfg.strict_n, t16_bits=cfg.t16_bits,
        )
        assert (self.tcfg.lead, self.tcfg.tail) == (cfg.lead, cfg.tail)
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


def _tiles(tmp_path_factory, kind, tile_len, mode) -> _Tiles:
    key = (kind, tile_len, mode)
    if key not in _TILES:
        _TILES[key] = _Tiles(tmp_path_factory, kind, tile_len, mode)
    return _TILES[key]


def _assert_tile_equal(o, j, what):
    jt = tuple(int(np.asarray(v).reshape(-1)[0]) for v in
               (j.c_total, j.pos_total, j.pair_total, j.anch_total, j.hit_total))
    assert o[:5] == jt, what
    h = o.hit_total
    for name in ("pos1", "pos2", "entry", "pair_order", "rank", "rec"):
        np.testing.assert_array_equal(
            getattr(o, name).numpy(), np.asarray(getattr(j, name)).reshape(-1)[:h],
            err_msg=f"{name} {what}")


@pytest.mark.parametrize("tile_len", [1 << 12, 1 << 13])
@pytest.mark.parametrize("kind", ["random", "planted", "boundary", "adjacent"])
@pytest.mark.parametrize("mode", ["loose", "strict1"])
def test_tile_totals_and_rows_match_jax(tmp_path_factory, mode, kind, tile_len):
    c = _tiles(tmp_path_factory, kind, tile_len, mode)
    fn = jscan.get_scan_fn(c.jcfg)
    hits = pairs = 0
    for nmm in ((2, 3) if mode == "loose" else (1,)):
        for margin in (0, 50):
            rt = np.asarray([margin, nmm, 1], dtype=np.int32)
            for t, tile, n_scan in c.tiles():
                j = jax.device_get(fn(c.jtable, tile, np.int32(t * tile_len),
                                      np.int32(n_scan), np.int32(c.n), rt))
                o = tscan.scan_tile(c.tcfg, c.ttable, torch.from_numpy(tile),
                                    t * tile_len, n_scan, tscan.record_rmeta(c.n, "cpu"),
                                    None, tuple(rt))
                _assert_tile_equal(o, j, (mode, kind, tile_len, nmm, margin, t))
                hits += o.hit_total
                pairs += o.pair_total
    assert pairs > 0
    if kind != "random":
        assert hits > 0, "planted corpus produced no hits"


@pytest.mark.parametrize("kind", ["random", "planted", "boundary"])
@pytest.mark.parametrize("mode", ["loose", "strict1"])
def test_words_and_nibbles_match_jax_stops(tmp_path_factory, mode, kind):
    """Flag words (K8, or K1 over qbloom_s1) and phase nibbles against the
    JAX program stopped after its word packing and after its ``nb``
    stage (int32-wrapping sums)."""
    c = _tiles(tmp_path_factory, kind, 1 << 13, mode)

    def stop(name):
        return jax.jit(lambda tb, n_scan: jscan._scan_tile_impl(
            c.jcfg, c.jtable, tb, np.int32(0), n_scan, np.int32(c.n), stop=name,
        ).c_total)

    stop_words, stop_nb = stop("words"), stop("nb")
    tt, L = c.ttable, c.jcfg.tile_len
    flagged = 0
    for _t, tile, n_scan in c.tiles():
        x = torch.from_numpy(tile)
        if mode == "loose":
            words, c_total = front_end_loose(x, tt.qbloom, tt.q_bits, W, c.tcfg.lead, L, n_scan,
                                             4, 0)
            _, _, nb = group_nibbles(x, words, tt.ptab, tt.pf_bits, W, c.tcfg.lead, n_scan,
                                     4, True)
            assert words.numel() == L // 128
        else:
            words, c_total = front_end(x, tt.qbloom_s1, tt.gq1, W, c.tcfg.lead, L, n_scan)
            _, _, nb = phase_nibbles(x, words, tt.ptab, tt.pf_bits, W, c.tcfg.lead, n_scan,
                                     4, True)
        want = int(stop_words(tile, np.int32(n_scan)))
        assert int(words.to(torch.int64).sum()) & 0xFFFFFFFF == want & 0xFFFFFFFF
        n_flags = sum(bin(w & 0xFFFFFFFF).count("1") for w in words.tolist())
        assert n_flags == int(c_total)
        assert int(nb.sum()) == int(stop_nb(tile, np.int32(n_scan)))
        flagged += n_flags
    assert flagged > 0


def test_loose_groups_interleave_parities(tmp_path_factory):
    """Group q = 2r + p: on the "adjacent" corpus (whose tiles
    ``test_tile_totals_and_rows_match_jax`` holds equal to JAX) units with
    both groups flagged set two neighbouring bits of one word."""
    c = _tiles(tmp_path_factory, "adjacent", 1 << 13, "loose")
    both = 0
    for _t, tile, n_scan in c.tiles():
        words, _ = front_end_loose(torch.from_numpy(tile), c.ttable.qbloom,
                                   c.ttable.q_bits, W, c.tcfg.lead, 1 << 13, n_scan, 4, 0)
        bits = [(w & 0xFFFFFFFF) for w in words.tolist()]
        both += sum(bin(w & (w >> 1) & 0x55555555).count("1") for w in bits)
    assert both > 0


_STREAM: dict = {}


def _stream_case(tmp_path_factory, iupac: bool):
    """A dirty 40-scaffold corpus at -N 2: both configs, the shared table
    and the port's stream plane (tile length 2^13)."""
    if iupac in _STREAM:
        return _STREAM[iupac]
    tmp = tmp_path_factory.mktemp(f"mm_stream{int(iupac)}")
    sts, fa = write_corpus(tmp, 51, scaffold_lengths(51, 40), dirty=0.01,
                           ambiguous_sts=iupac)
    params = {"mismatches": 2, "iupac_mode": int(iupac)}
    jeng = JaxMerPCR(**params)
    assert jeng.load_sts_file(sts)
    eng = MerPCR(device="cpu", **params)
    eng._tile_len_override = 1 << 13
    assert eng.load_sts_file(sts)
    (_, _, items), = eng._plan(eng.load_fasta_file(fa))
    cfg, plane, total_scan, stream_len, rmeta, recmap = eng._stream_plane(items)
    w = [jeng._dirty_of(s, p) for s, p in items]
    n = np.asarray([len(s) for s, _ in items], dtype=float)
    dirty = [float((np.asarray(col) * n).sum() / n.sum()) for col in zip(*w)]
    dirty_pos = jeng._quantize_dirty(dirty[1])
    assert dirty_pos >= 1 / 256  # strict mode would arm K10 here
    j0 = jeng._base_config(1 << 13, packed=True, stream=True,
                           dirty=jeng._quantize_dirty(dirty[0]), dirty_pos=dirty_pos)
    jcfg = jscan.ScanConfig(**{**j0.__dict__, "cpos_cap": (1 << 13) // 4, "pos_cap": 1 << 13,
                               "cand_cap": 1 << 14, "anch_cap": 2048, "hit_cap": 8192})
    case = (cfg, jcfg, jeng._table, table_from_numpy(jeng._table_host, jeng._meta, "cpu"),
            plane, total_scan, stream_len, rmeta, recmap)
    _STREAM[iupac] = case
    return case


@pytest.mark.parametrize("iupac", [False, True])
def test_dirty_stream_tiles_match_jax(tmp_path_factory, iupac):
    """A 1 % IUPAC scaffold stream at -N 2 scans loose with the dirty-span
    filter off on both sides (it is strict-only), with equal per-tile
    totals (pos_total included) and rows."""
    cfg, jcfg, jtable, ttable, plane, total_scan, stream_len, rmeta, recmap = \
        _stream_case(tmp_path_factory, iupac)
    assert (cfg.strict, cfg.dirty_bloom, cfg.iupac) == (False, False, iupac)
    assert (jcfg.strict, jcfg.dirty_bloom, jcfg.iupac) == (False, False, iupac)
    L = cfg.tile_len
    fn = jscan.get_stream_scan_fn(jcfg, 1)
    rmeta_p = _padded_rmeta(rmeta)
    t_rmeta, t_recmap = torch.from_numpy(rmeta), torch.from_numpy(recmap)
    hits = pos = 0
    for nmm in (2, 3):
        rt = np.asarray([50, nmm, 1], dtype=np.int32)
        for t in range(-(-total_scan // L)):
            tile = plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in]
            j = jax.device_get(fn(jtable, tile, np.int32(t * L), np.int32(total_scan),
                                  np.int32(stream_len), rmeta_p, recmap, rt))
            o = tscan.scan_tile(cfg, ttable, torch.from_numpy(tile), t * L,
                                min(L, total_scan - t * L), t_rmeta, t_recmap, tuple(rt))
            _assert_tile_equal(o, j, (iupac, nmm, t))
            hits += o.hit_total
            pos += o.pos_total
    assert hits > 0 and pos > 0


# ------------------------------------------------------- whole searches
def mismatch_corpus(tmp_path, seed: int = 61, n: int = 30_000, n_sts: int = 24):
    """STS + FASTA files: one random record with every STS planted once in
    (+) orientation, STS i carrying k = i % 4 mismatches in each primer
    (primer 1 past its W-mer and off its 3'-end base, primer 2 off its
    first base). Returns (sts, fasta, {k: expected lines})."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(ACGT, size=n)
    lines, expect = [], {k: [] for k in range(4)}
    step = (n - 600) // n_sts
    for i in range(n_sts):
        p1 = rng.choice(ACGT, size=int(rng.integers(20, 26))).tobytes()
        p2 = rng.choice(ACGT, size=int(rng.integers(20, 26))).tobytes()
        size = int(rng.integers(150, 300))
        lines.append(f"M{i}\t{p1.decode()}\t{p2.decode()}\t{size}\t(alias {i})\n")
        k = i % 4
        s1, s2 = bytearray(p1), bytearray(p2)
        for j in rng.choice(np.arange(W + 1, len(p1) - 2), size=k, replace=False):
            s1[j : j + 1] = bytes(s1[j : j + 1]).translate(TRANSITION)
        for j in rng.choice(np.arange(2, len(p2) - 2), size=k, replace=False):
            s2[j : j + 1] = bytes(s2[j : j + 1]).translate(TRANSITION)
        pos = 300 + i * step
        seq[pos : pos + len(s1)] = np.frombuffer(bytes(s1), dtype=np.uint8)
        seq[pos + size - len(s2) : pos + size] = np.frombuffer(bytes(s2), dtype=np.uint8)
        expect[k].append(f"mm\t{pos + 1}..{pos + size}\tM{i}\t(alias {i})\t(+)")
    sts = tmp_path / "m.sts"
    sts.write_text("".join(lines))
    fa = tmp_path / "m.fa"
    body = seq.tobytes().decode()
    fa.write_text(">mm planted mismatches\n" + "\n".join(
        body[i : i + 70] for i in range(0, n, 70)) + "\n")
    return str(sts), str(fa), expect


@pytest.mark.parametrize("n_mm", [0, 1, 2, 3])
def test_k_mismatch_lines_appear_at_n_at_least_k(tmp_path, n_mm):
    sts, fa, expect = mismatch_corpus(tmp_path)
    port, ref, eng = _both(sts, fa, tile_len=1 << 13, mismatches=n_mm)
    assert port == ref
    lines = set(port.splitlines())
    for k, want in expect.items():
        assert all((line in lines) == (k <= n_mm) for line in want), (k, n_mm)
    assert set(_modes(eng)) == {{0: (True, 0), 1: (True, 1)}.get(n_mm, (False, 0))}


def test_n1_strict1_bailed_and_forced_off(tmp_path):
    """-N 1 scans loose when the strict1 tables bail (an IUPAC set whose
    N-rich primer extensions pass the 2^22 insert guard) and when strict
    is forced off, with the JAX package's bytes either way."""
    sts, fa, expect = mismatch_corpus(tmp_path)

    def force_off(eng):
        eng._meta.strict = False
        eng._meta.strict1 = False

    port, ref, eng = _both(sts, fa, setup=force_off, mismatches=1)
    assert port == ref and set(_modes(eng)) == {(False, 0)}
    assert all(line in port for line in expect[1])
    nsts = _n_rich_sts(tmp_path / "n.sts")
    port, ref, eng = _both(nsts, fa, mismatches=1, iupac_mode=1)
    assert port == ref and set(_modes(eng)) == {(False, 0)}
    assert eng._meta.strict and eng._strict1_tried and not eng._meta.strict1


@pytest.mark.parametrize("n_mm", [2, 3])
def test_multi_record_at_n(tmp_path, n_mm):
    sts, fa = write_corpus(tmp_path, 63, [9_000, 0, 5, 3_000, 17_000, 700], n_sts=30)
    port, ref, eng = _both(sts, fa, tile_len=1 << 12, mismatches=n_mm)
    assert port == ref and port.count("\n") >= 5
    assert {c.stream for c, _, _ in eng.last_scans} == {True, False}
    assert not any(c.strict or c.dirty_bloom for c, _, _ in eng.last_scans)


def test_dirty_iupac_assembly_at_n2(tmp_path):
    sts, fa = write_corpus(tmp_path, 64, scaffold_lengths(64, 80), dirty=0.01,
                           ambiguous_sts=True)
    port, ref, eng = _both(sts, fa, mismatches=2, iupac_mode=1)
    assert port == ref and port
    assert [(c.stream, c.strict, c.dirty_bloom, c.iupac) for c, _, _ in eng.last_scans] \
        == [(True, False, False, True)]


def test_saturated_set_scans_loose_at_n0(tmp_path):
    """W = 3 with 4-base primers saturates the strict projection
    (``tests/test_table.py::test_pathological_sets_bail_to_loose``), so
    -N 0 scans loose."""
    rng = np.random.default_rng(65)
    rows = [f"S{i}\t{rng.choice(ACGT, 4).tobytes().decode()}\t"
            f"{rng.choice(ACGT, 4).tobytes().decode()}\t50\n" for i in range(30)]
    sts = tmp_path / "sat.sts"
    sts.write_text("".join(rows))
    fa = tmp_path / "sat.fa"
    fa.write_text(">sat\n" + rng.choice(ACGT, 2_500).tobytes().decode() + "\n")
    port, ref, eng = _both(str(sts), str(fa), wordsize=3, tile_len=1 << 12)
    assert port == ref and port.count("\n") > 10
    assert not eng._meta.strict and set(_modes(eng)) == {(False, 0)}


@pytest.mark.parametrize("n_mm,wordsize", [(1, 11), (2, 11), (1, 8), (3, 8)])
def test_golden_at_n(n_mm, wordsize):
    port, ref, eng = _both(GOLDEN_STS, GOLDEN_FA, mismatches=n_mm, wordsize=wordsize)
    assert port == ref and GOLDEN_LINE + "\n" in port
    assert _modes(eng) == [(n_mm == 1, int(n_mm == 1))]


def test_one_engine_sweeps_n(tmp_path):
    """-N 0, then 1 (building strict1 and uploading the table again), then
    0 in one engine: the two -N 0 searches print the same bytes, and each
    search prints the JAX engine's bytes for the same sweep."""
    sts, fa, expect = mismatch_corpus(tmp_path)
    engines = [MerPCR(device="cpu"), JaxMerPCR()]
    outs = []
    for eng in engines:
        assert eng.load_sts_file(sts)
        recs = eng.load_fasta_file(fa)
        row = []
        for n_mm in (0, 1, 0):
            eng.mismatches = n_mm
            row.append(run_search(eng, recs))
        outs.append(row)
    port, ref = outs
    assert port == ref
    assert port[0] == port[2] != port[1]
    assert all(line in port[1] and line not in port[0] for line in expect[1])
    assert engines[0]._meta.strict1 and _modes(engines[0]) == [(True, 0)]
