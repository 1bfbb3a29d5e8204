"""The port at margins above 128 (K13) against the JAX package.

``margin_p2`` takes every -M up to 10000: one (anchor, rank) item per rank
of the runtime margin, anchors passed through in chunks so that no launch
(and no tensor of the plain version) outgrows a fixed size. The JAX stage
walks the rank axis in chunks instead (``scan.py:1103-1127``,
``:1201-1235``); both must emit the same rows in the same order.

* per tile (tile length 2^12) at -M 129, 300, 2000 and 10000: all five
  totals and every hit row against ``get_scan_fn``, and the same rows
  when the plain version is held to a few anchors per pass (its module
  constant ``PLAIN_MAX_ITEMS`` set small);
* whole searches, byte for byte, at those margins: amplicons whose real
  size is off the stated size by +100, -129, +290, +-700, +5,000 and +9,900 found
  exactly from the margin that admits them, amplicons at the record's end
  (the ``hi`` clamp and the clamped product size), a record shorter than
  the margin window, and a stream of short scaffolds at -M 2000.

The JAX side runs its device path (``MERPCR_TPU_HOST_MAX=0``); the port
runs the plain versions of its kernels (CPU tensors). Everything compared
is an integer: tolerance 0.
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import merpcr_tpu.ops.scan as jscan  # noqa: E402
from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu.ops.encoding import NIB_LUT, pack_nibbles  # noqa: E402
from merpcr_tpu_torch.ops import margin_p2 as margin_mod  # noqa: E402
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.ops.expand import expand  # noqa: E402
from merpcr_tpu_torch.ops.front_end import front_end  # noqa: E402
from merpcr_tpu_torch.ops.margin_p2 import margin_p2_plain  # noqa: E402
from merpcr_tpu_torch.ops.table import table_from_numpy  # noqa: E402
from merpcr_tpu_torch.ops.verify_p1 import verify_p1  # noqa: E402

from .test_torch_mismatch import _assert_tile_equal  # noqa: E402
from .test_torch_stream import _both, scaffold_lengths, write_corpus  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
MARGINS = [129, 300, 2000, 10000]
DELTAS = [0, 100, -129, 290, 700, -700, 5000, 9900]
N = 40_000
W = 11


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def margin_corpus(seed: int = 91):
    """(sts text, record uint8[N], {delta: line}, end lines): one record
    with one STS planted per entry of DELTAS, its real size off the stated
    size (800 to 1,000) by delta, in alternating orientation; one amplicon
    100 over its stated size that ends 30 bases before the record's end
    (``hi`` = record end - expected end bites), and one whose stated size
    passes the record's end (the size clamp); and eight unplanted STS."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(ACGT, size=N)
    rows, by_delta, at_end = [], {}, []

    def plant(pos, i, delta, strand):
        sid, p1, p2, size = rows[i]
        real = size + delta
        left, right = (p1, p2) if strand == "+" else (p2, p1.translate(COMP)[::-1])
        seq[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
        seq[pos + real - len(right) : pos + real] = np.frombuffer(right, dtype=np.uint8)
        return f"big\t{pos + 1}..{pos + real}\t{sid}\t(alias {sid})\t({strand})"

    for i in range(len(DELTAS) + 10):
        p1 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        p2 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        rows.append((f"G{i}", p1, p2, int(rng.integers(800, 1001))))
    pos = 200
    for i, delta in enumerate(DELTAS):
        by_delta[delta] = plant(pos, i, delta, "+-"[i % 2])
        pos += rows[i][3] + max(delta, 0) + 300
    assert pos < N - 2500
    i = len(DELTAS)
    at_end.append(plant(N - 30 - (rows[i][3] + 100), i, 100, "+"))
    at_end.append(plant(N - (rows[i + 1][3] - 60), i + 1, -60, "+"))
    sts = "".join(f"{sid}\t{p1.decode()}\t{p2.decode()}\t{size}\t(alias {sid})\n"
                  for sid, p1, p2, size in rows)
    return sts, seq, by_delta, at_end


def _write(tmp_path, sts: str, seq: np.ndarray, label: str = "big"):
    s, f = tmp_path / "m.sts", tmp_path / "m.fa"
    s.write_text(sts)
    body = seq.tobytes().decode()
    f.write_text(f">{label} synthetic\n" + "\n".join(
        body[i : i + 70] for i in range(0, len(body), 70)) + "\n")
    return str(s), str(f)


# ------------------------------------------------------------ per tile
_CASES: dict = {}


class _Case:
    """The margin corpus at tile length 2^12 and one margin: the plane, the
    shared table and both packages' configs."""

    def __init__(self, tmp_path_factory, margin: int):
        sts, self.seq, _, _ = margin_corpus()
        path = tmp_path_factory.mktemp(f"m{margin}") / "m.sts"
        path.write_text(sts)
        eng = JaxMerPCR(margin=margin)
        assert eng.load_sts_file(str(path))
        L = 1 << 12
        cfg = eng._base_config(L, packed=True)
        assert cfg.strict and cfg.n_ranks == 2 * tscan.margin_cap(margin) + 1 > 257
        self.jcfg = jscan.ScanConfig(**{
            **cfg.__dict__, "cpos_cap": L // 8, "pos_cap": L, "cand_cap": 4096,
            "anch_cap": 64, "hit_cap": 256})
        self.jtable = eng._table
        m = eng._meta
        self.ttable = table_from_numpy(eng._table_host, m, "cpu")
        self.tcfg = tscan.default_config(
            wordsize=W, margin=margin, lead=m.lead, max_pcr_size=eng.max_pcr_size,
            p1_max=m.p1_max, p2_max=m.p2_max, tile_len=L, stride=m.stride,
            t16_bits=m.t16_bits, bloom_bits=m.bloom_bits)
        assert (self.tcfg.lead, self.tcfg.tail, self.tcfg.margin) == (
            cfg.lead, cfg.tail, cfg.margin)
        self.total_scan = N - W + 1
        self.n_tiles = -(-self.total_scan // L)
        pos = np.zeros(cfg.lead + self.n_tiles * L + cfg.tail, dtype=np.uint8)
        pos[cfg.lead : cfg.lead + N] = NIB_LUT[self.seq]
        self.plane = pack_nibbles(pos)

    def tiles(self):
        L = self.tcfg.tile_len
        for t in range(self.n_tiles):
            yield (t, self.plane[t * L // 2 : t * L // 2 + self.tcfg.tile_buf_in],
                   min(L, self.total_scan - t * L))


def _case(tmp_path_factory, margin) -> _Case:
    if margin not in _CASES:
        _CASES[margin] = _Case(tmp_path_factory, margin)
    return _CASES[margin]


@pytest.mark.parametrize("margin", MARGINS)
def test_tile_rows_match_jax(tmp_path_factory, margin):
    """Every tile at the cap's own margin and at a smaller runtime margin
    under the same cap (ranks past 2M+1 are not launched)."""
    c = _case(tmp_path_factory, margin)
    t0 = time.perf_counter()
    fn = jscan.get_scan_fn(c.jcfg)
    L = c.tcfg.tile_len
    hits, ranks = 0, set()
    for m in (margin, tscan.margin_cap(margin) - 63):
        rt = np.asarray([m, 0, 1], dtype=np.int32)
        for t, tile, n_scan in c.tiles():
            j = jax.device_get(fn(c.jtable, tile, np.int32(t * L), np.int32(n_scan),
                                  np.int32(N), rt))
            assert int(j.anch_total) <= c.jcfg.anch_cap and int(j.hit_total) <= c.jcfg.hit_cap
            o = tscan.scan_tile(c.tcfg, c.ttable, torch.from_numpy(tile), t * L, n_scan,
                                tscan.record_rmeta(N, "cpu"), None, tuple(rt))
            _assert_tile_equal(o, j, (margin, m, t))
            hits += o.hit_total
            ranks |= set(o.rank.tolist())
    admitted = [d for d in DELTAS if abs(d) <= margin]
    # offset d > 0 is rank 2d, d < 0 rank -2d - 1: ranks past the 257 of -M 128
    assert hits >= 2 * len(admitted)
    assert max(ranks) == max(2 * d if d > 0 else -2 * d - 1 for d in admitted) > 256
    assert time.perf_counter() - t0 < 120, "the large-margin comparison grew slow"


def _anchors(c: _Case, tile, t0: int, n_scan: int):
    """(a_idx, entry, ppos) of one tile through the strict front end."""
    tb, cfg = c.ttable, c.tcfg
    x = torch.from_numpy(tile)
    words, _ = front_end(x, tb.qbloom_s, tb.gq, W, cfg.lead, cfg.tile_len, n_scan)
    entry, ppos, _, _ = expand(x, words, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.csr,
                               tb.emeta.shape[0], W, cfg.lead, cfg.tile_len, n_scan,
                               cfg.stride, cfg.exact_group)
    a_idx = verify_p1(x, entry, ppos, tb.emeta, tb.p1_codes, None, t0,
                      tscan.record_rmeta(N, "cpu"), None, cfg.lead, 0, 1)
    return x, a_idx, entry, ppos


@pytest.mark.parametrize("margin", [300, 10000])
def test_chunked_plain_version_equals_unchunked(tmp_path_factory, monkeypatch, margin):
    """A pass bounded to one or to three anchors gives the rows of the
    unbounded pass, in the same order; an empty anchor list gives none."""
    c = _case(tmp_path_factory, margin)
    R = 2 * margin + 1
    rm = tscan.record_rmeta(N, "cpu")
    seen = 0
    for t, tile, n_scan in c.tiles():
        x, a_idx, entry, ppos = _anchors(c, tile, t * c.tcfg.tile_len, n_scan)
        # primer-1 decoys: every pair as an anchor makes chunks of many sizes
        many = torch.arange(entry.numel(), dtype=torch.int32)
        for a in (a_idx, many) if margin < 1000 else (a_idx,):
            args = (x, a, entry, ppos, c.ttable.emeta, c.ttable.p2_codes, None,
                    t * c.tcfg.tile_len, rm, None, c.tcfg.lead, margin, 0, 1)
            default = margin_p2_plain(*args)
            for limit in (1 << 40, 1, 3 * R, 3 * R + 1):
                with monkeypatch.context() as mp:
                    mp.setattr(margin_mod, "PLAIN_MAX_ITEMS", limit)
                    assert torch.equal(margin_p2_plain(*args), default)
            seen += default.shape[0]
    assert seen > 0
    none = margin_p2_plain(x, a_idx[:0], entry, ppos, c.ttable.emeta, c.ttable.p2_codes,
                           None, 0, rm, None, c.tcfg.lead, margin, 0, 1)
    assert none.shape == (0, 6) and none.dtype == torch.int32


def test_chunks_cover_anchors_in_order():
    a = torch.arange(10, dtype=torch.int32)
    for margin, limit, sizes in ((50, 101 * 4, [4, 4, 2]), (50, 1, [1] * 10),
                                 (10000, 1 << 24, [10]), (0, 3, [3, 3, 3, 1])):
        chunks = margin_mod._anchor_chunks(a, margin, limit)
        assert [len(ch) for ch in chunks] == sizes
        assert torch.equal(torch.cat(chunks), a)


# ------------------------------------------------------- whole searches
@pytest.mark.parametrize("margin", [50] + MARGINS)
def test_off_size_amplicons_appear_from_their_margin(tmp_path, margin):
    sts, seq, by_delta, at_end = margin_corpus()
    sts, fa = _write(tmp_path, sts, seq)
    t0 = time.perf_counter()
    port, ref, eng = _both(sts, fa, tile_len=1 << 12, margin=margin)
    assert port == ref
    lines = set(port.splitlines())
    for delta, line in by_delta.items():
        assert (line in lines) == (abs(delta) <= margin), (delta, margin)
    assert (at_end[0] in lines) == (margin >= 100) and at_end[1] in lines
    (cfg, n_tiles, _), = eng.last_scans
    assert cfg.margin == tscan.margin_cap(margin) and n_tiles == 10
    assert cfg.lead >= cfg.margin and cfg.tail >= 2 * cfg.margin
    assert time.perf_counter() - t0 < 120


@pytest.mark.parametrize("params", [
    {"margin": 2000, "mismatches": 1}, {"margin": 300, "mismatches": 2, "wordsize": 13},
    {"margin": 10000, "three_prime_match": 3, "wordsize": 14},
    {"margin": 2000, "iupac_mode": 1},
])
def test_large_margins_with_other_flags(tmp_path, params):
    sts, seq, by_delta, _ = margin_corpus()
    sts, fa = _write(tmp_path, sts, seq)
    port, ref, _ = _both(sts, fa, tile_len=1 << 13, **params)
    assert port == ref
    for delta, line in by_delta.items():
        assert (line in port) == (abs(delta) <= params["margin"])


@pytest.mark.parametrize("margin", [300, 10000])
def test_whole_search_with_chunked_margin(tmp_path, monkeypatch, margin):
    """The engine's output does not depend on the chunk limit."""
    sts, seq, _, _ = margin_corpus()
    sts, fa = _write(tmp_path, sts, seq)
    port, ref, _ = _both(sts, fa, tile_len=1 << 13, margin=margin)
    monkeypatch.setattr(margin_mod, "PLAIN_MAX_ITEMS", 2 * margin + 2)
    chunked, _, _ = _both(sts, fa, tile_len=1 << 13, margin=margin)
    assert chunked == port == ref and port.count("\n") >= 5


@pytest.mark.parametrize("margin", [129, 2000, 10000])
def test_record_shorter_than_the_window(tmp_path, margin):
    """Records of 150 and 400 bases (one alone, then two in a stream): every
    clamp is the record's own, and the window of 2M + P2MAX positions
    reaches far past both ends."""
    rng = np.random.default_rng(92)
    lines, recs = [], []
    for i, (n, size, real) in enumerate(((150, 120, 120), (400, 300, 340), (400, 380, 300))):
        seq = rng.choice(ACGT, size=n)
        p1, p2 = (rng.choice(ACGT, size=20).tobytes() for _ in range(2))
        pos = (n - real) // 2 if i < 2 else n - real  # the last ends with the record
        seq[pos : pos + 20] = np.frombuffer(p1, dtype=np.uint8)
        seq[pos + real - 20 : pos + real] = np.frombuffer(p2, dtype=np.uint8)
        lines.append(f"H{i}\t{p1.decode()}\t{p2.decode()}\t{size}\n")
        recs.append(seq.tobytes().decode())
    sts = tmp_path / "h.sts"
    sts.write_text("".join(lines))
    for name, body in (("one", recs[:1]), ("three", recs)):
        fa = tmp_path / f"{name}.fa"
        fa.write_text("".join(f">short{r}\n{s}\n" for r, s in enumerate(body)))
        port, ref, eng = _both(str(sts), str(fa), margin=margin)
        assert port == ref and port.count("\n") == len(body)
        assert [c.stream for c, _, _ in eng.last_scans] == [name == "three"]


def test_stream_of_short_scaffolds_at_m2000(tmp_path):
    """Margin windows of 4,000 positions reach across many scaffolds of 20
    to 5,000 bases; every bound is record-local, so gaps and neighbours
    never show (K14)."""
    sts, fa = write_corpus(tmp_path, 93, scaffold_lengths(93, 60), n_sts=40, dirty=0.002)
    port, ref, eng = _both(sts, fa, tile_len=1 << 13, margin=2000)
    assert port == ref and port.count("\n") >= 8
    assert [(c.stream, c.margin) for c, _, _ in eng.last_scans] == [(True, 2048)]
    narrow, _, _ = _both(sts, fa, tile_len=1 << 13, margin=50)
    assert set(narrow.splitlines()) <= set(port.splitlines())
