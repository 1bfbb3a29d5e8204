"""Per-tile equality of the PyTorch port's strict N=0 scan with the JAX
package's ``get_scan_fn``.

Both sides scan the identical table (compiled once by ``merpcr_tpu`` and
carried to the port by ``table_from_numpy``) and identical tile bytes made
from a NumPy seed. The port runs the plain PyTorch versions of its four
kernels (CPU tensors); JAX runs its XLA program on the CPU with capacities
large enough that nothing truncates. Everything compared is an integer, so
the tolerance is 0: the five stage totals, the flag words (through the JAX
program's own ``stop="words"`` checksum) and every hit row.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from merpcr_tpu.engine import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu.ops.encoding import NIB_LUT, pack_nibbles  # noqa: E402
from merpcr_tpu.ops.scan import (  # noqa: E402
    ScanConfig as JaxScanConfig,
    _scan_tile_impl,
    get_scan_fn,
)
from merpcr_tpu_torch.ops import scan as tscan  # noqa: E402
from merpcr_tpu_torch.ops.front_end import front_end  # noqa: E402
from merpcr_tpu_torch.ops.table import table_from_numpy  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
TRANSITION = bytes.maketrans(b"ACGT", b"GTAC")
N_STS = 40
SEQ_LEN = 3 * (1 << 13) + 777  # 3-7 tiles at the tested tile lengths


def _rand(rng, n):
    return rng.choice(ACGT, size=n)


def _sts_rows(rng):
    rows = []
    for i in range(N_STS):
        p1 = _rand(rng, int(rng.integers(18, 26))).tobytes()
        p2 = _rand(rng, int(rng.integers(18, 26))).tobytes()
        rows.append((f"S{i}", p1, p2, int(rng.integers(100, 400))))
    return rows


def _plant(seq, pos, left, right, size):
    if pos < 0 or pos + size > len(seq):
        return
    seq[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
    seq[pos + size - len(right) : pos + size] = np.frombuffer(right, dtype=np.uint8)


def make_corpus(kind: str, tile_len: int, seed: int = 7):
    """(sts_text, genome uint8[n]) for a corpus kind:

    * random   — random genome and STS (front-end and expansion work only)
    * planted  — every 3rd STS planted in both orientations, some with the
                 product 1..40 bases longer or shorter than stated (margin
                 ranks d != 0), one near the record end (clamps), plus
                 scattered ambiguity letters and an N run
    * boundary — amplicons across every tile boundary, anchor W-mers that
                 straddle a boundary, and a primer-1 ending at the record's
                 last base
    """
    rows = _sts_rows(np.random.default_rng(seed))  # one STS set for all kinds
    rng = np.random.default_rng(seed + len(kind) + tile_len)
    seq = _rand(rng, SEQ_LEN)
    if kind == "random":
        # decoys: primer-1 prefixes that end in a mismatch (flagged units,
        # expanded positions, t16 and verify rejections) and whole primer-1
        # copies with no primer 2 in reach (anchors without hits)
        for i in range(N_STS):
            _, p1, _, _ = rows[i]
            k = len(p1) if i % 5 == 0 else int(rng.integers(11, len(p1)))
            dec = bytearray(p1[:k])
            if k < len(p1):
                dec += p1[k : k + 1].translate(TRANSITION)  # a sure mismatch
            _plant(seq, int(rng.integers(0, SEQ_LEN - 40)), bytes(dec), b"", len(dec))
    elif kind == "planted":
        for i in range(0, N_STS, 3):
            _, p1, p2, size = rows[i]
            rc1 = p1.translate(COMP)[::-1]
            delta = int(rng.integers(-40, 41)) if i % 2 else 0
            pos = int(rng.integers(0, SEQ_LEN - 500))
            _plant(seq, pos, p1, p2, size + delta)  # (+)
            pos = int(rng.integers(0, SEQ_LEN - 500))
            _plant(seq, pos, p2, rc1, size - delta)  # (-)
        _, p1, p2, size = rows[1]
        _plant(seq, SEQ_LEN - size + 5, p1, p2, size - 5)  # product past the end
        amb = rng.choice(np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8), size=12)
        seq[rng.integers(0, SEQ_LEN, size=12)] = amb
        seq[5000:5030] = ord("N")
    elif kind == "boundary":
        for t in range(1, SEQ_LEN // tile_len + 1):
            b = t * tile_len
            _, p1, p2, size = rows[(2 * t) % N_STS]
            _plant(seq, b - 60, p1, p2, size)  # amplicon across the boundary
            _, p1, p2, size = rows[(2 * t + 1) % N_STS]
            rc1 = p1.translate(COMP)[::-1]
            _plant(seq, b - 7, p2, rc1, size)  # (-) anchor W-mer straddles it
        _, p1, p2, size = rows[0]
        seq[SEQ_LEN - len(p1):] = np.frombuffer(p1, dtype=np.uint8)
    sts = "".join(
        f"{sid}\t{p1.decode()}\t{p2.decode()}\t{size}\talias {sid}\n"
        for sid, p1, p2, size in rows
    )
    return sts, seq


_ENGINE: list = []


def _jax_engine(tmp_path, sts: str):
    """The JAX engine with the (shared) STS set loaded, built once."""
    if not _ENGINE:
        path = tmp_path / "c.sts"
        path.write_text(sts)
        eng = JaxMerPCR()
        assert eng.load_sts_file(str(path))
        _ENGINE.append((eng, table_from_numpy(eng._table_host, eng._meta, "cpu")))
    return _ENGINE[0]


class _Case:
    """One corpus: the JAX engine's table and both packages' configs."""

    def __init__(self, tmp_path, kind: str, tile_len: int):
        sts, self.seq = make_corpus(kind, tile_len)
        eng, self.ttable = _jax_engine(tmp_path, sts)
        cfg = eng._base_config(tile_len, packed=True)
        assert cfg.strict and cfg.exact_group and not cfg.dirty_bloom
        units = tile_len // 8
        # capacities large enough that no JAX stage truncates
        self.jcfg = JaxScanConfig(**{
            **cfg.__dict__, "cpos_cap": units, "pos_cap": tile_len,
            "cand_cap": 8192, "anch_cap": 1024, "hit_cap": 4096,
        })
        self.jtable = eng._table
        m = eng._meta
        self.tcfg = tscan.default_config(
            wordsize=11, margin=50, lead=m.lead, max_pcr_size=eng.max_pcr_size,
            p1_max=m.p1_max, p2_max=m.p2_max, tile_len=tile_len,
            stride=m.stride, t16_bits=m.t16_bits,
        )
        assert (self.tcfg.lead, self.tcfg.tail) == (cfg.lead, cfg.tail)
        n = len(self.seq)
        self.n = n
        self.total_scan = n - 11 + 1
        L = tile_len
        self.n_tiles = -(-self.total_scan // L)
        pos = np.zeros(cfg.lead + self.n_tiles * L + cfg.tail, dtype=np.uint8)
        pos[cfg.lead : cfg.lead + n] = NIB_LUT[self.seq]
        self.plane = pack_nibbles(pos)

    def tile(self, t):
        L = self.jcfg.tile_len
        return self.plane[t * L // 2 : t * L // 2 + self.jcfg.tile_buf_in]

    def n_scan(self, t):
        L = self.jcfg.tile_len
        return int(np.clip(self.total_scan - t * L, 0, L))


_CASES: dict = {}


def _case(tmp_path_factory, kind, tile_len):
    key = (kind, tile_len)
    if key not in _CASES:
        _CASES[key] = _Case(tmp_path_factory.mktemp(f"{kind}{tile_len}"), kind, tile_len)
    return _CASES[key]


@pytest.mark.parametrize("margin", [0, 50, 64])
@pytest.mark.parametrize("tile_len", [1 << 12, 1 << 13])
@pytest.mark.parametrize("kind", ["random", "planted", "boundary"])
def test_tile_totals_and_rows_match_jax(tmp_path_factory, kind, tile_len, margin):
    c = _case(tmp_path_factory, kind, tile_len)
    fn = get_scan_fn(c.jcfg)
    hits = 0
    for x in (0, 1, 3):
        rt = np.asarray([margin, 0, x], dtype=np.int32)
        for t in range(c.n_tiles):
            tile = c.tile(t)
            j = jax.device_get(fn(c.jtable, tile, np.int32(t * tile_len),
                                  np.int32(c.n_scan(t)), np.int32(c.n), rt))
            o = tscan.scan_tile(c.tcfg, c.ttable, torch.from_numpy(tile),
                                t * tile_len, c.n_scan(t),
                                tscan.record_rmeta(c.n, "cpu"), None, tuple(rt))
            jt = tuple(int(v) for v in (j.c_total, j.pos_total, j.pair_total,
                                        j.anch_total, j.hit_total))
            assert o[:5] == jt, (kind, tile_len, margin, x, t)
            h = o.hit_total
            for name in ("pos1", "pos2", "entry", "pair_order", "rank", "rec"):
                np.testing.assert_array_equal(
                    getattr(o, name).numpy(), np.asarray(getattr(j, name))[:h],
                    err_msg=f"{name} tile {t}",
                )
            hits += h
    if kind != "random" and margin:
        assert hits > 0, "planted corpus produced no hits"


@pytest.mark.parametrize("tile_len", [1 << 12, 1 << 13])
@pytest.mark.parametrize("kind", ["random", "planted", "boundary"])
def test_front_end_words_match_jax(tmp_path_factory, kind, tile_len):
    """front_end's flag words against the JAX program stopped after its
    word packing (an int32-wrapping sum of the words)."""
    c = _case(tmp_path_factory, kind, tile_len)
    stop = jax.jit(lambda tb, n_scan: _scan_tile_impl(
        c.jcfg, c.jtable, tb, np.int32(0), n_scan, np.int32(c.n), stop="words",
    ).c_total)
    for t in range(c.n_tiles):
        words, c_total = front_end(
            torch.from_numpy(c.tile(t)), c.ttable.qbloom_s, c.ttable.gq, 11,
            c.tcfg.lead, tile_len, c.n_scan(t),
        )
        want = int(stop(c.tile(t), np.int32(c.n_scan(t))))
        got = int(words.to(torch.int64).sum()) & 0xFFFFFFFF
        assert got == want & 0xFFFFFFFF, t
        flags = int(sum(bin(w & 0xFFFFFFFF).count("1") for w in words.tolist()))
        assert flags == int(c_total)
