"""Whole searches of the port at word sizes above 11 (K12) against the JAX
package, byte for byte: a two-STS 8 kb record at W = 12 to 16 and -N 0, 1,
2; clamped product sizes at W = 16 and W = 3; a dirty record at -I 0 and
-I 1 (K10 armed at -N 0); a scaffold stream; planted k-mismatch lines; the
CLI at -W 13 -M 300; one engine swept across -N 0, 2, 0. The per-tile
comparisons are in ``test_torch_wordsize.py``.

The JAX side runs its device path (``MERPCR_TPU_HOST_MAX=0``); the port
runs the plain versions of its kernels (``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR, cli  # noqa: E402

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, run_search  # noqa: E402
from .test_torch_mismatch import mismatch_corpus  # noqa: E402
from .test_torch_stream import _both, write_corpus  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMB = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _tier(cfg):
    return cfg.stride, cfg.exact_group


def _two_sts(tmp_path, seed: int, n: int = 8000):
    """An 8 kb record holding one real (+) amplicon of size 180; S2 swaps
    the primers and matches nothing."""
    rng = np.random.default_rng(seed)
    g = rng.choice(ACGT, size=n).tobytes().decode()
    p1, p2 = g[1000:1022], g[1160:1180]
    sts = tmp_path / "two.sts"
    sts.write_text(f"S1\t{p1}\t{p2}\t180\nS2\t{p2}\t{p1}\t300\n")
    fa = tmp_path / "two.fa"
    fa.write_text(">two\n" + "\n".join(g[i : i + 60] for i in range(0, n, 60)) + "\n")
    return str(sts), str(fa)


@pytest.mark.parametrize("W,n_mm", [(W, n) for W in (12, 13, 14) for n in (0, 1, 2)]
                         + [(15, 0), (16, 0), (16, 2)])
def test_two_sts_record(tmp_path, W, n_mm):
    sts, fa = _two_sts(tmp_path, W)
    port, ref, eng = _both(sts, fa, wordsize=W, mismatches=n_mm)
    assert port == ref and port.startswith("two\t1001..1180\tS1")
    (cfg, _, _), = eng.last_scans
    assert _tier(cfg) == (2, W <= 13) and eng._meta.strict
    assert cfg.strict == (n_mm == 0 or (n_mm == 1 and eng._meta.strict1))


@pytest.mark.parametrize("params", [
    {"margin": 0, "wordsize": 16}, {"wordsize": 16, "mismatches": 2},
    {"wordsize": 3}, {"margin": 2000, "wordsize": 3}, {"wordsize": 13, "margin": 2000},
])
def test_clamped_sizes_at_the_word_size_bounds(tmp_path, params):
    """Stated sizes far above the record, a size range and a size below the
    primers' lengths (``tests/test_oracle_equiv.py::test_extreme_params_identical``),
    at W = 16 (keys use all 32 bits) and W = 3."""
    rng = np.random.default_rng(3)
    g = rng.choice(ACGT, size=3000).tobytes().decode()
    p1, p2 = g[500:522], g[700:720]
    sts = tmp_path / "e.sts"
    sts.write_text(f"S1\t{p1}\t{p2}\t9000\nS2\t{p1}\t{p2}\t100-340\nS3\t{p1}\t{p2}\t4\n")
    fa = tmp_path / "e.fa"
    fa.write_text(">edge rec\n" + "\n".join(g[i : i + 60] for i in range(0, len(g), 60)) + "\n")
    port, ref, _ = _both(str(sts), str(fa), **params)
    assert port == ref and port


def test_w16_keys_above_2_to_31(tmp_path):
    """At W = 16 a W-mer ending in G or T has bit 31 set: the binary search
    must order keys as unsigned."""
    sts, fa, expect = mismatch_corpus(tmp_path, seed=83)
    port, ref, eng = _both(sts, fa, tile_len=1 << 13, wordsize=16)
    assert port == ref and all(line in port for line in expect[0])
    assert (eng._table.uhash < 0).any() and (eng._table.uhash >= 0).any()


@pytest.mark.parametrize("W,iupac,n_mm", [(12, 1, 0), (13, 1, 0), (14, 1, 0), (16, 1, 0),
                                          (13, 0, 0), (14, 1, 2)])
def test_dirty_record_equals_jax(tmp_path, W, iupac, n_mm):
    """A record with 1 % scattered ambiguity letters (K10 armed at -N 0),
    at -I 0 and -I 1 (``tests/test_pathological.py::TestDirtyBloomFilter``)."""
    rng = np.random.default_rng(41 + W)
    n = 30_000
    g = rng.choice(ACGT, size=n)
    at = rng.integers(0, n, size=n // 100)
    g[at] = AMB[rng.integers(0, len(AMB), size=len(at))]
    lines = []
    for i in range(30):
        plen = int(rng.integers(max(18, W + 2), 26))
        p1, p2 = (rng.choice(ACGT, size=plen) for _ in range(2))
        size = int(rng.integers(80, 300))
        if i < 12:
            pos = int(rng.integers(0, n - size - 1))
            g[pos : pos + plen] = p1
            g[pos + size - plen : pos + size] = p2
            if i % 3 == 0:
                g[min(n - 1, pos + plen + 1)] = ord("R")
        lines.append(f"D{i}\t{p1.tobytes().decode()}\t{p2.tobytes().decode()}\t{size}\n")
    sts = tmp_path / "d.sts"
    sts.write_text("".join(lines))
    fa = tmp_path / "d.fa"
    fa.write_text(">dirty\n" + g.tobytes().decode() + "\n")
    port, ref, eng = _both(str(sts), str(fa), tile_len=1 << 13, wordsize=W,
                           iupac_mode=iupac, mismatches=n_mm)
    assert port == ref and port.count("\n") >= 6
    assert all(c.dirty_bloom == c.strict for c, _, _ in eng.last_scans)


@pytest.mark.parametrize("W,n_mm", [(12, 0), (14, 0), (13, 2), (16, 2)])
def test_scaffold_stream_equals_jax(tmp_path, W, n_mm):
    sts, fa = write_corpus(tmp_path, 72, [9_000, 0, 5, 3_000, W, W + 1, 17_000, 700],
                           n_sts=30, dirty=0.004)
    port, ref, eng = _both(sts, fa, tile_len=1 << 12, wordsize=W, mismatches=n_mm)
    assert port == ref and port.count("\n") >= 4
    assert {c.stream for c, _, _ in eng.last_scans} == {True, False}


@pytest.mark.parametrize("W", [12, 13, 14, 16])
def test_k_mismatch_lines_at_wide_words(tmp_path, W):
    """Planted k-mismatch amplicons appear exactly at -N >= k; the plants'
    mismatches lie past the first W + 1 primer bases only for W <= 11, so
    at wider words the lines are held to the JAX bytes, and the exact
    plants to their lines."""
    sts, fa, expect = mismatch_corpus(tmp_path)
    for n_mm in (0, 2):
        port, ref, _ = _both(sts, fa, tile_len=1 << 13, wordsize=W, mismatches=n_mm)
        assert port == ref and all(line in port for line in expect[0])
        assert not any(line in port for k in (1, 2, 3) if k > n_mm for line in expect[k])


def test_one_engine_sweeps_n_at_w13(tmp_path):
    """-N 0, 2, 0 in one engine at W = 13: the word size's tables serve both
    front ends, the two -N 0 searches print the same bytes, and each search
    prints the JAX engine's bytes for the same sweep."""
    sts, fa, _ = mismatch_corpus(tmp_path)
    outs = []
    for eng in (MerPCR(device="cpu", wordsize=13), JaxMerPCR(wordsize=13)):
        assert eng.load_sts_file(sts)
        recs = eng.load_fasta_file(fa)
        row = []
        for n_mm in (0, 2, 0):
            eng.mismatches = n_mm
            row.append(run_search(eng, recs))
        outs.append(row)
    port, ref = outs
    assert port == ref and port[0] == port[2] and port[0]


def test_cli_at_w13_m300(capsys):
    """``python -m merpcr_tpu_torch ... -W 13 -M 300`` (here through
    ``cli.main`` on the CPU) prints the API's and the JAX package's bytes."""
    port, ref, _ = _both(GOLDEN_STS, GOLDEN_FA, wordsize=13, margin=300)
    assert port == ref and GOLDEN_LINE + "\n" in port
    rc = cli.main([GOLDEN_STS, GOLDEN_FA, "-W", "13", "-M", "300"], device="cpu")
    assert rc == 0 and capsys.readouterr().out == port
