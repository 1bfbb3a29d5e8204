"""The PyTorch port's table compiler and its lazy strict1 build equal the
JAX package's, field by field, and ``table_from_numpy`` carries the
scanned fields unchanged."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from merpcr_tpu.io.sts import STSLoader as JaxSTSLoader  # noqa: E402
from merpcr_tpu.ops.table import build_strict1 as jax_build_strict1  # noqa: E402
from merpcr_tpu.ops.table import compile_table as jax_compile_table  # noqa: E402
from merpcr_tpu_torch.io.sts import STSLoader  # noqa: E402
from merpcr_tpu_torch.ops.table import (  # noqa: E402
    build_strict1,
    compile_table,
    table_from_numpy,
)

from .conftest import GOLDEN_STS  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_sts(path, seed: int, n: int, iupac: bool = False) -> str:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTRYN" if iupac else b"ACGT", dtype=np.uint8)
    lines = []
    for i in range(n):
        p1 = rng.choice(alphabet, size=int(rng.integers(12, 28))).tobytes().decode()
        p2 = rng.choice(alphabet, size=int(rng.integers(12, 28))).tobytes().decode()
        size = f"{rng.integers(80, 200)}-{rng.integers(200, 500)}" if i % 7 == 0 else str(rng.integers(50, 450))
        lines.append(f"R{i}\t{p1}\t{p2}\t{size}\talias {i}\n")
    path.write_text("".join(lines))
    return str(path)


def _cases(tmp_path):
    return {
        "golden": GOLDEN_STS,
        "random": _random_sts(tmp_path / "r.sts", 1, 300),
        "ambiguous": _random_sts(tmp_path / "a.sts", 2, 60, iupac=True),
    }


def _n_rich_sts(path) -> str:
    """60 STS whose primer-1 extensions hold six N letters: at -I 1 the
    N=0 strict tables arm, and the N=1 wildcard union passes the 2^22
    insert guard of build_strict1."""
    rng = np.random.default_rng(62)
    lines = []
    for i in range(60):
        p1 = bytearray(rng.choice(ACGT, size=24).tobytes())
        p1[12:18] = b"NNNNNN"
        p2 = rng.choice(ACGT, size=22).tobytes().decode()
        lines.append(f"B{i}\t{p1.decode()}\t{p2}\t{int(rng.integers(100, 250))}\n")
    path.write_text("".join(lines))
    return str(path)


def _assert_same(host, meta, jhost, jmeta):
    assert host._fields == jhost._fields
    for name in host._fields:
        a, b = getattr(host, name), getattr(jhost, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for f in dataclasses.fields(meta):
        a, b = getattr(meta, f.name), getattr(jmeta, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case,iupac,armed", [
    ("golden", False, True), ("random", False, True), ("ambiguous", True, True),
    ("n_rich", True, False),
])
def test_build_strict1_matches_jax(tmp_path, case, iupac, armed):
    """The strict1 tables and meta equal the JAX package's, for sets that
    arm them and for one whose insert guard bails (strict stays armed at
    N=0, strict1 does not)."""
    cases = _cases(tmp_path)
    path = cases[case] if case in cases else _n_rich_sts(tmp_path / "n.sts")
    res = STSLoader.load_file(path, 11, 240)
    host, meta = compile_table(res, 11, iupac)
    jhost, jmeta = jax_compile_table(JaxSTSLoader.load_file(path, 11, 240), 11,
                                     iupac, device=False)
    assert meta.strict and not meta.strict1
    host, meta = build_strict1(host, meta, iupac)
    jhost, jmeta = jax_build_strict1(jhost, jmeta, iupac)
    _assert_same(host, meta, jhost, jmeta)
    assert meta.strict1 == armed and meta.strict
    t = table_from_numpy(host, meta, "cpu")
    assert t.strict1 == armed
    if armed:
        assert host.qbloom_s1.size > 1 and (1 << t.gq1) == host.qbloom_s1.size * 32
        np.testing.assert_array_equal(t.qbloom_s1.numpy().view(np.uint32), host.qbloom_s1)
        np.testing.assert_array_equal(t.t16_1.numpy().view(np.uint32), host.t16_1)
        assert t.t16_1_bits == meta.t16_1_bits
    else:
        assert host.qbloom_s1.size == host.t16_1.size == 1


@pytest.mark.parametrize("wordsize,iupac", [(11, False), (8, False), (11, True),
                                            (12, False), (13, False), (14, False),
                                            (16, False), (14, True)])
@pytest.mark.parametrize("case", ["golden", "random", "ambiguous"])
def test_compile_table_matches_jax(tmp_path, case, wordsize, iupac):
    path = _cases(tmp_path)[case]
    res = STSLoader.load_file(path, wordsize, 240)
    jres = JaxSTSLoader.load_file(path, wordsize, 240)
    host, meta = compile_table(res, wordsize, iupac)
    jhost, jmeta = jax_compile_table(jres, wordsize, iupac, device=False)
    _assert_same(host, meta, jhost, jmeta)
    assert [r.__dict__ for r in res.records] == [r.__dict__ for r in jres.records]


def test_table_from_numpy_keeps_bits(tmp_path):
    res = STSLoader.load_file(_cases(tmp_path)["random"], 11, 240)
    host, meta = compile_table(res, 11, False)
    t = table_from_numpy(host, meta, "cpu")
    for name in ("qbloom_s", "ptab", "t16", "qbloom", "qbloom_s1", "t16_1"):
        got = getattr(t, name).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, getattr(host, name), err_msg=name)
    np.testing.assert_array_equal(t.bsc.numpy(), host.bsc)
    np.testing.assert_array_equal(t.emeta.numpy(), host.emeta)
    np.testing.assert_array_equal(t.p1_codes.numpy(), host.p1_codes)
    np.testing.assert_array_equal(t.p2_codes.numpy(), host.p2_codes)
    for name in ("p1_bytes", "p2_bytes", "match"):
        got = getattr(t, name)
        assert got.dtype == torch.uint8, name
        np.testing.assert_array_equal(got.numpy(), getattr(host, name), err_msg=name)
    assert t.qbloom_s.dtype == torch.int32
    assert (1 << t.gq) == host.qbloom_s.size * 32
    assert t.pf_bits == 2 * (11 + 2) and t.t16_bits == meta.t16_bits > 0
    assert (1 << t.q_bits) == host.qbloom.size * 32 and t.q_bits <= 2 * (11 + 3)
    assert not t.strict1 and t.gq1 == 5 and t.t16_1_bits == 0  # [1] dummies


@pytest.mark.parametrize("wordsize", [11, 12, 13, 14, 16])
def test_table_from_numpy_carries_the_word_size_tier(tmp_path, wordsize):
    """``bstart``, ``uhash``, ``ustart``, ``stride``, ``exact_group`` and
    ``qbloom_bits`` of a table compiled by the JAX package reach the port
    equal to the JAX ``DeviceTable``'s, and ``csr`` names the lookup of the
    word size. ``uhash`` keeps its uint32 bits: at W = 16 keys pass 2^31
    and are negative as int32, ascending only as unsigned."""
    path = _random_sts(tmp_path / "w.sts", 9, 400)
    jres = JaxSTSLoader.load_file(path, wordsize, 240)
    jhost, jmeta = jax_compile_table(jres, wordsize, False, device=False)
    jdev, _ = jax_compile_table(jres, wordsize, False)  # the JAX DeviceTable
    t = table_from_numpy(jhost, jmeta, "cpu")
    for name in ("bstart", "ustart", "bsc"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jdev, name)),
                                      err_msg=name)
    for name in ("uhash", "qbloom", "ptab"):
        np.testing.assert_array_equal(getattr(t, name).numpy().view(np.uint32),
                                      np.asarray(getattr(jdev, name)), err_msg=name)
    assert (t.wordsize, t.stride, t.exact_group, t.qbloom_bits) == (
        wordsize, jmeta.stride, jmeta.exact_group, jmeta.qbloom_bits)
    assert t.stride == (4 if wordsize <= 11 else 2) and t.exact_group == (wordsize <= 13)
    assert (1 << t.q_bits) == jhost.qbloom.size * 32
    if t.exact_group:
        assert (t.stride << t.pf_bits) == jhost.ptab.size * 32
        assert t.pf_bits == 2 * (wordsize + t.stride - 2)
    else:
        assert jhost.ptab.size == 1 and t.q_bits == t.qbloom_bits
    u = t.uhash.numpy().view(np.uint32).astype(np.int64)
    assert (np.diff(u) > 0).all() and t.ustart.numel() == t.uhash.numel() + 1
    if wordsize == 16:
        assert (t.uhash.numpy() < 0).any()
    csr = t.csr
    if wordsize <= 11:
        assert csr is t.bsc and t.bsc.shape == (4**wordsize, 2) and t.bstart.numel() == 2
    elif wordsize == 12:
        assert csr is t.bstart and t.bstart.numel() == 4**12 + 1 and t.bsc.shape == (1, 2)
    else:
        assert csr[0] is t.uhash and csr[1] is t.ustart and t.bstart.numel() == 2


@pytest.mark.parametrize("iupac", [False, True])
def test_table_carries_the_raw_byte_fields(tmp_path, iupac):
    """``p1_bytes``, ``p2_bytes`` and ``match`` (the raw-byte path, K9) of a
    table compiled by the port equal the JAX ``DeviceTable``'s: primer
    bytes as written (U and lowercase kept, zero-padded) and the 256 x 256
    match table of the table's -I mode."""
    path = tmp_path / "u.sts"
    path.write_text("U1\tGGCUCAGAGUAUUUGGGAUG\tctcttggaatcctatctcactg\t200\n"
                    "U2\tACGTRYNACGTACGTACG\tTTTTGGGGCCCCAAAAU\t150\n")
    res = STSLoader.load_file(str(path), 11, 240)
    host, meta = compile_table(res, 11, iupac)
    t = table_from_numpy(host, meta, "cpu")
    jdev, _ = jax_compile_table(JaxSTSLoader.load_file(str(path), 11, 240), 11, iupac)
    for name in ("p1_bytes", "p2_bytes", "match"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(jdev, name)),
                                      err_msg=name)
    assert t.match.numel() == 1 << 16
    assert bytes(t.p1_bytes[0, :20].tolist()) == b"GGCUCAGAGUAUUUGGGAUG"
    u, tt = ord("U"), ord("T")
    assert int(t.match[u * 256 + tt]) == int(iupac)  # U ~ T only at -I 1
