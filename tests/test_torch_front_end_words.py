"""NumPy models of ``csrc/front_end.cu``'s loose (K8/K12a) and raw-byte
(K9a) kernels against ``front_end_loose_plain`` / ``front_end_raw_plain``,
and of the prefilter fold (``table.fold_bits``) both kernels test first.

The loose kernel takes 4 units per thread: per unit one exact-width smear
of the dirty fields ANDed with the scan bound gives the clean phases, and
per stride group its key, one bit of the prefilter at ``(key >> shift) &
(2^bits - 1)`` and, where that bit is set, the key clean and the group
valid, one bit of the full table; ``G`` groups per thread, ``32 / G``
threads per flag word. The raw kernel takes 16 positions per thread: the
codes of its 16 bytes and of the next 16 (only W - 1 readable past the
tile), each W-mer one funnel shift of the two code words, one smear of
the ambiguity bits, the prefilter bit and the confirming bloom bit. The
models below are that arithmetic on NumPy arrays; the card tests
(``tests/test_torch_kernels.py``) hold the kernels to the plain versions
on the same edges. Nothing here compiles a JAX program: the JAX side is
its NumPy table compiler alone.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from merpcr_tpu_torch.io.sts import STSLoader
from merpcr_tpu_torch.ops.front_end import (_prefilter, front_end_loose_plain,
                                            front_end_raw_plain)
from merpcr_tpu_torch.ops.table import (PREFILTER_BITS, compile_table, fold_bits,
                                        prefilter_shift, table_from_numpy)
from merpcr_tpu_torch.ops.units import scode

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B1
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
AMBIG = 100  # csrc/units.cuh kAmbig


# ---------------------------------------------------------------- tables
def _sts(path, seed: int, n: int, primers=None) -> str:
    """``n`` random STS (primers 18-25 nt); ``primers`` replaces the first
    primer-1 sequences."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        p1 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes().decode()
        if primers is not None and i < len(primers):
            p1 = primers[i]
        p2 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes().decode()
        lines.append(f"S{i}\t{p1}\t{p2}\t{int(rng.integers(100, 400))}\n")
    path.write_text("".join(lines))
    return str(path)


def _table(path, wordsize: int):
    res = STSLoader.load_file(path, wordsize, 240)
    host, meta = compile_table(res, wordsize, False)
    return host, meta, table_from_numpy(host, meta, "cpu")


def _bits(words: torch.Tensor) -> np.ndarray:
    """bool[32 * n] of int32 words, bit i of word k at 32k + i."""
    return np.unpackbits(words.numpy().view(np.uint8), bitorder="little").astype(bool)


def fold_model(table_bits: np.ndarray, shift: int, bits: int) -> np.ndarray:
    """The fold by definition: result bit j is set iff some set table bit b
    has (b >> shift) & (2^bits - 1) == j."""
    out = np.zeros(1 << bits, dtype=bool)
    out[(np.flatnonzero(table_bits) >> shift) & ((1 << bits) - 1)] = True
    return out


def _all_kmers(k: int) -> list:
    return ["".join("ACGT"[(v >> (2 * (k - 1 - j))) & 3] for j in range(k)) + "ACGTACGTACGTACGTAC"
            for v in range(4 ** k)]


SETS = {  # name: (wordsize, STS count, all 3-mers as primer-1 starts)
    "W3": (3, 40, False), "W3dense": (3, 64, True), "W8": (8, 150, False),
    "W11": (11, 300, False), "W12": (12, 300, False), "W13": (13, 300, False),
    "W14": (14, 1200, False), "W16": (16, 1200, False),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_prefilters_are_sound_folds(tmp_path, name):
    """``loose_prefilter`` and ``raw_prefilter`` of a ``Table`` equal the fold model of
    ``qbloom`` / ``bloom`` at the window the port picks, so every set bit of
    the full table lands on a set prefilter bit; a table of at most
    2^PREFILTER_BITS bits is its own prefilter. The dense W = 3 set (every 3-mer a key) has
    a table, and a fold, of all ones."""
    W, n, dense = SETS[name]
    _, meta, t = _table(_sts(tmp_path / "s.sts", 7, n, _all_kmers(3) if dense else None), W)
    q = _bits(t.qbloom)
    assert t.qpre_bits == min(t.q_bits, PREFILTER_BITS)
    assert t.qpre_shift == prefilter_shift(t.q_bits, W, t.stride, not t.exact_group)
    pre = _bits(t.loose_prefilter[0])
    np.testing.assert_array_equal(pre, fold_model(q, t.qpre_shift, t.qpre_bits))
    assert pre[(np.flatnonzero(q) >> t.qpre_shift) & ((1 << t.qpre_bits) - 1)].all()
    if t.q_bits <= PREFILTER_BITS:
        assert t.loose_prefilter[0] is t.qbloom
    b = _bits(t.bloom)
    np.testing.assert_array_equal(_bits(t.raw_prefilter[0]), fold_model(b, 0, t.bpre_bits))
    assert t.raw_prefilter[1:] == (t.bpre_bits, 0)
    assert t.bpre_bits == min(t.bloom_bits, PREFILTER_BITS)
    # other windows of the same table, down to 2^5 bits
    for shift, bits in ((0, 5), (1, 7), (t.q_bits - 8, 8), (3, t.q_bits - 4)):
        np.testing.assert_array_equal(_bits(fold_bits(t.qbloom, shift, bits)),
                                      fold_model(q, shift, bits))
    if dense:
        assert q.all() and pre.all() and _bits(fold_bits(t.qbloom, 2, 8)).all()
    # the middle of an exact span key: bases 2 .. 11 (W = 11, 13) or 2 .. 12
    expect = {"W11": 4, "W12": 4, "W13": 4}
    if name in expect:
        assert t.qpre_shift == expect[name]


def test_empty_set_has_empty_prefilters(tmp_path):
    """A set whose primers are all shorter than W compiles no entry: both
    prefilters are all zeros, so every clean item is rejected without a
    gather."""
    path = tmp_path / "e.sts"
    path.write_text("E1\tACGTACG\tTTGCA\t120\n")
    _, meta, t = _table(str(path), 11)
    assert t.emeta.shape[0] == 0 or meta.n_entries == 0
    assert not _bits(t.loose_prefilter[0]).any() and not _bits(t.raw_prefilter[0]).any()


@pytest.mark.parametrize("W", [3, 11, 12, 16])
def test_raw_bloom_prefilter(tmp_path, W):
    """The raw path's ``bloom`` (2^min(2W, 24) bits, exact up to W = 12)
    folded to its low PREFILTER_BITS bits: sound, and the bloom itself
    where it is no larger (W = 3)."""
    _, _, t = _table(_sts(tmp_path / "r.sts", 11, 200), W)
    b = _bits(t.bloom)
    pre = _bits(t.raw_prefilter[0])
    assert pre[np.flatnonzero(b) & ((1 << t.bpre_bits) - 1)].all()
    assert pre.sum() <= b.sum()
    assert (t.raw_prefilter[0] is t.bloom) == (t.bloom_bits <= PREFILTER_BITS)


@pytest.mark.parametrize("W", [3, 8, 11, 14])
def test_replica_folds_its_own_prefilters(tmp_path, W):
    """A Table whose tensors were copied one by one, as
    ``parallel/sharded.py::replicate`` copies them to another card, folds
    its own prefilters from its own copies, once each, and the wrappers'
    check takes them: where the table is no larger than the prefilter, the
    prefilter is the copy's own table (an equal copy, not the original)."""
    _, _, t = _table(_sts(tmp_path / "c.sts", 13, 300), W)
    copy = t._replace(**{f: v.clone() for f, v in zip(t._fields, t)
                         if isinstance(v, torch.Tensor)})
    for (pre, bits, shift), (cpre, cbits, cshift), table, t_bits in (
            (t.loose_prefilter, copy.loose_prefilter, copy.qbloom, copy.q_bits),
            (t.raw_prefilter, copy.raw_prefilter, copy.bloom, copy.bloom_bits)):
        assert (cbits, cshift) == (bits, shift) and torch.equal(cpre, pre)
        assert (cpre is table) == (t_bits <= PREFILTER_BITS) and cpre is not pre
        assert _prefilter((cpre, cbits, cshift), t_bits)[0] is cpre
    assert copy.loose_prefilter[0] is copy.loose_prefilter[0]  # folded once
    assert t.loose_prefilter[0] is not copy.loose_prefilter[0]


def test_prefilter_argument_checks(tmp_path):
    """The wrappers' prefilter check: required on the card, a power-of-two
    bit count from 2^5 to 2^20 that matches its words, and a window inside
    the table."""
    _, _, t = _table(_sts(tmp_path / "k.sts", 17, 100), 12)
    pre, bits, shift = t.loose_prefilter
    assert _prefilter((pre, bits, shift), t.q_bits)[1:] == (bits, shift)
    for bad in (None, (pre, bits + 1, shift), (pre, bits, t.q_bits - bits + 1),
                (pre, bits, -1), (torch.zeros(1 << 16, dtype=torch.int32), 21, 0),
                (pre.to(torch.int64), bits, shift)):
        with pytest.raises((ValueError, TypeError)):
            _prefilter(bad, t.q_bits)


@pytest.mark.parametrize("W", [8, 11, 12, 14])
def test_prefilter_same_from_either_host_table(tmp_path, W):
    """A ``Table`` derives the same prefilters from the port's host table
    and from the JAX package's (its NumPy compiler; no JAX program runs)."""
    pytest.importorskip("jax")
    from merpcr_tpu.io.sts import STSLoader as JaxSTSLoader
    from merpcr_tpu.ops.table import compile_table as jax_compile_table

    path = _sts(tmp_path / "j.sts", 5, 300)
    _, _, t = _table(path, W)
    jhost, jmeta = jax_compile_table(JaxSTSLoader.load_file(path, W, 240), W, False,
                                     device=False)
    j = table_from_numpy(jhost, jmeta, "cpu")
    assert (t.qpre_bits, t.qpre_shift, t.bpre_bits) == (j.qpre_bits, j.qpre_shift, j.bpre_bits)
    assert torch.equal(t.loose_prefilter[0], j.loose_prefilter[0])
    assert torch.equal(t.raw_prefilter[0], j.raw_prefilter[0])


# ---------------------------------------------------------------- loose kernel
def _codes_of(u):
    m = u & 0x33333333
    m = (m | (m >> 2)) & 0x0F0F0F0F
    m = (m | (m >> 4)) & 0x00FF00FF
    return (m | (m >> 8)) & 0xFFFF


def _dirty_smear(Aa, Ba, W: int):
    """csrc/units.cuh ``dirty_smear`` on uint64 arrays."""
    lo, hi = [Aa], [Ba]
    for k in range(1, 5):
        s = 1 << k
        lo.append(lo[-1] | (((lo[-1] >> s) | (hi[-1] << (32 - s))) & M32))
        hi.append(hi[-1] | (hi[-1] >> s))
    acc = np.zeros_like(Aa)
    got = 0
    for k in range(4, -1, -1):
        if W & (1 << k):
            s = 2 * got
            acc |= lo[k] if s == 0 else ((lo[k] >> s) | (hi[k] << (32 - s))) & M32
            got += 1 << k
    return acc


def _bit(words: np.ndarray, i: np.ndarray) -> np.ndarray:
    return (words[i >> 5] >> (i & 31)) & 1


def loose_model(plane: np.ndarray, lead: int, L: int, n_scan: int, W: int, stride: int,
                qbloom: np.ndarray, q_bits: int, hash_bits: int, pre: np.ndarray,
                pre_bits: int, pre_shift: int):
    """(words, c_total) of the loose kernel: ``plane`` uint8, tables uint64
    words. Per thread t: units 4t .. 4t+5; per unit r = 4t + k its phases,
    per group g = 4P t + P k + p its bits."""
    n_units = L // 8
    u = plane[lead // 2 : lead // 2 + 4 * (n_units + 2)].view("<u4").astype(np.uint64)
    c, d = _codes_of(u), _codes_of(u >> 2)
    r = np.arange(n_units)
    A, B = (c[r] | (c[r + 1] << 16)) & M32, c[r + 2]
    Aa, Ba = (d[r] | (d[r + 1] << 16)) & M32, d[r + 2]
    acc = _dirty_smear(Aa, Ba, W)
    lim = n_scan - 8 * r
    in_scan = np.where(lim >= 8, 0x5555,
                       np.where(lim <= 0, 0, 0x5555 & ((1 << (2 * np.clip(lim, 0, 8))) - 1)))
    clean = ~(acc | (acc >> 1)) & np.uint64(M32) & in_scan.astype(np.uint64)
    P = 8 // stride
    m2kb = (1 << (2 * min(W + stride - 1, 16))) - 1
    phases = 0x55 if stride == 4 else 0x5
    confirm = pre_bits < q_bits
    flags = np.zeros((n_units, P), dtype=bool)
    for p in range(P):
        sh = 2 * stride * p
        key = (((A >> sh) | (B << (32 - sh))) & M32 if sh else A) & m2kb
        kd = (((Aa >> sh) | (Ba << (32 - sh))) & M32 if sh else Aa) & m2kb
        if hash_bits:
            b = ((key * GOLD) & M32) >> (32 - hash_bits)
        else:
            b = key & ((1 << q_bits) - 1)
        valid = ((clean >> sh) & phases) != 0
        dirty = kd != 0
        hit = _bit(pre, (b >> pre_shift) & ((1 << pre_bits) - 1)) == 1
        if confirm:
            need = valid & ~dirty & hit
            hit = np.zeros_like(hit)
            hit[need] = _bit(qbloom, b[need]) == 1  # gathers only where needed
        flags[:, p] = valid & (dirty | hit)
    # 4 units (G = 4P bits) per thread, 32 / G threads per word
    G = 4 * P
    bits = (flags.reshape(-1, G).astype(np.uint64) << np.arange(G, dtype=np.uint64)).sum(1)
    t = np.arange(bits.size)
    words = np.zeros(n_units * P // 32, dtype=np.uint64)
    np.bitwise_or.at(words, (t * G) >> 5, bits << (G * (t & (32 // G - 1))).astype(np.uint64))
    return words, int(flags.sum())


def _u64(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32).astype(np.uint64)


def _nibble_plane(rng, W: int, keys: list, L: int, lead: int, dirty: float, all_dirty: bool):
    """Plane of nibbles: random A/C/G/T codes with the primer W-mers
    ``keys`` planted every ~100 bases, then a share ``dirty`` of codes
    4..15; exactly lead/2 + 4 (L/8 + 2) bytes."""
    n = lead + L + 16
    nib = rng.integers(0, 4, n).astype(np.uint8)
    for pos in range(lead, lead + L, 97):
        k = keys[rng.integers(len(keys))]
        nib[pos : pos + len(k)] = k[: n - pos]
    if all_dirty:
        nib[:] = rng.integers(4, 16, n)
    elif dirty:
        m = rng.random(n) < dirty
        nib[m] = rng.integers(4, 16, int(m.sum()))
    return (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)


LOOSE = [  # (W, STS count): stride 4 exact (folded at 8 and 11), stride 2 exact, mult-hash
    (3, 40), (8, 150), (11, 300), (12, 300), (13, 300), (14, 1200), (16, 1200)]


@pytest.mark.parametrize("W,n_sts", LOOSE)
def test_loose_model_equals_plain(tmp_path, W, n_sts):
    """The two-level test equals ``front_end_loose_plain`` on random tiles
    with planted keys, all-dirty tiles and tiles with dirty key spans, at
    n_scan 0, 1, cut mid-word and L, with the table's prefilter and with a
    2^12-bit one that sends many groups to the confirming gather."""
    _, meta, t = _table(_sts(tmp_path / "l.sts", W, n_sts), W)
    rng = np.random.default_rng(W)
    codes, hoff = t.p1_codes.numpy(), t.emeta.numpy()[:, 0]
    keys = [codes[i, hoff[i] : hoff[i] + W] for i in range(min(len(codes), 200))]
    L, lead, stride = 4096, 64, t.stride
    hash_bits = 0 if t.exact_group else t.q_bits
    windows = [t.loose_prefilter]
    if t.q_bits > 12:
        windows.append((fold_bits(t.qbloom, t.q_bits - 14, 12), 12, t.q_bits - 14))
    flagged = 0
    for dirty, all_dirty in ((0.0, False), (0.03, False), (0.0, True)):
        plane = _nibble_plane(rng, W, keys, L, lead, dirty, all_dirty)
        for n_scan in (0, 1, L // 2 + 13, L):
            want_w, want_c = front_end_loose_plain(
                torch.from_numpy(plane), t.qbloom, t.q_bits, W, lead, L, n_scan, stride,
                hash_bits)
            for pre, pre_bits, pre_shift in windows:
                got_w, got_c = loose_model(plane, lead, L, n_scan, W, stride, _u64(t.qbloom),
                                           t.q_bits, hash_bits, _u64(pre), pre_bits, pre_shift)
                np.testing.assert_array_equal(got_w, _u64(want_w))
                assert got_c == int(want_c)
            flagged += int(want_c)
            if all_dirty:
                assert int(want_c) == 0  # every phase dirty: nothing valid
    assert flagged > 0


# ---------------------------------------------------------------- raw kernel
LUT = np.asarray(scode(torch.arange(256)).numpy(), dtype=np.uint64)
LUT = np.where(LUT == AMBIG, np.uint64(1 << 16), LUT)  # the kernel's code table


def _code16(b16: np.ndarray):
    """(cw, amb) of [n, 16] bytes: csrc/front_end.cu ``code16``."""
    v = LUT[b16]
    sh = (2 * (np.arange(16) & 7)).astype(np.uint64)
    acc0 = (v[:, :8] << sh[:8]).sum(1) & M32
    acc1 = (v[:, 8:] << sh[8:]).sum(1) & M32
    cw = (acc0 & 0xFFFF) | ((acc1 << 16) & M32)
    m = ((acc0 >> 16) | (acc1 & 0xFFFF0000)) & 0x55555555
    m = (m | (m >> 1)) & 0x33333333
    m = (m | (m >> 2)) & 0x0F0F0F0F
    m = (m | (m >> 4)) & 0x00FF00FF
    return cw, (m | (m >> 8)) & 0xFFFF


def _smear_bits(x, n: int):
    s = [x]
    for k in range(1, 5):
        s.append(s[-1] | (s[-1] >> (1 << (k - 1))))
    acc, got = np.zeros_like(x), 0
    for k in range(4, -1, -1):
        if n & (1 << k):
            acc |= s[k] >> got
            got += 1 << k
    return acc


def raw_model(plane: np.ndarray, lead: int, L: int, n_scan: int, W: int, bloom: np.ndarray,
              bloom_bits: int, pre: np.ndarray, pre_bits: int):
    """(words, c_total) of the raw kernel; ``plane`` holds exactly W - 1
    bytes past the tile, so a read past them would raise here."""
    n_thr = L // 16
    own = plane[lead : lead + L].reshape(n_thr, 16)
    cw, amb = _code16(own)
    tail = np.zeros(16, dtype=np.uint8)
    tail[: W - 1] = plane[lead + L : lead + L + W - 1]
    ncw, namb = _code16(np.vstack([own[1:], tail]))  # the next thread's 16 bytes
    t = np.arange(n_thr)
    lim = n_scan - 16 * t
    in_scan = np.where(lim >= 16, 0xFFFF, np.where(lim <= 0, 0, (1 << np.clip(lim, 0, 16)) - 1))
    clean = ~_smear_bits(amb | (namb << 16), W) & in_scan.astype(np.uint64)
    wmask = (1 << (2 * W)) - 1
    shift = 2 * W - bloom_bits
    hit = np.zeros(n_thr, dtype=np.uint64)
    bk = []
    for j in range(16):
        h = (((ncw << 32) | cw) >> (2 * j)) & M32 & wmask
        bk.append(h >> shift)
        hit |= _bit(pre, bk[-1] & ((1 << pre_bits) - 1)) << j
    hit &= clean
    if pre_bits < bloom_bits:
        full = np.zeros_like(hit)
        for j in range(16):
            need = ((hit >> j) & 1) == 1
            full[need] |= _bit(bloom, bk[j][need]) << j
        hit = full
    word = hit << (16 * (t & 1)).astype(np.uint64)
    words = word[0::2] | word[1::2]  # the two threads of a word
    return words, int(sum(bin(int(h)).count("1") for h in hit))


def _raw_plane(rng, primers: list, L: int, lead: int, W: int, junk: float) -> np.ndarray:
    """RNA / DNA letters in both cases with primer-1 texts planted every ~90
    bytes, junk bytes at a share ``junk``, and ambiguous bytes at the first
    and last byte of some windows; exactly W - 1 bytes past the tile."""
    n = lead + L + W - 1
    b = rng.choice(np.frombuffer(b"ACGUacguTt", dtype=np.uint8), n)
    for pos in range(lead, lead + L, 89):
        p = primers[rng.integers(len(primers))].encode()[: n - pos]
        b[pos : pos + len(p)] = np.frombuffer(p, dtype=np.uint8)
    m = rng.random(n) < junk
    b[m] = rng.choice(np.frombuffer(b"N-*.0Z\xff\xe9\x00R", dtype=np.uint8), int(m.sum()))
    for pos in range(lead, lead + L - W, 301):  # a window's first and last byte
        b[pos] = ord("N")
        b[min(pos + W + 7, n - 1)] = ord("-")
    b[lead] = b[lead + L - 1] = ord("*")  # the tile's own ends
    return b


@pytest.mark.parametrize("W", [3, 7, 11, 12, 13, 16])
def test_raw_model_equals_plain(tmp_path, W):
    """The rolling W-mer (16 positions a thread, the next 16 bytes' codes,
    W - 1 bytes past the tile) and the two-level bloom test equal
    ``front_end_raw_plain``, with the table's prefilter and a 2^10-bit one,
    on clean and junk-laden planes at n_scan 0, 1, cut mid-word and L."""
    path = _sts(tmp_path / "r.sts", 3 + W, 200)
    _, _, t = _table(path, W)
    primers = [ln.split("\t")[1].replace("T", "U") for ln in open(path)]
    rng = np.random.default_rng(100 + W)
    L, lead = 4096, 96
    windows = [t.raw_prefilter[:2]]
    if t.bloom_bits > 10:
        windows.append((fold_bits(t.bloom, 0, 10), 10))
    flagged = 0
    for junk in (0.0, 0.02, 1.0):
        plane = _raw_plane(rng, primers, L, lead, W, junk)
        for n_scan in (0, 1, L // 2 + 17, L):
            want_w, want_c = front_end_raw_plain(torch.from_numpy(plane), t.bloom, t.bloom_bits,
                                                 W, lead, L, n_scan)
            for pre, pre_bits in windows:
                got_w, got_c = raw_model(plane, lead, L, n_scan, W, _u64(t.bloom),
                                         t.bloom_bits, _u64(pre), pre_bits)
                np.testing.assert_array_equal(got_w, _u64(want_w))
                assert got_c == int(want_c)
            flagged += int(want_c)
            if junk == 1.0:
                assert int(want_c) == 0
    assert flagged > 0
