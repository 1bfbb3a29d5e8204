"""A numpy model of ``csrc/verify_p1.cu``'s word-wide primer-1 compare (-I 0
on a nibble plane) against ``verify_p1_plain``.

The kernel compares 16 bases per step: the plane read as little-endian
64-bit words from the 8-byte boundary at or below its start, the window
funnel-shifted out of two words, XOR the primer codes packed into nibbles
from 8-byte loads of the ``p1_codes`` row (a code >= 16 sets a nibble of
its own word, since it equals no genome nibble), an OR-fold to one bit per
mismatching nibble, a popcount under the length mask, and masks for the
last-X protection and for the positions outside the plane (which
mismatch). ``verify_words_model`` is that arithmetic, step for step, in
Python integers; the card tests hold the kernel to the plain version on
the same edges.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from merpcr_tpu_torch.ops.units import nibbles_at, records_at
from merpcr_tpu_torch.ops.verify_p1 import verify_p1_plain

M64 = (1 << 64) - 1
ONES = 0x1111111111111111  # bit 0 of each nibble


def nib_range(a: int, b: int) -> int:
    """Bit 0 of nibbles a .. b-1, clamped to 0 .. 16."""
    def below(n):
        return 0 if n <= 0 else ONES if n >= 16 else ONES & ((1 << (4 * n)) - 1)
    return below(b) & ~below(a) & M64


def pack_nibbles(b8: int) -> int:
    """Low nibbles of 8 bytes (a little-endian int) -> 32 bits."""
    v = b8 & 0x0F0F0F0F0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF0000FFFF
    return (v | (v >> 16)) & 0xFFFFFFFF


def primer_word(row: bytes, c: int, p1_max: int) -> tuple:
    """(code & 15, code >> 4) nibbles of primer bases 16c .. 16c+15."""
    b0 = int.from_bytes(row[16 * c : 16 * c + 8], "little")
    b1 = int.from_bytes(row[16 * c + 8 : 16 * c + 16], "little") if 16 * c + 8 < p1_max else 0
    lo = pack_nibbles(b0) | (pack_nibbles(b1) << 32)
    hi = pack_nibbles(b0 >> 4) | (pack_nibbles(b1 >> 4) << 32)
    return lo, hi


def fold(x: int) -> int:
    """One bit per nonzero nibble."""
    x |= x >> 2
    x |= x >> 1
    return x & ONES


def floor16(a: int) -> int:
    """The kernel's floor(a / 16) for a of either sign."""
    return a >> 4 if a >= 0 else -((15 - a) >> 4)


class Plane:
    """A tile plane of ``n_bytes`` bytes placed ``mis`` bytes past an
    8-byte boundary inside a larger buffer, as the kernel sees it: 64-bit
    words from that boundary, bytes outside the plane random."""

    def __init__(self, tile: np.ndarray, mis: int, rng):
        pad = (-(mis + tile.size)) % 8 + 8
        buf = np.concatenate([rng.integers(0, 256, mis, dtype=np.uint8), tile,
                              rng.integers(0, 256, pad, dtype=np.uint8)])
        self.words = [int(w) for w in buf.view("<u8")]
        self.mis, self.n_pos = mis, 2 * tile.size

    def word(self, q: int) -> int:
        q_max = (self.n_pos - 1 + 2 * self.mis) >> 4  # last word in the plane
        return 0 if q < 0 or q > q_max else self.words[q]

    def window(self, s: int) -> int:
        """Nibbles of tile positions s .. s+15 (funnel shift)."""
        a = s + 2 * self.mis
        q = floor16(a)
        r = a - 16 * q
        w0 = self.word(q)
        return ((w0 >> (4 * r)) | (self.word(q + 1) << (64 - 4 * r))) & M64 if r else w0


def window_ok(plane: Plane, kl: int, l1: int, row: bytes, p1_max: int, nmm: int,
              three_prime: int) -> bool:
    """``p1_words_ok``: the window of l1 bases at tile position kl against
    primer row ``row`` within the budget and the protection."""
    mism = 0
    for c in range(-(-l1 // 16)):
        s = kl + 16 * c
        lo, hi = primer_word(row, c, p1_max)
        out = ONES & ~nib_range(-s, plane.n_pos - s)  # off the plane
        mm = (fold((plane.window(s) ^ lo) | hi) | out) & nib_range(0, l1 - 16 * c)
        if mm & nib_range(l1 - three_prime - 16 * c, l1 - 16 * c):
            return False
        mism += bin(mm).count("1")
        if mism > nmm:
            return False
    return True


def verify_words_model(plane: Plane, entry, ppos, emeta, p1_codes, tile_start, rmeta,
                       recmap, lead, nmm, three_prime) -> np.ndarray:
    """a_idx of the kernel's -I 0 nibble-plane path."""
    gpos = torch.from_numpy(tile_start + ppos.astype(np.int64))
    _, rstart, rlen = records_at(torch.from_numpy(rmeta), recmap, gpos)
    p1_max = p1_codes.shape[1]
    out = []
    for i, (e, pos) in enumerate(zip(entry.tolist(), ppos.tolist())):
        hoff, l1 = int(emeta[e, 0]), int(emeta[e, 1])
        kg = tile_start + pos - hoff - int(rstart[i])
        if kg < 0 or kg + l1 > int(rlen[i]):
            continue
        if window_ok(plane, pos - hoff + lead, l1, p1_codes[e].tobytes(), p1_max, nmm,
                     three_prime):
            out.append(i)
    return np.asarray(out, dtype=np.int32)


# ---------------------------------------------------------------- pieces
def test_floor16_is_floor_division():
    for a in range(-100, 100):
        assert floor16(a) == a // 16


def test_fold_marks_exactly_the_unequal_nibbles():
    """Every genome nibble against every primer code, 16 and 17 included."""
    for code in range(18):
        g = sum(j << (4 * j) for j in range(16))  # nibble j holds j
        row = bytes([code] * 16)
        lo, hi = primer_word(row, 0, 16)
        got = fold((g ^ lo) | hi)
        want = sum(1 << (4 * j) for j in range(16) if j != code)
        assert got == want, code


@pytest.mark.parametrize("p1_max", [16, 24, 32, 40])
def test_primer_words_unpack_to_p1_codes(p1_max):
    """Packed rows give back every code of every entry, P1MAX padding (code
    17, the code of byte 0) and U (16) included."""
    rng = np.random.default_rng(p1_max)
    codes = rng.integers(0, 4, (50, p1_max)).astype(np.uint8)
    codes[rng.random(codes.shape) < 0.1] = 16
    lens = rng.integers(1, p1_max + 1, 50)
    for e, n in enumerate(lens):
        codes[e, n:] = 17
    for e in range(50):
        row = codes[e].tobytes()
        got = []
        for c in range(-(-p1_max // 16)):
            lo, hi = primer_word(row, c, p1_max)
            got += [((lo >> (4 * j)) & 15) | (((hi >> (4 * j)) & 15) << 4) for j in range(16)]
        assert got[:p1_max] == codes[e].tolist()
        assert not any(got[p1_max:])  # past the row: nothing read


@pytest.mark.parametrize("mis", range(8))
def test_funnel_shift_reads_the_window(mis):
    """The window's in-plane nibbles are the plane's, at every offset of
    the plane from a word boundary and every shift, across both edges."""
    rng = np.random.default_rng(mis)
    tile = rng.integers(0, 256, 61, dtype=np.uint8)  # an odd size: 122 positions
    plane = Plane(tile, mis, rng)
    t = torch.from_numpy(tile)
    for s in range(-40, plane.n_pos + 20):
        g = plane.window(s)
        pos = torch.arange(s, s + 16)
        want = nibbles_at(t, pos).tolist()
        inside = nib_range(-s, plane.n_pos - s)
        for j in range(16):
            if inside >> (4 * j) & 1:
                assert (g >> (4 * j)) & 15 == want[j], (s, j)
            else:
                assert want[j] == 0xFF


def test_masks():
    assert nib_range(0, 16) == ONES and nib_range(3, 3) == 0 and nib_range(5, 2) == 0
    assert nib_range(-4, 2) == 0x11 and nib_range(14, 99) == 0x11 << 56
    assert nib_range(-20, -1) == 0 and nib_range(16, 30) == 0


# ---------------------------------------------------------------- against the plain version
def _case(seed: int, lens, p1_max: int, n_bytes: int = 1024, n_pairs: int = 300):
    """A random nibble plane and a table with primers of ``lens`` bases,
    pairs around planted copies (0-3 substitutions, some windows across the
    plane's edges, some primer codes U or beyond the alphabet)."""
    rng = np.random.default_rng(seed)
    n_pos = 2 * n_bytes
    nib = rng.integers(0, 4, n_pos).astype(np.uint8)
    amb = rng.random(n_pos) < 0.02  # ambiguity letters
    nib[amb] = rng.integers(4, 16, int(amb.sum()))
    E = 12
    codes = np.full((E, p1_max), 17, dtype=np.uint8)
    emeta = np.zeros((E, 8), dtype=np.int32)
    for e in range(E):
        n = int(lens[e % len(lens)])
        codes[e, :n] = rng.integers(0, 4, n)
        if e % 5 == 4:
            codes[e, int(rng.integers(0, n))] = 16 + int(rng.integers(0, 2))
        emeta[e, :2] = (int(rng.integers(0, n)), n)
    lead = 64
    entry = rng.integers(0, E, n_pairs).astype(np.int32)
    ppos = np.zeros(n_pairs, dtype=np.int32)
    for i, e in enumerate(entry):
        hoff, l1 = int(emeta[e, 0]), int(emeta[e, 1])
        kl = int(rng.integers(-l1 - 8, n_pos + 8))  # crosses both edges
        ppos[i] = kl - lead + hoff
        for j in range(l1):
            if 0 <= kl + j < n_pos and codes[e, j] < 16:
                nib[kl + j] = codes[e, j]
        for j in rng.integers(0, l1, int(rng.integers(0, 4))):
            if 0 <= kl + j < n_pos:
                nib[kl + j] = (nib[kl + j] + 1) & 3
    tile = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    return rng, tile, entry, ppos, emeta, codes, lead


CASES = {  # primer lengths, P1MAX
    "16": ((16,), 16), "17": ((17,), 24), "32": ((32,), 32), "33": ((33,), 40),
    "mixed": ((5, 11, 16, 17, 23, 32), 32),
}


@pytest.mark.parametrize("mis", [0, 3, 5])
@pytest.mark.parametrize("case", sorted(CASES))
def test_word_model_equals_verify_p1_plain(case, mis):
    """The model against ``verify_p1_plain`` at -X 0, 1, 3, l1 and past l1
    and -N 0 to 3, on one record that holds the whole tile and more (so
    windows outside the plane are in bounds and mismatch there)."""
    lens, p1_max = CASES[case]
    rng, tile, entry, ppos, emeta, codes, lead = _case(10 * sorted(CASES).index(case) + mis, lens,
                                                        p1_max)
    plane = Plane(tile, mis, rng)
    tile_start = 10_000
    rmeta = np.array([[0, 1 << 20]], dtype=np.int32)
    args = [torch.from_numpy(a) for a in (tile, entry, ppos, emeta, codes)]
    seen = set()
    for nmm in range(4):
        for x in (0, 1, 3, max(lens), max(lens) + 7):
            want = verify_p1_plain(*args, None, tile_start, torch.from_numpy(rmeta), None,
                                   lead, nmm, x).numpy()
            got = verify_words_model(plane, entry, ppos, emeta, codes, tile_start, rmeta,
                                     None, lead, nmm, x)
            np.testing.assert_array_equal(got, want, err_msg=f"N={nmm} X={x}")
            seen.add(len(want))
    assert max(seen) > 0 and min(seen) < len(entry)


def test_word_model_equals_verify_p1_plain_on_a_stream_plane():
    """Records laid end to end with a recmap (K14): the bounds test drops
    windows that leave their record, the compare keeps the rest."""
    rng, tile, entry, ppos, emeta, codes, lead = _case(77, (11, 18, 25), 32)
    plane = Plane(tile, 0, rng)
    tile_start = 4096
    starts = np.arange(0, 2 * tile.size + 8192, 512)
    rmeta = np.stack([starts, np.full_like(starts, 500)], axis=1).astype(np.int32)
    recmap = torch.from_numpy(np.repeat(np.arange(len(starts), dtype=np.int32), 64))
    args = [torch.from_numpy(a) for a in (tile, entry, ppos, emeta, codes)]
    for nmm, x in ((0, 1), (2, 0), (3, 5)):
        want = verify_p1_plain(*args, None, tile_start, torch.from_numpy(rmeta), recmap,
                               lead, nmm, x).numpy()
        got = verify_words_model(plane, entry, ppos, emeta, codes, tile_start, rmeta,
                                 recmap, lead, nmm, x)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("l1", [16, 17, 33])
def test_positions_off_the_plane_mismatch(l1):
    """All-A primers on an all-A plane, windows hanging 0 .. l1 bases off
    either edge: the words past the plane read 0 (= A) and the padding
    bytes A too, so only the out-of-plane mask makes those bases mismatch;
    a window passes iff its off-plane bases are within the budget and clear
    of the protected 3' end."""
    rng = np.random.default_rng(l1)
    tile = np.zeros(64, dtype=np.uint8)  # 128 positions of A
    plane = Plane(tile, 3, rng)
    plane.words = [0] * len(plane.words)  # A beyond the edges too
    codes = np.full((1, 40), 17, dtype=np.uint8)
    codes[0, :l1] = 0
    emeta = np.zeros((1, 8), dtype=np.int32)
    emeta[0, :2] = (0, l1)
    lead = 0
    kl = np.concatenate([np.arange(-l1, 1), np.arange(128 - l1, 129)])
    entry, ppos = np.zeros(len(kl), dtype=np.int32), kl.astype(np.int32)
    rmeta = np.array([[0, 1 << 20]], dtype=np.int32)
    args = [torch.from_numpy(a) for a in (tile, entry, ppos, emeta, codes)]
    for nmm in range(4):
        for x in (0, 1, l1):
            want = verify_p1_plain(*args, None, 1000, torch.from_numpy(rmeta), None,
                                   lead, nmm, x).numpy()
            got = verify_words_model(plane, entry, ppos, emeta, codes, 1000, rmeta, None,
                                     lead, nmm, x)
            np.testing.assert_array_equal(got, want, err_msg=f"N={nmm} X={x}")
            assert 0 < len(want) < len(kl)
