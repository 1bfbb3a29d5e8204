"""A numpy model of ``csrc/margin_p2.cu`` (one block per anchor) against
``margin_p2_plain``.

Per anchor the kernel works out, once, its record, clamps and bounds as
one range of live offsets d = -lo .. hi (d = 0 only when the product holds
both primers), maps a live index to its rank in rank order, stages the
primer-2 sites of that range as the plane's 64-bit words (a byte window
on a raw plane) and compares each live rank's site 16 bases at a time
(``csrc/nibwords.cuh``: funnel shift, XOR the packed primer, OR-fold,
popcount under the length mask, the first-X protection and the positions
off the plane as masks). ``margin_words_model`` is that arithmetic, step
for step, in Python integers, reading the plane only through the staged
words; the card tests hold the kernel to the plain version on the same
edges.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from merpcr_tpu_torch.ops.encoding import iupac_exp_masks
from merpcr_tpu_torch.ops.margin_p2 import margin_p2_plain, rank_offsets
from merpcr_tpu_torch.ops.units import base_matches, records_at

from .test_torch_verify_words import ONES, Plane, floor16, fold, nib_range, primer_word


def window_words_ok(word, mis: int, n_pos: int, s: int, length: int, row: bytes,
                    p_max: int, pa: int, pb: int, nmm: int) -> bool:
    """``mp::window_words_ok``: the window of ``length`` bases at tile
    position s against primer row ``row``, within nmm mismatches and none
    among primer bases pa .. pb-1; ``word(q)`` is the plane's 64-bit word q."""
    mism = 0
    for c in range(-(-length // 16)):
        sc = s + 16 * c
        a = sc + 2 * mis
        q = floor16(a)
        r = a - 16 * q
        w0 = word(q)
        g = ((w0 >> (4 * r)) | (word(q + 1) << (64 - 4 * r))) & ((1 << 64) - 1) if r else w0
        lo, hi = primer_word(row, c, p_max)
        out = ONES & ~nib_range(-sc, n_pos - sc)  # off the plane
        mm = (fold((g ^ lo) | hi) | out) & nib_range(0, length - 16 * c)
        if mm & nib_range(pa - 16 * c, pb - 16 * c):
            return False
        mism += bin(mm).count("1")
        if mism > nmm:
            return False
    return True


def anchor_of(hoff, l1, l2, exp0, ak, arl, margin):
    """``anchor_of``: (lo, hi, d0) of the live offsets d = -lo .. -1, 0 when
    d0, 1 .. hi."""
    room = arl - (ak + l1) >= l2
    actual = arl - ak
    clamped = exp0 > actual
    exp = actual if clamped else exp0
    hi = min(margin, arl - ak - exp) if room and not clamped else 0
    lo = max(min(margin, exp - l1 - l2), 0) if room else 0
    return lo, hi, room and exp >= l1 + l2, exp


def rank_of(j: int, lo: int, hi: int, d0: bool) -> tuple:
    """``rank_of``: live index j -> (rank, d)."""
    if d0:
        if j == 0:
            return 0, 0
        j -= 1
    both = min(lo, hi)
    if j < 2 * both:
        r = j + 1
        dmag = (r + 1) // 2
        return r, -dmag if r & 1 else dmag
    k = both + 1 + (j - 2 * both)
    return (2 * k - 1, -k) if lo > hi else (2 * k, k)


def win_words(margin: int, p2_max: int) -> int:
    """The C entry's n_win: 64-bit words of window in shared memory."""
    return (2 * margin + p2_max) // 16 + 4


def margin_words_model(plane: Plane, a_idx, entry, ppos, emeta, p2_codes, tile_start,
                       rmeta, recmap, lead, margin, nmm, three_prime, stats=None):
    """Rows int32[hit_total, 6] of the kernel's -I 0 nibble-plane path."""
    p2_max = p2_codes.shape[1]
    gpos = torch.from_numpy(tile_start + ppos[a_idx].astype(np.int64))
    arec, rstart, rlen = (t.tolist() for t in records_at(torch.from_numpy(rmeta), recmap, gpos))
    rows = []
    for a, pair in enumerate(a_idx.tolist()):
        e = int(entry[pair])
        hoff, l1, l2, exp0 = (int(v) for v in emeta[e, :4])
        ak = tile_start + int(ppos[pair]) - hoff - rstart[a]
        lo, hi, d0, exp = anchor_of(hoff, l1, l2, exp0, ak, rlen[a], margin)
        n_live = int(d0) + lo + hi
        if not n_live:
            continue
        base = ak + exp - l2
        tbase = base + rstart[a] - tile_start + lead
        dmin = -lo if lo else (0 if d0 else 1)
        dmax = hi if hi else (0 if d0 else -1)
        w0, wlen = tbase + dmin, dmax - dmin + l2
        q0 = floor16(w0 + 2 * plane.mis)
        q1 = floor16(w0 + wlen - 1 + 2 * plane.mis) + 1
        assert q1 - q0 + 1 <= win_words(margin, p2_max)
        staged = [plane.word(q) for q in range(q0, q1 + 1)]  # the coalesced loads

        def word(q, q0=q0, staged=staged):
            assert q0 <= q < q0 + len(staged), "a read outside the staged window"
            return staged[q - q0]

        if stats is not None:
            stats["left"] += w0 < 0
            stats["right"] += w0 + wlen > plane.n_pos
            stats["clamped"] += hi == 0 and exp0 > rlen[a] - ak
            stats["live"] = max(stats.get("live", 0), n_live)
        row = p2_codes[e].tobytes()
        for j in range(n_live):
            r, d = rank_of(j, lo, hi, d0)
            if window_words_ok(word, plane.mis, plane.n_pos, tbase + d, l2, row, p2_max,
                               0, three_prime, nmm):
                rows.append((ak, base + d + l2 - 1, e, pair, r, arec[a]))
    return np.asarray(rows, dtype=np.int32).reshape(-1, 6)


# ---------------------------------------------------------------- pieces
def test_live_ranks_are_the_plain_mask_in_rank_order():
    """For anchors at every clamp (near the record's start and end, products
    shorter than both primers, margins 0 to 40), ``rank_of`` over the live
    indices lists exactly the ranks that the plain version's bounds and rank
    mask let through, ascending."""
    rng = np.random.default_rng(0)
    for margin in (0, 1, 2, 7, 40):
        d = rank_offsets(margin).numpy()
        for _ in range(400):
            l1, l2 = (int(v) for v in rng.integers(1, 30, 2))
            hoff = int(rng.integers(0, l1))
            exp0 = int(rng.integers(0, l1 + l2 + 2 * margin + 20))
            arl = int(rng.integers(1, 400))
            ak = int(rng.integers(-5, arl + 5))
            lo, hi, d0, exp = anchor_of(hoff, l1, l2, exp0, ak, arl, margin)
            room = arl - (ak + l1) >= l2
            clamped = exp0 > arl - ak
            phi = 0 if clamped else min(margin, arl - ak - exp)
            plo = max(min(margin, exp - l1 - l2), 0)
            rmask = (d == 0) | np.where(d < 0, -d <= plo, d <= phi)
            p2 = ak + exp - l2 + d
            fits = (p2 + l2 <= arl) & ((d > 0) | (p2 >= ak + l1))
            want = np.flatnonzero(room & rmask & fits).tolist()
            got = [rank_of(j, lo, hi, d0) for j in range(int(d0) + lo + hi)]
            assert [r for r, _ in got] == want, (margin, l1, l2, exp0, arl, ak)
            assert all(d[r] == off for r, off in got)


@pytest.mark.parametrize("l2", [1, 11, 15, 16, 17, 25, 32, 33])
def test_word_compare_counts_mismatches_and_protects_the_first_bases(l2):
    """One window, every mismatch pattern of up to 3 bases: the compare
    passes iff the count is within -N and none lies in the first X bases."""
    rng = np.random.default_rng(l2)
    p2_max = -(-max(l2, 16) // 8) * 8
    codes = np.full(p2_max, 17, dtype=np.uint8)
    codes[:l2] = rng.integers(0, 4, l2)
    for trial in range(60):
        k = int(rng.integers(0, 4))
        where = sorted(set(rng.integers(0, l2, k).tolist()))
        nib = np.concatenate([codes[:l2], rng.integers(0, 4, 40)]).astype(np.uint8)
        for i in where:
            nib[i] = (nib[i] + 1) & 3
        tile = np.zeros(64, dtype=np.uint8)
        full = np.zeros(128, dtype=np.uint8)
        full[: nib.size] = nib
        tile[:] = full[0::2] | (full[1::2] << 4)
        plane = Plane(tile, trial % 8, rng)
        for nmm in range(4):
            for x in (0, 1, 3, l2, l2 + 5):
                want = len(where) <= nmm and not any(i < x for i in where)
                got = window_words_ok(plane.word, plane.mis, plane.n_pos, 0, l2,
                                      codes.tobytes(), p2_max, 0, x, nmm)
                assert got == want, (where, nmm, x)


def test_codes_ok_masks_equal_the_expansion_set_test():
    """-I 1 on a nibble plane: the kernel's per-base mask (bit n set iff
    genome code n meets the primer letter's expansion set, made once per
    block from ``kExpNib``) agrees with ``base_matches`` for every primer
    letter, every genome code and a code off the plane."""
    exp_nib, exp_primer = iupac_exp_masks()
    px = exp_primer.astype(np.int64)
    codes = torch.zeros((px.size, 1), dtype=torch.uint8)
    exp = torch.from_numpy(px.astype(np.uint32).view(np.int32)).reshape(-1, 1)
    for p in range(px.size):
        ok = sum(int((int(exp_nib[n]) & int(px[p])) != 0) << n for n in range(16))
        nib = torch.tensor([list(range(16)) + [0xFF]])
        want = base_matches(nib, torch.tensor([p]), codes, exp)[0].tolist()
        assert [bool((ok >> n) & 1) if n < 16 else False for n in nib[0].tolist()] == want


# ---------------------------------------------------------------- against the plain version
def _case(seed: int, lens2, p2_max: int, margin: int, n_anch: int, edges=(),
          n_bytes: int = 1024):
    """A random nibble plane (2 % ambiguity letters) and a table whose
    primer-2 copies (0-3 substitutions) are planted around each anchor's
    expected product end, within the margin; anchors whose windows cross
    both plane edges and the tile positions ``edges``, products shorter than
    both primers, primer codes U or beyond the alphabet."""
    rng = np.random.default_rng(seed)
    n_pos = 2 * n_bytes
    nib = rng.integers(0, 4, n_pos).astype(np.uint8)
    amb = rng.random(n_pos) < 0.02
    nib[amb] = rng.integers(4, 16, int(amb.sum()))
    E = 12
    codes = np.full((E, p2_max), 17, dtype=np.uint8)
    emeta = np.zeros((E, 8), dtype=np.int32)
    for e in range(E):
        l2 = int(lens2[e % len(lens2)])
        l1 = int(rng.integers(8, 26))
        codes[e, :l2] = rng.integers(0, 4, l2)
        if e % 5 == 4:
            codes[e, int(rng.integers(0, l2))] = 16 + int(rng.integers(0, 2))
        exp0 = int(rng.integers(l1 + l2 - 6, l1 + l2 + 2 * margin + 80))
        emeta[e, :4] = (int(rng.integers(0, l1)), l1, l2, exp0)
    lead = 64
    entry = rng.integers(0, E, n_anch).astype(np.int32)
    ppos = np.zeros(n_anch, dtype=np.int32)
    for i, e in enumerate(entry):
        hoff, l1, l2, exp0 = (int(v) for v in emeta[e, :4])
        edge = (0, n_pos, *edges)[i % (2 + len(edges))]  # half the windows on an edge
        t_exp = int(rng.integers(edge - l2 - margin - 4, edge + 4)) if i % 4 < 2 else \
            int(rng.integers(0, n_pos))
        ka = t_exp - exp0 + l2  # tile position of the anchor
        ppos[i] = ka - lead + hoff
        t2 = ka + exp0 - l2 + int(rng.integers(-margin, margin + 1))
        for j in range(l2):
            if 0 <= t2 + j < n_pos and codes[e, j] < 16:
                nib[t2 + j] = codes[e, j]
        for j in rng.integers(0, l2, int(rng.integers(0, 4))):
            if 0 <= t2 + j < n_pos:
                nib[t2 + j] = (nib[t2 + j] + 1) & 3
    tile = (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
    return rng, tile, entry, ppos, emeta, codes, lead


CASES = {  # primer-2 lengths, P2MAX
    "11": ((11,), 16), "16": ((16,), 16), "17": ((17,), 24), "32": ((32,), 32),
    "mixed": ((5, 11, 16, 17, 23, 33), 40),
}


def _check(case, margin, mis, rmeta, recmap, tile_start, seed, edges=()):
    """The model against the plain version at -N 0 to 3 and -X 0, 1, 3, l2
    and past l2 (eight pairings); anchors fewer at larger margins."""
    lens, p2_max = CASES[case]
    rng, tile, entry, ppos, emeta, codes, lead = _case(seed, lens, p2_max, margin,
                                                       max(24, 3200 // (margin + 20)), edges)
    plane = Plane(tile, mis, rng)
    a_idx = np.arange(len(entry), dtype=np.int32)
    args = [torch.from_numpy(a) for a in (tile, a_idx, entry, ppos, emeta, codes)]
    stats = {"left": 0, "right": 0, "clamped": 0}
    hits = []
    top = max(lens)
    for nmm, x in ((0, 0), (0, 1), (1, 3), (1, top), (2, 0), (2, top + 7), (3, 1), (3, 3)):
        want = margin_p2_plain(*args, None, tile_start, torch.from_numpy(rmeta), recmap,
                               lead, margin, nmm, x).numpy()
        got = margin_words_model(plane, a_idx, entry, ppos, emeta, codes, tile_start,
                                 rmeta, recmap, lead, margin, nmm, x, stats)
        np.testing.assert_array_equal(got, want, err_msg=f"N={nmm} X={x}")
        hits.append(len(want))
    return stats, hits


@pytest.mark.parametrize("margin", [0, 5, 50, 130])
@pytest.mark.parametrize("mis", [0, 3])
@pytest.mark.parametrize("case", sorted(CASES))
def test_margin_model_equals_plain(case, mis, margin):
    """The model against ``margin_p2_plain`` on one record that holds the tile and more (windows
    off the plane are in the record and mismatch there), from a plane on
    and off an 8-byte boundary."""
    seed = 10 * sorted(CASES).index(case) + mis + margin
    rmeta = np.array([[0, 1 << 20]], dtype=np.int32)
    stats, hits = _check(case, margin, mis, rmeta, None, 10_000, seed)
    assert max(hits) > 0
    assert stats["left"] and stats["right"], stats  # windows across both edges


@pytest.mark.parametrize("margin", [5, 50])
def test_margin_model_clips_windows_at_the_record_end(margin):
    """A record that ends inside the plane: anchors near its end are clamped
    (exp = what is left, no d > 0) or have no room, and no window passes the
    record's end."""
    tile_start = 10_000
    end = 2 * 1024 - 300  # the record's end as a tile position (lead 64)
    rmeta = np.array([[0, tile_start + end - 64]], dtype=np.int32)
    stats, hits = _check("mixed", margin, 5, rmeta, None, tile_start, 90 + margin, (end,))
    assert stats["clamped"] > 0 and max(hits) > 0


@pytest.mark.parametrize("margin", [3, 50])
def test_margin_model_on_a_stream_plane(margin):
    """Records laid end to end with a recmap (K14): every clamp and bound in
    the anchor's record, which rows name."""
    tile_start = 4096
    starts = np.arange(0, 2 * 2048 + 8192, 512)
    rmeta = np.stack([starts, np.full_like(starts, 500)], axis=1).astype(np.int32)
    recmap = torch.from_numpy(np.repeat(np.arange(len(starts), dtype=np.int32), 64))
    ends = tuple(range(512 + 500 - tile_start + 64, 4096, 512))  # record ends in the tile
    stats, hits = _check("mixed", margin, 0, rmeta, recmap, tile_start, 70 + margin, ends)
    assert stats["clamped"] > 0 and max(hits) > 0


@pytest.mark.parametrize("margin", [600, 2000])
def test_margin_model_at_large_margins(margin):
    """Margins whose live ranks take several strips of 1,024 threads: one
    window of up to 2M + len_p2 positions holds every site they read."""
    rmeta = np.array([[0, 1 << 20]], dtype=np.int32)
    stats, hits = _check("mixed", margin, 3, rmeta, None, 10_000, 50 + margin)
    assert stats["live"] > 1024 and max(hits) > 0
