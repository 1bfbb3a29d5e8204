"""STS table compiler: searchable entries -> host arrays -> device tensors.

The reference keeps a Python dict ``hash -> [STSRecord]`` (engine.py:324-329)
that is pickled into every worker process. The device layout is a CSR over
W-mer hashes, in struct-of-arrays form, held in device memory:

* ``bloom``   — exact bucket-occupancy bitmask over the (possibly truncated)
                top ``bloom_bits`` bits of the hash. This is the ONLY table
                the O(sequence) scan stage touches: 512 KB for W=11, so it
                stays cache/VMEM resident instead of a 16+ MB counts table.
                For 2W > bloom_bits it is a prefix filter whose false
                positives are removed by the exact stage below.
* ``uhash``   — sorted unique hashes (uint32), ``ustart`` CSR offsets; the
                compacted (rare) candidate positions do a searchsorted here.
* entry SoA   — hash_offset / p1_len / p2_len / pcr_size / padded primer
                bytes, ordered by (hash, insertion order) so that in-bucket
                slot order equals the reference's per-bucket emission order
                (engine.py:484, 324-329).

Host keeps ``entry_to_record`` to map device hits back to ``STSRecord``s for
output formatting.

``compile_table`` builds every array on the host with NumPy (``HostTable``);
``table_from_numpy`` carries the fields the scan reads onto a torch device
(``Table``). The compiler is the same construction as the JAX package's
``merpcr_tpu.ops.table``, field for field, so both packages scan identical
tables. ``Table`` also gives the port's own prefilters of the loose and
raw front ends (``fold_bits``): ``qbloom`` and ``bloom`` folded to at most
2^19 bits, small enough for one SM's shared memory, so that a clear
prefilter bit spares the kernel its gather from the full table.

Only the device half (``Table``, ``fold_bits``, ``table_from_numpy``)
needs torch, and it imports torch when it runs, as the JAX package's table
imports ``jax.numpy`` inside its device half: the host fast path compiles
a table without loading torch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, NamedTuple

import numpy as np

from ..io.sts import STSLoadResult
from .encoding import (
    PRIMER_CODE_LUT,
    SCODE,
    iupac_exp_masks,
    match_matrix,
    nib_match_matrix,
)

if TYPE_CHECKING:  # pragma: no cover - torch is imported by the device half
    import torch

MAX_BLOOM_BITS = 24  # 2^24 bits = 2 MB; exact for W <= 12
GTAB_CAP_BITS = 1 << 30  # exact group-table cap: 2^30 bits = 128 MB HBM
T16_MAX_INSERTS = 1 << 22  # disable the 16-base filter past this insert count
#                            (bounds the host-side scatter at table build)
GOLD = np.uint32(0x9E3779B1)
# Group-table truncation: the front-end gather rate cliffs above ~8-16 MB
# on the JAX package's TPU (tools/MICROBENCH.md #2, re-measured round 2: 9.4 ns/key at
# <= 8 MB vs 15.5 ns at >= 16 MB), so exact group tables larger than
# GQ_TARGET_BITS are folded by OR-ing away their top span bases (quarter
# ORs of the LSB-first bit plane) while the set-bit density stays low —
# a sound over-approximation (the exact phase table still removes false
# phases at expand; false flags only cost compact-stage lanes).
GQ_TARGET_BITS = 26  # 2^26 bits = 8 MB (2 MB measured no faster in production)
GQ_MAX_ADDED_DENSITY = 0.02  # stop folding when a fold would add more

_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


def _popcount(a: np.ndarray) -> int:
    if hasattr(np, "bitwise_count"):  # numpy >= 2.0: vectorized popcount
        return int(np.bitwise_count(a).sum(dtype=np.int64))
    return int(_POP8[a.view(np.uint8)].sum(dtype=np.int64))


def _truncate_group_table(tab: np.ndarray, bits: int):
    """Fold an exact (direct-mapped, LSB-first) group bit table down toward
    GQ_TARGET_BITS by OR-ing its 4 quarters (each fold drops the top span
    base: bit[v'] = OR over b of bit[v' | b << (bits-2)]).

    Returns (tab, bits, density) — folding stops when the target size is
    reached or a fold would add more than GQ_MAX_ADDED_DENSITY of set-bit
    density (dense sets: false flags would swamp the compact stage)."""
    density = _popcount(tab) / float(1 << bits)
    while bits > GQ_TARGET_BITS:
        q = tab.reshape(4, -1)
        folded = (q[0] | q[1]) | (q[2] | q[3])
        fdens = _popcount(folded) / float(1 << (bits - 2))
        if fdens - density > GQ_MAX_ADDED_DENSITY:
            break
        tab, bits, density = folded, bits - 2, fdens
    return tab, bits, density


def _lsb_keys(hashes: np.ndarray, wordsize: int) -> np.ndarray:
    """Reference MSB-first W-mer hashes -> LSB-first key values.

    The device tables key buckets by the LSB-first value (base i of the
    W-mer at bits [2i, 2i+2)) because the packed scan derives every
    phase's key from a group register with one shift-and; any bijection
    of the base tuple is a valid bucket key as long as compiler and scan
    agree. The reference's hash (engine.py:331-355) packs MSB-first, so
    loader-produced hashes are bit-pair-reversed here.
    """
    h = hashes.astype(np.uint64)
    k = np.zeros_like(h)
    for i in range(wordsize):
        k |= ((h >> (2 * (wordsize - 1 - i))) & 3) << (2 * i)
    return k.astype(np.int64)


PROJ_UNIT_START = 7  # C: strict projection window = bases C..C+12 of the
#                      24-base u32-UNIT window (26-bit key -> exact 8 MB
#                      table, ONE front-end gather per 8 scan positions)
PROJ_BASES = 13


def _build_strict(
    ehash: np.ndarray,  # uint64[E] LSB-first W-mer keys, entry order
    hoff: np.ndarray,  # int32[E] hash offsets
    p1len: np.ndarray,  # int32[E] primer1 lengths
    p1_bytes: np.ndarray,  # uint8[E, P1MAX]
    wordsize: int,
    iupac_mode: bool,
    n_mm: int = 0,  # mismatch budget baked into the tables (0 or 1):
    #                 at n_mm=1 every EXTENSION position (never a W-mer
    #                 position — the scan's hash lookup is exact at any
    #                 -N) is additionally enumerated as a wildcard, so a
    #                 candidate with <= 1 primer1 mismatch still flags
    max_ins: int = 1 << 25,  # insert guard: bail (strict off) above this
):
    """Unit-projection strict front-end tables for a fixed mismatch budget.

    At ``n_mm=0`` the tables are valid only for -N 0 runs; at ``n_mm=1``
    every extension position (never a W-mer position — the scan's hash
    lookup stays exact at any -N) is additionally enumerated as a
    wildcard, producing the lazily-built tables the -N 1 path gathers.

    At N==0 a candidate only survives the full primer1 verify if EVERY
    active primer byte matches the genome (reference engine.py:599-642),
    so for clean genome any 13 consecutive primer-covered bases are as
    selective as the W-mer itself. That turns the front end's granularity
    into a free variable — and the scan's natural unit is the u32 register
    (8 scan positions, with bases 0..23 of the unit window already in
    registers):

    * ``qbloom_s`` — exact direct-mapped bit table keyed by window bases
      C..C+12 (C = PROJ_UNIT_START = 7; 26 bits -> 8 MB, the fast gather
      tier). A value's bit is set iff for SOME phase d in 0..7 and SOME
      entry, genome bases C..C+12 are consistent with the primer's bytes
      hoff+C-d .. hoff+C+12-d (W-mer codes where the byte falls inside
      the W-mer, extension continuation bytes beyond it, FREE past the
      primer end). C = 7 makes every phase's 13 keyed bases land inside
      the primer (at byte offsets >= C-d >= 0), so ALL phases are fully
      constrained for primers of length >= 20-ish and the table answers
      8 phases with ONE gather — the scan does 2^18 gathers per 2-Mbp
      tile instead of 2^19 (stride 4) or 2^20 (stride 2). Free
      dimensions (bases past the primer end, bases after a multi-code
      IUPAC byte) are enumerated, so the table over-approximates but
      never drops a verifiable candidate; works for EVERY wordsize and
      stride, which also arms strict mode at W >= 14 (mult-hash loose
      front end). Phase bits within a flagged unit come from the LOOSE
      exact phase table ``ptab`` when one exists (W <= 13); the W >= 14
      fallback expands every valid phase of a flagged unit.
    * ``t16`` — a multiplicative-hashed bitmask keyed by the FULL 16-base
      window starting at a candidate position (the scan has those bases
      in registers already). One gather per expanded position filters the
      candidate stream down to ~real-match density before pair expansion;
      it also restores the per-POSITION precision the shared unit key
      cannot express.

    Soundness (no lost hits at N==0, clean windows): a unit kept out can
    only contain candidates with a primer-vs-clean-genome mismatch, which
    the verify would reject anyway. Units whose keyed bases contain an
    ambiguous base bypass the table entirely in the scan (validity
    masks), preserving the reference's ambiguity semantics — in IUPAC
    mode a dirty genome base can legitimately match through the exact
    verify; primer bytes that cannot match ANY clean base (e.g. 'N' in
    non-IUPAC mode) drop the insert for that phase — such entries can
    only match through dirty genome, which takes the bypass path.

    Returns (qbloom_s, t16, t16_bits, t16_real); qbloom_s is None when
    the insert enumeration would explode (pathologically short or
    IUPAC-saturated primers), which disables strict mode entirely.
    """
    E = len(ehash)
    C = PROJ_UNIT_START
    qbloom_s = np.zeros((1 << (2 * PROJ_BASES)) // 32, dtype=np.uint32)

    # Per-entry classification over primer offsets t = 0..C+12 (relative
    # to hoff): W-mer offsets carry their exact hash code; beyond-W
    # offsets classify by how many CLEAN genome codes match the primer
    # byte (IUPAC-aware); offsets past the primer end are FREE.
    T = C + PROJ_BASES  # 20 offsets
    nm = nib_match_matrix(iupac_mode)[:4, :].astype(bool)  # clean codes only
    t = np.arange(T)
    idx = hoff[:, None] + t[None, :]
    act = idx < p1len[:, None]
    byc = PRIMER_CODE_LUT[
        p1_bytes[np.arange(E)[:, None], np.minimum(idx, p1_bytes.shape[1] - 1)]
    ]
    mm = nm[:, byc]  # (4, E, T): clean genome code c matches primer byte
    ncode = mm.sum(axis=0).astype(np.int32)
    code1 = mm.argmax(axis=0).astype(np.uint64)
    inW = t[None, :] < wordsize  # W-mer offsets: exact single code
    wcode = (
        ehash[:, None] >> (2 * t[None, :]).astype(np.uint64)
    ) & np.uint64(3)
    # inactive offsets (past primer end) are FREE; FIXED iff exactly one
    # clean code matches; IMPOSSIBLE (ncode==0) => unmatchable on clean
    # genome. (W-mer offsets are always inside the primer: hoff+W<=p1len.)
    ncode = np.where(inW, 1, np.where(act, ncode, 4))
    code1 = np.where(inW, wcode, code1)

    def _fixed_run(nc: np.ndarray):
        """(drop, fr): unmatchable flag + leading FIXED-run length over a
        (E, width) classification slice."""
        width = nc.shape[1]
        if width == 0:
            return np.zeros(E, dtype=bool), np.zeros(E, dtype=np.int64)
        drop = (nc == 0).any(axis=1)
        fixed = nc == 1
        allf = fixed.all(axis=1)
        fr = np.where(allf, width, np.argmin(fixed, axis=1))
        return drop, fr.astype(np.int64)

    def _scatter(v: np.ndarray):
        np.bitwise_or.at(
            qbloom_s,
            (v >> 5).astype(np.int64),
            np.uint32(1) << (v & 31).astype(np.uint32),
        )

    # Exact mixed-radix enumeration: each keyed position contributes its
    # TRUE allowed-code count as a radix (a degenerate IUPAC 'R' is a
    # factor of 2, not a free-enumeration trigger; only bases past the
    # primer end — and 'N'-like full-degenerate bytes — are radix 4).
    # The insert count per (entry, phase) is the product of the radices;
    # the guard bails strict mode only on genuinely pathological sets
    # (very short primers: many radix-4 tails).
    amask = (
        mm[0].astype(np.uint8)
        | (mm[1].astype(np.uint8) << 1)
        | (mm[2].astype(np.uint8) << 2)
        | (mm[3].astype(np.uint8) << 3)
    )  # allowed-clean-code bitmask per primer offset
    amask = np.where(
        inW,
        np.uint8(1) << wcode.astype(np.uint8),
        np.where(act, amask, np.uint8(15)),
    )
    POPC4 = np.array([bin(i).count("1") for i in range(16)], dtype=np.int64)
    # NTH[mask, j] = j-th allowed code of a 4-bit mask (row-padded)
    NTH = np.zeros((16, 4), dtype=np.uint64)
    for mask in range(16):
        lst = [c for c in range(4) if (mask >> c) & 1] or [0]
        for j in range(4):
            NTH[mask, j] = lst[min(j, len(lst) - 1)]

    # A FREE SUFFIX (trailing radix-4 positions: bases past the primer
    # end, common for short primers / large hash offsets / small C+13
    # windows) is handled by product structure, not enumeration: the
    # constrained-prefix values scatter into a 4^s-bit class block, which
    # then tiles (one broadcast OR) across the whole table — O(table) per
    # suffix class instead of O(4^suffix) per entry.
    def _plan_of(sub):
        cnt = POPC4[sub]
        drop = (cnt == 0).any(axis=1)
        free_sfx = np.minimum.accumulate((cnt == 4)[:, ::-1], axis=1)[
            :, ::-1
        ]  # trailing all-free run mask
        s = PROJ_BASES - free_sfx.sum(axis=1)  # constrained-prefix length
        pcnt = np.where(free_sfx, 1, cnt)
        prod = pcnt.clip(1).prod(axis=1)  # true prefix enumerations
        prod = np.where(drop, 0, prod)
        return (sub, pcnt, prod, s)

    n_ins = 0
    plans = []
    for d in range(8):
        t0 = C - d  # first primer offset keyed by the projection
        variants = [amask[:, t0 : t0 + PROJ_BASES]]  # (E, 13)
        if n_mm >= 1:
            # one-mismatch union: each EXTENSION window position (primer
            # offset >= W) in turn becomes a wildcard
            for k in range(PROJ_BASES):
                if t0 + k >= wordsize:
                    sv = variants[0].copy()
                    sv[:, k] = 15
                    variants.append(sv)
        for sub in variants:
            plan = _plan_of(sub)
            plans.append(plan)
            n_ins += int(plan[2].sum())
            if n_ins > max_ins:
                break
        if n_ins > max_ins:
            break
    # Bail (strict disabled, loose front end) when the set is pathological
    # (saturated degenerate primers) or the n_mm=1 wildcard union would
    # be too dense: the insert count — and with it both the host build
    # time and the table density — is past usefulness.
    if n_ins > max_ins:
        return None, np.zeros(1, dtype=np.uint32), 0, 0.0

    blocks: dict = {}  # suffix class s -> 4^s-bit prefix bitmap

    def _scatter_block(v: np.ndarray, s: int):
        if s >= PROJ_BASES:
            _scatter(v)
            return
        blk = blocks.get(s)
        if blk is None:
            blk = blocks[s] = np.zeros(
                max((1 << (2 * s)) // 32, 1), dtype=np.uint32
            )
        np.bitwise_or.at(
            blk,
            (v >> 5).astype(np.int64),
            np.uint32(1) << (v & 31).astype(np.uint32),
        )

    for sub, cnt, prod, s in plans:
        # radix prefix products: digit k of index m = (m // rp[:, k]) % cnt
        rp = np.ones((E, PROJ_BASES), dtype=np.int64)
        np.cumprod(cnt[:, :-1], axis=1, out=rp[:, 1:])
        # bucket entries by (product magnitude, suffix class) so the
        # m-enumeration wastes at most 4x on the m < prod mask. The loop
        # must run while prods may exist in (lim//4, lim] — the previous
        # `lim < prod.max()+1` condition exited BEFORE the bucket holding
        # any non-power-of-4 product (e.g. prod=3 from one degenerate
        # IUPAC 'H' in a keyed extension position needs lim=4, but
        # 4 < 3+1 is false), silently dropping those phases' inserts and
        # with them real IUPAC-mode hits. Caught by the round-5
        # arbitrary-content differential property test.
        lim = 1
        while lim // 4 < int(prod.max(initial=1)):
            in_lim = (prod > lim // 4) & (prod <= lim)
            for sc in np.unique(s[in_lim]):
                sel = np.flatnonzero(in_lim & (s == sc))
                subs, cnts, rps, prods = sub[sel], cnt[sel], rp[sel], prod[sel]
                step = max(1, (1 << 22) // lim)
                for a in range(0, len(sel), step):
                    sl = slice(a, a + step)
                    m = np.arange(lim, dtype=np.int64)[:, None]  # (lim, 1)
                    v = np.zeros((lim, subs[sl].shape[0]), dtype=np.uint64)
                    for k in range(int(sc)):
                        dig = (m // rps[sl, k][None, :]) % cnts[sl, k][None, :]
                        v |= NTH[subs[sl, k][None, :], dig] << np.uint64(2 * k)
                    _scatter_block(v[m < prods[sl][None, :]], int(sc))
            lim *= 4

    for sc, blk in sorted(blocks.items()):
        if (1 << (2 * sc)) < 32:  # sub-word block: expand bits into word 0
            w = 0
            for b in range(1 << (2 * sc)):
                if (blk[0] >> b) & 1:
                    for r in range(32 // (1 << (2 * sc))):
                        w |= 1 << (b + r * (1 << (2 * sc)))
            qbloom_s |= np.uint32(w)
        else:
            qbloom_s.reshape(-1, len(blk))[:] |= blk[None, :]

    # ---- 16-base position filter ------------------------------------------
    nb = 16 - wordsize  # extension bases past the W-mer inside the window
    ext_nc = ncode[:, wordsize:16]
    variants16 = [ext_nc]
    if n_mm >= 1:
        # one-mismatch union at position granularity: each ext position in
        # turn becomes free (over-approximates Hamming-1 via the fixed-run
        # free tail — sound, slightly denser)
        for wc in range(nb):
            v = ext_nc.copy()
            v[:, wc] = 4
            variants16.append(v)
    n16 = 0
    plans16 = []
    for v in variants16:
        drop16, fr16 = _fixed_run(v)
        plans16.append((drop16, fr16))
        n16 += int(((1 << (2 * (nb - fr16[~drop16]))).astype(np.int64)).sum())
    if 0 < n16 <= T16_MAX_INSERTS:
        t16_bits = int(np.clip(int(np.ceil(np.log2(max(n16, 2)))) + 10, 16, 27))
        t16 = np.zeros((1 << t16_bits) // 32, dtype=np.uint32)
        # pvE is shared across variants: a variant's prefix values only
        # read codes below its fixed run, which ends at or before the
        # wildcarded position
        pvE = np.zeros((E, nb + 1), dtype=np.uint64)
        for k in range(nb):
            pvE[:, k + 1] = pvE[:, k] | (
                code1[:, wordsize + k] << np.uint64(2 * k)
            )
        for drop16, fr16 in plans16:
            for f in range(nb + 1):
                sel = np.flatnonzero(~drop16 & (fr16 == f))
                if not len(sel):
                    continue
                base = ehash[sel] | (pvE[sel, f] << np.uint64(2 * wordsize))
                nfree = 1 << (2 * (nb - f))
                free = np.arange(nfree, dtype=np.uint64) << np.uint64(
                    2 * (wordsize + f)
                )
                step = max(1, (1 << 22) // nfree)
                for a in range(0, len(sel), step):
                    v = (base[None, a : a + step] | free[:, None]).reshape(-1)
                    bk = (
                        (v.astype(np.uint32) * GOLD) >> (32 - t16_bits)
                    ).astype(np.uint64)
                    np.bitwise_or.at(
                        t16,
                        (bk >> 5).astype(np.int64),
                        np.uint32(1) << (bk & 31).astype(np.uint32),
                    )
    else:
        t16_bits = 0
        t16 = np.zeros(1, dtype=np.uint32)
    return (qbloom_s, t16, t16_bits, float(n16) / float(4**16))


class HostTable(NamedTuple):
    """Every compiled table array, as host NumPy arrays."""

    scode: np.ndarray  # int32[256]
    match: np.ndarray  # uint8[65536]   (256x256 flattened, [seq*256+primer])
    bloom: np.ndarray  # uint32[2^bloom_bits / 32]  (unpacked path)
    qbloom: np.ndarray  # uint32[2^qbloom_bits / 32]  stride-group any-phase bits
    ptab: np.ndarray  # uint32 exact phase-bit table (expand stage; dummy [1]
    #                    in mult-hash fallback mode)
    # extension-strict variants (valid only at mismatches == 0; see
    # _build_strict) + hashed 16-base position filter; dummies when absent.
    # Strict mode has NO phase-table variant: the expand stage gathers the
    # loose (exact) ``ptab`` either way.
    qbloom_s: np.ndarray  # uint32: strict group any-phase bits | [1]
    t16: np.ndarray  # uint32[2^t16_bits / 32] | [1]
    # N=1 variants (extension positions Hamming-1-wildcarded; built only
    # when the insert estimate stays small — see compile_table)
    qbloom_s1: np.ndarray  # uint32 | [1]
    t16_1: np.ndarray  # uint32 | [1]
    uhash: np.ndarray  # uint32[U]      sorted unique hashes
    ustart: np.ndarray  # int32[U+1]    CSR offsets into entry arrays
    # dense CSR (W <= 12): bucket_start[4^W + 1] — exact lookup is ONE
    # gather instead of a log2(U)-step binary search; dummy [0,0] otherwise
    bstart: np.ndarray  # int32[4^W + 1] | int32[2]
    # W <= 11 only: (start, count) pairs as 2-wide rows — a TPU gather's
    # cost is per ROW, not per element (tools/MICROBENCH.md #1), so
    # one row gather replaces the bstart[h] + bstart[h+1] pair
    bsc: np.ndarray  # int32[4^W, 2] | int32[1, 2]
    # per-entry scalars packed into one 8-wide row (same per-row insight):
    # [hash_offset, p1_len, p2_len, pcr_size, 0, 0, 0, 0]
    emeta: np.ndarray  # int32[E, 8]
    hash_offset: np.ndarray  # int32[E]
    p1_len: np.ndarray  # int32[E]
    p2_len: np.ndarray  # int32[E]
    pcr_size: np.ndarray  # int32[E]
    p1_bytes: np.ndarray  # uint8[E, P1MAX]
    p2_bytes: np.ndarray  # uint8[E, P2MAX]
    # nibble-plane variants (packed genome path): primer codes 0..17 and the
    # 16 x 32 match table (flattened) with identical semantics
    nib_match: np.ndarray  # uint8[512]
    p1_codes: np.ndarray  # uint8[E, P1MAX]
    p2_codes: np.ndarray  # uint8[E, P2MAX]
    # IUPAC expansion bitmasks (iupac mode only; dummies otherwise):
    # match(s,p) == (EXP_NIB[s] & p*_exp[p]) != 0 — primer side
    # pre-expanded so verify needs one row gather + VPU ands
    p1_exp: np.ndarray  # uint32[E, P1MAX] | uint32[1, 1]
    p2_exp: np.ndarray  # uint32[E, P2MAX] | uint32[1, 1]


@dataclass
class TableMeta:
    """Host-side metadata accompanying a HostTable."""

    wordsize: int
    n_entries: int
    n_unique: int
    bloom_bits: int
    stride: int  # packed front-end: positions per group lookup (2|4)
    qbloom_bits: int  # log2 bits of the group table (== 2*span when exact)
    exact_group: bool  # True: direct-mapped exact table; False: mult-hash bloom
    q_bits: int  # ACTUAL log2 bits of the loose group table (exact mode:
    #              <= 2*span after truncation — see _truncate_group_table)
    sq_bits: int  # actual log2 bits of the strict group table
    q_density: float  # loose group-table set-bit fraction (cap sizing)
    strict: bool  # strict (N==0) table variants were built
    t16_bits: int  # log2 bits of the 16-base position filter (0 = disabled)
    sq_density: float  # strict group-table set-bit fraction (cap sizing)
    sp_density: float  # loose phase-bit set fraction (per scan position;
    #                    bounds strict-mode position expansion from above)
    t16_real: float  # expected real 16-base match probability per position
    t16_fp: float  # t16 false-positive rate (set-bit fraction)
    p1_max: int
    p2_max: int
    lead: int  # max hash_offset over entries (tile left halo)
    max_pcr_size: int
    entry_to_record: np.ndarray  # int32[E]: device entry idx -> STSRecord idx
    # N=1 strict variant (built only when its insert estimate stays small;
    # the engine arms it when the runtime -N is exactly 1)
    strict1: bool = False
    sq1_density: float = 1.0
    t16_1_bits: int = 0
    t16_1_real: float = 0.0
    t16_1_fp: float = 1.0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def compile_table(
    res: STSLoadResult, wordsize: int, iupac_mode: bool,
) -> tuple[HostTable, TableMeta]:
    """Compile parsed STS entries into host arrays (``table_from_numpy``
    moves the scanned fields to a device).

    Entries are stably sorted by hash so each bucket's slots keep file
    insertion order — required for emission-order equality with the
    reference's per-bucket candidate loop (engine.py:484).
    """
    E = len(res.records)
    if E == 0:
        # Degenerate but well-formed table; engine short-circuits anyway.
        hashes = np.zeros(0, dtype=np.int64)
        order = np.zeros(0, dtype=np.int64)
    else:
        hashes = _lsb_keys(res.hashes, wordsize)
        order = np.argsort(hashes, kind="stable")

    sorted_hashes = hashes[order]
    uhash, ustart_counts = np.unique(sorted_hashes, return_counts=True)
    ustart = np.zeros(len(uhash) + 1, dtype=np.int32)
    np.cumsum(ustart_counts, out=ustart[1:])

    two_w = 2 * wordsize
    bloom_bits = min(two_w, MAX_BLOOM_BITS)
    shift = two_w - bloom_bits
    # Exact key-occupancy bitmask (unpacked / raw-byte fallback path only;
    # the packed path uses the stride-group qbloom below).
    bloom = np.zeros((1 << bloom_bits) // 32, dtype=np.uint32)
    keys = uhash.astype(np.uint64) >> shift
    np.bitwise_or.at(
        bloom, (keys >> 5).astype(np.int64), np.uint32(1) << (keys & 31).astype(np.uint32)
    )

    # ---- stride-group tables (packed path) --------------------------------
    # ONE front-end lookup covers `stride` adjacent scan positions.
    # Whenever the group span W + stride - 1 is small enough, TWO exact
    # direct-mapped tables over all 4^span span values are built:
    #
    # * ``qbloom`` — 1 bit per span value ("SOME phase of this exact span
    #   string starts a bucket key"). This is the only table the
    #   O(sequence) front end gathers; at 4^span bits it is 4x smaller
    #   than the phase table, and gather throughput on this hardware
    #   degrades with table size (tools/MICROBENCH.md #2), so the
    #   hot stage stays on the small one. Zero false positives.
    # * ``ptab`` — `stride` bits per FOLDED span value: bit d set iff
    #   bases d..d+W-1 of some span string with these low span-1 bases
    #   are a bucket key. The top span base is folded away AT BUILD
    #   (ptab is 4x smaller — 32 MB instead of 128 at W=11 — and builds
    #   with 4x less memory traffic); only the LAST phase's key touches
    #   that base, so only its bits over-approximate (4x denser), which
    #   merely expands a few extra positions the exact CSR then rejects.
    #   Gathered ONLY at compacted-candidate granularity by the expand
    #   stage, where it resolves WHICH phases anchor candidates without
    #   per-phase CSR probes. Layout: folded value vf = v mod 4^(span-1)
    #   -> word vf >> log2(32/S), bit S*(vf % (32/S)) + d; the scan
    #   derives the folded width from the table's shape.
    #
    # For larger W a mult-hashed bloom over the first KB = min(16, span)
    # bases replaces qbloom (over-approximating; the exact CSR removes
    # false positives) and ptab is a dummy.
    E1 = max(len(uhash), 1)
    uh64 = uhash.astype(np.uint64)
    if 4 * (4 ** (wordsize + 3)) <= GTAB_CAP_BITS:
        stride = 4
    else:
        stride = 2
    span = wordsize + stride - 1
    exact_group = stride * (4**span) <= GTAB_CAP_BITS
    if exact_group:
        qbloom_bits = 2 * span
        nspan = 1 << (2 * span)
        # bit-spread LUT: byte b -> b's 8 bits moved to every S-th bit
        bidx = np.arange(256, dtype=np.uint32)
        lut = np.zeros(256, dtype=np.uint32)
        for j in range(8):
            lut |= ((bidx >> j) & 1) << (stride * j)
        nsuf_bases = span - wordsize
        NPS = 5 - (stride.bit_length() - 1)  # log2(32 / stride)
        n_ins = stride * (4**nsuf_bases) * len(uhash)
        nspan_f = nspan // 4  # ptab folds its top span base at build
        if n_ins <= (1 << 21):
            # sparse sets: scatter both layouts directly (never touches
            # the whole 4^span plane, so this path is ~milliseconds)
            qbloom = np.zeros(nspan // 32, dtype=np.uint32)
            ptab = np.zeros(nspan_f * stride // 32, dtype=np.uint32)
            for d in range(stride):
                npre = 1 << (2 * d)
                nsuf = 1 << (2 * (nsuf_bases - d))
                v = (
                    np.arange(npre, dtype=np.uint64)[:, None, None]
                    | (uh64 << (2 * d))[None, :, None]
                    | (
                        np.arange(nsuf, dtype=np.uint64)
                        << (2 * (d + wordsize))
                    )[None, None, :]
                ).reshape(-1)
                np.bitwise_or.at(
                    qbloom,
                    (v >> 5).astype(np.int64),
                    np.uint32(1) << (v & 31).astype(np.uint32),
                )
                vf = v & np.uint64(nspan_f - 1)
                np.bitwise_or.at(
                    ptab,
                    (vf >> NPS).astype(np.int64),
                    np.uint32(1)
                    << (
                        (vf & ((1 << NPS) - 1)).astype(np.uint32)
                        * np.uint32(stride)
                        + np.uint32(d)
                    ),
                )
        else:
            # Dense sets: no scatter of span values at all. Phase d's bit
            # plane has a product structure — span value v holds a key at
            # phase d iff (v >> 2d) & mask(2W) is a key, and for
            # v = r*4^(W+d) + u that 2W-bit field is exactly u >> 2d
            # (the d "pre" bases are u's low bits, the suffix bases are r).
            # So plane d == tile(repeat(membership_bitmap, 4^d), 4^(S-1-d)):
            # the whole thing derives from the 4^W-bit key bitmap by a
            # packed-bit repeat LUT (bit -> nibble) and memcpy tiling —
            # ~15x faster than scattering the 4^(S-1)*E expanded values
            # (verified bit-identical to the scatter construction).
            lutr4 = np.zeros(256, dtype=np.uint32)  # bit j -> 0xF at nibble j
            for j in range(8):
                lutr4 |= (((bidx >> j) & 1) * np.uint32(0xF)) << (4 * j)
            mb = np.zeros(1 << (2 * wordsize), dtype=np.bool_)
            mb[uh64] = True
            first = np.packbits(mb, bitorder="little")  # phase-0, first copy
            any_pb = np.zeros(nspan // 8, dtype=np.uint8)
            ptab = np.zeros(nspan_f * stride // 32, dtype=np.uint32)
            for d in range(stride):
                if d > 0:
                    first = lutr4[first].view(np.uint8)  # repeat bits x4
                rep = nspan // (len(first) * 8)
                any_pb.reshape(rep, -1)[:] |= first[None, :]
                # folded ptab plane: phases whose key avoids the dropped
                # top base just tile 4x less; the LAST phase's key loses
                # its top base (OR-fold of the repeated key bitmap)
                if len(first) * 8 <= nspan_f:
                    pf = first
                else:  # d == stride-1: key occupies the dropped base
                    q4 = first.reshape(4, -1)
                    pf = (q4[0] | q4[1]) | (q4[2] | q4[3])
                repf = nspan_f // (len(pf) * 8)
                sp = lut[pf] << d  # u32/byte: 8 values' bit-d, spread
                if stride == 4:
                    ptab.reshape(repf, -1)[:] |= sp[None, :]
                else:  # stride == 2: two bytes per output word
                    spw = sp[0::2] | (sp[1::2] << 16)
                    ptab.reshape(repf, -1)[:] |= spw[None, :]
            qbloom = any_pb.view(np.uint32)
    else:
        # mult-hashed fallback (W >= 14): key = first KB bases of the group
        ptab = np.zeros(1, dtype=np.uint32)
        KB = min(16, span)
        qbloom_bits = int(
            np.clip(
                int(np.ceil(np.log2(max(8 * E1, 1) / 0.015))), 20, 26
            )
        )
        qbloom = np.zeros((1 << qbloom_bits) // 32, dtype=np.uint32)
        GOLD = np.uint32(0x9E3779B1)
        for d in range(stride):
            o = min(wordsize, KB - d)  # bases of K inside the KB window
            kpref = uh64 & ((np.uint64(1) << (2 * o)) - np.uint64(1))
            npre = 1 << (2 * d)
            nsuf = 1 << (2 * (KB - d - o))
            v = (
                np.arange(npre, dtype=np.uint64)[:, None, None]
                | (kpref << (2 * d))[None, :, None]
                | (np.arange(nsuf, dtype=np.uint64) << (2 * (d + o)))[
                    None, None, :
                ]
            ).reshape(-1)
            hq = ((v.astype(np.uint32) * GOLD) >> (32 - qbloom_bits)).astype(
                np.uint64
            )
            np.bitwise_or.at(
                qbloom,
                (hq >> 5).astype(np.int64),
                np.uint32(1) << (hq & 31).astype(np.uint32),
            )

    # Fold oversized exact group tables toward the fast-gather size (the
    # front end gathers these once per stride-group — the hot stage).
    if exact_group:
        qbloom, q_bits, q_density = _truncate_group_table(
            qbloom, qbloom_bits
        )
    else:
        q_bits = qbloom_bits
        q_density = _popcount(qbloom) / float(1 << qbloom_bits)

    exp_nib, exp_primer = iupac_exp_masks()
    p1_max = max(16, _round_up(int(res.p1_lens.max()) if E else 16, 8))
    p2_max = max(16, _round_up(int(res.p2_lens.max()) if E else 16, 8))

    p1_bytes = np.zeros((max(E, 1), p1_max), dtype=np.uint8)
    p2_bytes = np.zeros((max(E, 1), p2_max), dtype=np.uint8)
    if E and res.p1_pad is not None:
        # loader already produced zero-padded (E, Lmax) matrices; Lmax is
        # the max over BOTH primer columns, so clip each side to its own
        # width (the clipped columns are padding zeros by construction)
        w1 = min(p1_max, res.p1_pad.shape[1])
        w2 = min(p2_max, res.p2_pad.shape[1])
        p1_bytes[:, :w1] = res.p1_pad[order][:, :w1]
        p2_bytes[:, :w2] = res.p2_pad[order][:, :w2]
    else:
        for dst, src in enumerate(order):
            p1 = res.p1_list[src]
            p2 = res.p2_list[src]
            p1_bytes[dst, : len(p1)] = p1
            p2_bytes[dst, : len(p2)] = p2

    def col(a, dtype=np.int32, pad=0):
        a = a[order].astype(dtype) if E else np.zeros(0, dtype=dtype)
        if len(a) == 0:
            a = np.full(1, pad, dtype=dtype)
        return a

    if len(uhash) == 0:
        uhash_dev = np.full(1, np.uint32(0xFFFFFFFF), dtype=np.uint32)
        ustart_dev = np.zeros(2, dtype=np.int32)
    else:
        uhash_dev = uhash.astype(np.uint32)
        ustart_dev = ustart

    dense_csr = wordsize <= 12  # 4^12+1 ints = 67 MB; above that, binary search
    if dense_csr:
        bstart = np.zeros((4**wordsize) + 1, dtype=np.int32)
        if len(uhash):
            bstart[uhash.astype(np.int64) + 1] = ustart_counts.astype(np.int32)
        np.cumsum(bstart, out=bstart)
    else:
        bstart = np.zeros(2, dtype=np.int32)
    if wordsize <= 11:  # (start, count) rows; 32 MB at W=11 — skip at W=12
        bsc = np.empty((4**wordsize, 2), dtype=np.int32)
        bsc[:, 0] = bstart[:-1]
        np.subtract(bstart[1:], bstart[:-1], out=bsc[:, 1])
        bstart = np.zeros(2, dtype=np.int32)  # superseded by bsc
    else:
        bsc = np.zeros((1, 2), dtype=np.int32)

    emeta = np.zeros((max(E, 1), 8), dtype=np.int32)
    emeta[:, 0] = col(res.hash_offsets)
    emeta[:, 1] = col(res.p1_lens)
    emeta[:, 2] = col(res.p2_lens)
    emeta[:, 3] = col(res.pcr_sizes, pad=1)

    # ---- strict (N==0) front-end variants ---------------------------------
    # The projection table works for EVERY wordsize (key bases outside the
    # projection window just don't constrain), so strict mode no longer
    # requires an exact span table — W >= 14 gets strict too.
    strict = bool(E > 0)
    if strict:
        qbloom_s, t16, t16_bits, t16_real = _build_strict(
            sorted_hashes.astype(np.uint64),
            emeta[:E, 0],
            emeta[:E, 1],
            p1_bytes,
            wordsize,
            iupac_mode,
        )
        strict = qbloom_s is not None  # insert-explosion bail
    if strict:
        qbloom_s, sq_bits, sq_density = _truncate_group_table(
            qbloom_s, 2 * PROJ_BASES
        )
        if sq_density >= 0.5:
            # saturated (e.g. tiny-W primers whose keys fall outside the
            # projection window, or degenerate-heavy sets): a front end
            # that flags half the units costs more than it prunes
            strict = False
    if strict:
        # Strict expansion gathers the LOOSE phase table (exact mode), so
        # the per-position expansion probability is bounded by its set
        # fraction; the W >= 14 fallback expands every valid phase of a
        # flagged group (sp_density 1.0 keeps the cap model conservative).
        sp_density = (
            _popcount(ptab) / float(ptab.size * 32)
            if exact_group
            else 1.0
        )
        t16_fp = (
            _popcount(t16) / float(1 << t16_bits) if t16_bits else 1.0
        )
    else:
        qbloom_s = np.zeros(1, dtype=np.uint32)
        t16 = np.zeros(1, dtype=np.uint32)
        t16_bits = 0
        sq_bits = q_bits
        sq_density = sp_density = t16_real = t16_fp = 1.0

    # The strict N=1 variant (extension positions Hamming-1-wildcarded) is
    # built lazily by ``build_strict1`` on the first -N 1 search, so -N 0
    # runs never pay for it; meta.strict1 stays False until then.
    strict1 = False
    qbloom_s1 = np.zeros(1, dtype=np.uint32)
    t16_1 = np.zeros(1, dtype=np.uint32)
    t16_1_bits = 0
    sq1_density = t16_1_real = 0.0
    t16_1_fp = 1.0

    asarray = np.ascontiguousarray
    table = HostTable(
        scode=asarray(SCODE),
        match=asarray(match_matrix(iupac_mode).reshape(-1)),
        bloom=asarray(bloom),
        qbloom=asarray(qbloom),
        ptab=asarray(ptab),
        qbloom_s=asarray(qbloom_s),
        t16=asarray(t16),
        qbloom_s1=asarray(qbloom_s1),
        t16_1=asarray(t16_1),
        uhash=asarray(uhash_dev),
        ustart=asarray(ustart_dev),
        bstart=asarray(bstart),
        bsc=asarray(bsc),
        emeta=asarray(emeta),
        hash_offset=asarray(col(res.hash_offsets)),
        p1_len=asarray(col(res.p1_lens)),
        p2_len=asarray(col(res.p2_lens)),
        pcr_size=asarray(col(res.pcr_sizes, pad=1)),
        p1_bytes=asarray(p1_bytes),
        p2_bytes=asarray(p2_bytes),
        nib_match=asarray(nib_match_matrix(iupac_mode).reshape(-1)),
        p1_codes=asarray(PRIMER_CODE_LUT[p1_bytes]),
        p2_codes=asarray(PRIMER_CODE_LUT[p2_bytes]),
        p1_exp=asarray(
            exp_primer[PRIMER_CODE_LUT[p1_bytes]]
            if iupac_mode
            else np.zeros((1, 1), np.uint32)
        ),
        p2_exp=asarray(
            exp_primer[PRIMER_CODE_LUT[p2_bytes]]
            if iupac_mode
            else np.zeros((1, 1), np.uint32)
        ),
    )
    meta = TableMeta(
        wordsize=wordsize,
        n_entries=E,
        n_unique=len(uhash),
        bloom_bits=bloom_bits,
        stride=stride,
        qbloom_bits=qbloom_bits,
        exact_group=exact_group,
        q_bits=q_bits,
        sq_bits=sq_bits,
        q_density=q_density,
        strict=strict,
        t16_bits=t16_bits,
        sq_density=sq_density,
        sp_density=sp_density,
        t16_real=t16_real,
        t16_fp=t16_fp,
        p1_max=p1_max,
        p2_max=p2_max,
        lead=int(res.hash_offsets.max()) if E else 0,
        max_pcr_size=res.max_pcr_size,
        entry_to_record=order.astype(np.int32),
        strict1=strict1,
        sq1_density=sq1_density,
        t16_1_bits=t16_1_bits,
        t16_1_real=t16_1_real,
        t16_1_fp=t16_1_fp,
    )
    return table, meta


def build_strict1(table: HostTable, meta: TableMeta, iupac_mode: bool):
    """Build the N=1 strict variant on demand (first ``-N 1`` search):
    ``merpcr_tpu/ops/table.py::build_strict1``.

    The same construction as the N=0 tables with every extension position
    Hamming-1-wildcarded (``_build_strict(n_mm=1)``); the tighter insert
    guard (2^22) keeps the build fast and gives up on sets whose wildcard
    union would saturate the table, which then scan loose at -N 1. The
    inputs come from the compiled table's own entry arrays. Mutates
    ``meta`` in place (``meta.strict1`` says whether the variant armed)
    and returns (table, meta), the table with ``qbloom_s1``/``t16_1``
    replaced when it armed."""
    E = meta.n_entries
    if E == 0 or not meta.strict:
        return table, meta
    p1b = np.asarray(table.p1_bytes)[:E]
    em = np.asarray(table.emeta)[:E]
    hoff = em[:, 0].astype(np.int64)
    codes = PRIMER_CODE_LUT[p1b].astype(np.uint64)
    ehash = np.zeros(E, dtype=np.uint64)
    rows = np.arange(E)
    for j in range(meta.wordsize):  # W-mer bytes are clean ACGT (codes 0-3)
        ehash |= codes[rows, hoff + j] << np.uint64(2 * j)
    qbloom_s1, t16_1, t16_1_bits, t16_1_real = _build_strict(
        ehash, em[:, 0], em[:, 1], p1b, meta.wordsize, iupac_mode,
        n_mm=1, max_ins=1 << 22,
    )
    strict1 = qbloom_s1 is not None
    if strict1:
        qbloom_s1, _bits, sq1_density = _truncate_group_table(
            qbloom_s1, 2 * PROJ_BASES
        )
        strict1 = sq1_density < 0.5
    meta.strict1 = strict1
    if not strict1:
        return table, meta
    meta.sq1_density = sq1_density
    meta.t16_1_bits = t16_1_bits
    meta.t16_1_real = t16_1_real
    meta.t16_1_fp = (
        _popcount(t16_1) / float(1 << t16_1_bits) if t16_1_bits else 1.0
    )
    return (
        table._replace(qbloom_s1=np.ascontiguousarray(qbloom_s1),
                       t16_1=np.ascontiguousarray(t16_1)),
        meta,
    )


class Table(NamedTuple):
    """The tensors the tile scan reads, on one torch device.

    32-bit words (``qbloom*``, ``ptab``, ``t16*``, ``bloom``, ``p*_exp``)
    are held as int32 with the uint32 bit pattern: the CUDA kernels read
    them as ``uint32_t``, and the plain PyTorch versions widen them to
    int64 and mask. The key widths come from the tables' own sizes, as in
    the JAX scan, so a table and its key masks cannot disagree."""

    qbloom_s: torch.Tensor  # int32[2^gq / 32]: strict unit-projection bits
    ptab: torch.Tensor  # int32[4^(span-1) * stride / 32]: folded phase bits | [1]
    t16: torch.Tensor  # int32[2^t16_bits / 32] | [1]: 16-base filter
    bsc: torch.Tensor  # int32[4^W, 2]: dense CSR (start, count) rows (W <= 11) | [1, 2]
    emeta: torch.Tensor  # int32[E, 8]: hoff, p1_len, p2_len, pcr_size, ...
    p1_codes: torch.Tensor  # uint8[E, P1MAX]
    p2_codes: torch.Tensor  # uint8[E, P2MAX]
    bloom: torch.Tensor  # int32[2^bloom_bits / 32]: W-mer key occupancy (K10)
    p1_exp: torch.Tensor  # int32[E, P1MAX] IUPAC expansion masks | [1, 1]
    p2_exp: torch.Tensor  # int32[E, P2MAX] IUPAC expansion masks | [1, 1]
    # loose front end (K8): the exact group table, span keys folded to their
    # low q_bits bits, or (W >= 14) the mult-hash bloom of 2^qbloom_bits bits
    qbloom: torch.Tensor  # int32[2^q_bits / 32]
    # strict N=1 variant (build_strict1); [1] dummies until it armed
    qbloom_s1: torch.Tensor  # int32[2^gq1 / 32] | [1]
    t16_1: torch.Tensor  # int32[2^t16_1_bits / 32] | [1]
    gq: int  # log2 bits of qbloom_s (<= 26 after truncation)
    pf_bits: int  # log2 folded span values of ptab (no meaning without one)
    t16_bits: int  # 0: no 16-base filter
    bloom_bits: int  # log2 bits of bloom (min(2W, 24))
    q_bits: int  # log2 bits of qbloom (<= 2 * span when exact)
    strict1: bool  # the N=1 variant armed (qbloom_s1/t16_1 are real)
    gq1: int  # log2 bits of qbloom_s1
    t16_1_bits: int  # 0: no 16-base filter at N=1
    # the CSR of the wider words: bucket starts (W = 12), or the sorted
    # unique keys and their starts for the binary search (W >= 13). uhash
    # holds uint32 bit patterns, and at W = 16 all 32 bits: the kernel
    # compares it as uint32_t, the plain version widens it to int64
    bstart: torch.Tensor  # int32[4^12 + 1] | [2]
    uhash: torch.Tensor  # int32[U] (uint32 bits), ascending as unsigned
    ustart: torch.Tensor  # int32[U + 1]
    wordsize: int
    stride: int  # scan positions per group lookup: 4 (W <= 11) or 2
    exact_group: bool  # qbloom/ptab are exact span tables (W <= 13)
    qbloom_bits: int  # log2 bits of the group table before truncation
    # the raw-byte path (K9): primer bytes as written (case kept, 0-padded)
    # and the reference's 256 x 256 match table of the table's -I mode,
    # flattened [genome byte * 256 + primer byte]
    p1_bytes: torch.Tensor  # uint8[E, P1MAX]
    p2_bytes: torch.Tensor  # uint8[E, P2MAX]
    match: torch.Tensor  # uint8[65536]
    # the port's prefilters of the loose and raw front ends (``fold_bits``):
    # bit j of the loose one is set iff qbloom holds a bit b with (b >>
    # qpre_shift) & (2^qpre_bits - 1) == j; the raw one is bloom folded to
    # its low bpre_bits bits. A table of at most 2^PREFILTER_BITS bits is its
    # own prefilter. Each is folded on its table's device at its first use
    # and kept in ``folds`` ((table tensor, fold) pairs): a
    # strict search never folds, and a copy of the Table on another device
    # (which shares ``folds``) folds its own tensor there.
    qpre_bits: int
    qpre_shift: int
    bpre_bits: int
    folds: list

    @property
    def loose_prefilter(self) -> tuple:
        """(words, bits, shift) of ``front_end_loose``'s prefilter."""
        pre = self._fold(self.qbloom, self.qpre_shift, self.qpre_bits)
        return pre, self.qpre_bits, self.qpre_shift

    @property
    def raw_prefilter(self) -> tuple:
        """(words, bits, shift) of ``front_end_raw``'s prefilter."""
        return self._fold(self.bloom, 0, self.bpre_bits), self.bpre_bits, 0

    def _fold(self, words: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
        for held, fold in self.folds:  # found by the table tensor's identity
            if held is words:
                return fold
        fold = fold_bits(words, shift, bits)
        self.folds.append((words, fold))
        return fold

    @property
    def csr(self):
        """The bucket lookup ``expand`` takes for this word size: the
        ``bsc`` rows (W <= 11), the ``bstart`` vector (W = 12) or the
        (``uhash``, ``ustart``) pair (W >= 13)."""
        if self.wordsize <= 11:
            return self.bsc
        if self.wordsize == 12:
            return self.bstart
        return (self.uhash, self.ustart)


def _bits_of(n: int) -> int:
    return n.bit_length() - 1


PREFILTER_BITS = 19  # 2^19 bits = 64 KB of one SM's shared memory


def fold_bits(words: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """A bit table folded to 2^``bits`` bits: bit j of the result is set
    iff some set bit b of ``words`` (int32 words of 2^n bits, n >= shift +
    bits) has (b >> shift) & (2^bits - 1) == j. A key whose result bit is
    clear therefore has its table bit clear. ``words`` itself when it has
    2^bits bits. Torch ops on the table's device."""
    import torch

    from .units import to_i32, u32

    n = _bits_of(words.numel() * 32)
    if n == bits:
        return words
    if shift + bits > n or bits < 5:
        raise ValueError(f"no window [{shift}, {shift + bits}) in a table of 2^{n} bits")
    w = u32(words).view(1 << (n - shift - bits), -1)
    while w.shape[0] > 1:  # bits above the window: OR the halves together
        w = w[: w.shape[0] // 2] | w[w.shape[0] // 2 :]
    w = w.view(-1)  # 2^(shift + bits) bits; a result bit per 2^shift of them
    if shift >= 5:  # a result bit covers whole words
        hit = (w.view(1 << bits, -1) != 0).any(dim=1).to(torch.int64).view(-1, 32)
        return to_i32((hit << torch.arange(32, device=w.device)).sum(dim=1))
    g = 1 << shift
    for k in range(shift):  # bit g*i of a word: the OR of its group i
        w = w | (w >> (1 << k))
    width, space = 1, g  # gather bits 0, g, 2g, .. of each word into its low 32/g
    w = w & _ones(width, space)
    while space < 32:
        w = (w | (w >> (space - width))) & _ones(2 * width, 2 * space)
        width, space = 2 * width, 2 * space
    w = w.view(-1, g) << (torch.arange(g, device=w.device) * (32 // g))
    return to_i32(w.sum(dim=1))


def _ones(width: int, space: int) -> int:
    """32-bit mask of the low ``width`` bits of every ``space`` bits."""
    return sum(((1 << width) - 1) << i for i in range(0, 32, space))


def prefilter_shift(q_bits: int, wordsize: int, stride: int, hashed: bool,
                    bits: int = PREFILTER_BITS) -> int:
    """Low key bit of ``qbloom``'s prefilter window. A mult-hash index is
    mixed in every bit: its low bits. An exact span key's low and high bases
    belong to only some phases' W-mers, so the window is centred on the
    bases that every phase keys (bases stride-1 .. W-1), whole bases, inside
    the table's q_bits; ``bits`` is the prefilter's size."""
    if hashed or q_bits <= bits:
        return 0
    centre = wordsize + stride - 1  # in bits: the middle of those bases
    return min(max((centre - bits // 2) & ~1, 0), q_bits - bits)


def table_from_numpy(host, meta: TableMeta, device) -> Table:
    """Carry a compiled table onto ``device``.

    ``host`` is any record with the HostTable field names holding NumPy
    arrays: this package's ``compile_table`` output or the JAX package's
    host-compiled ``DeviceTable``, so both packages can be fed the identical
    table. Only the fields the scan reads move; ``p1_exp`` and ``p2_exp``
    are real only for a table compiled with ``iupac_mode``, and
    ``qbloom_s1``/``t16_1`` only once ``build_strict1`` armed them; they
    stay the dummies otherwise, as in the JAX table. The front ends'
    prefilters are only sized here; ``Table.loose_prefilter`` and
    ``raw_prefilter`` fold them on first use."""
    import torch

    def words(a):
        a = np.ascontiguousarray(np.asarray(a, dtype=np.uint32)).view(np.int32)
        return torch.from_numpy(a).to(device)

    def ints(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype=dtype))).to(device)

    def bits(a):
        return _bits_of(int(np.asarray(a).shape[0]) * 32)

    ptab = np.asarray(host.ptab)
    q_bits = bits(host.qbloom)
    return Table(
        qbloom_s=words(host.qbloom_s),
        ptab=words(ptab),
        t16=words(host.t16),
        bsc=ints(host.bsc, np.int32),
        emeta=ints(host.emeta, np.int32),
        p1_codes=ints(host.p1_codes, np.uint8),
        p2_codes=ints(host.p2_codes, np.uint8),
        bloom=words(host.bloom),
        p1_exp=words(host.p1_exp),
        p2_exp=words(host.p2_exp),
        qbloom=words(host.qbloom),
        qbloom_s1=words(host.qbloom_s1),
        t16_1=words(host.t16_1),
        gq=bits(host.qbloom_s),
        pf_bits=_bits_of(int(ptab.shape[0]) * 32 // meta.stride),
        t16_bits=int(meta.t16_bits),
        bloom_bits=int(meta.bloom_bits),
        q_bits=q_bits,
        strict1=bool(meta.strict1),
        gq1=bits(host.qbloom_s1),
        t16_1_bits=int(meta.t16_1_bits),
        bstart=ints(host.bstart, np.int32),
        uhash=words(host.uhash),
        ustart=ints(host.ustart, np.int32),
        wordsize=int(meta.wordsize),
        stride=int(meta.stride),
        exact_group=bool(meta.exact_group),
        qbloom_bits=int(meta.qbloom_bits),
        p1_bytes=ints(host.p1_bytes, np.uint8),
        p2_bytes=ints(host.p2_bytes, np.uint8),
        match=ints(host.match, np.uint8),
        qpre_bits=min(q_bits, PREFILTER_BITS),
        qpre_shift=prefilter_shift(q_bits, int(meta.wordsize), int(meta.stride),
                                   not meta.exact_group),
        bpre_bits=min(bits(host.bloom), PREFILTER_BITS),
        folds=[],
    )
