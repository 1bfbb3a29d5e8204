"""K2-K5, K10 and K12 ``expand`` (strict), ``expand_loose`` and K9b
``expand_raw``: flagged units, stride groups or raw-plane positions ->
candidate (entry, position) pairs.

Replaces ``merpcr_tpu/ops/scan.py::_scan_tile_impl`` stages K2-K5: the
flag-word compaction (``scan.py:680-719``, ``_rank_invert`` ``:317-341``,
``_blocked_scan`` ``:287-314``), the phase expansion (``:757-927``), the
hashed 16-base position filter ``t16`` (``:929-949``) and the CSR pair
expansion (``exact_csr`` ``:721-741``, ``:953-964``); and K10, the
dirty-span phase filter (``dirty_bloom``, ``:803-822``): when ``bloom`` is
given, a phase of a unit whose group span is dirty survives only if its
W-mer is a key of the table's occupancy bitmap ``bloom`` (a prefix filter
once 2W passes the bitmap's 24 bits). Ambiguity-heavy genomes (1 %
scattered IUPAC letters flag ~12 % of units) would otherwise expand every
clean phase of every such unit through the CSR.

The word size picks the tables (``table.py:567-574``):

* phase bits (``ptab_bits`` ``:832-871``): with an exact group table
  (W <= 13) a clean span trusts the folded phase table ``ptab``, 4 bits
  per span value at stride 4 (W <= 11) and 2 bits at stride 2 (W = 12,
  13; four groups per unit); without one (W >= 14, ``:872-875``) every
  valid phase expands, pruned by ``bloom`` when K10 is armed;
* bucket lookup ``csr``: one (start, count) row of ``bsc`` (W <= 11), the
  pair ``bstart[h]``, ``bstart[h + 1]`` (W = 12), or a binary search of
  the sorted unique keys ``uhash`` and then ``ustart`` (W >= 13; a W-mer
  that is no key has count 0).

Pairs are in (unit, phase, bucket slot) order, so pair j is the JAX
pipeline's pair j, whose index is the emission key ``pair_order``.
``pos_total`` counts phase bits before the t16 filter and ``pair_total``
bucket slots after it, as the JAX totals do. At -N 1 the strict1 variant
runs the same code with ``t16_1`` in place of ``t16``.

``expand_loose`` is the loose branch of the same stages (``scan.py:775-795``,
``:863-871``), behind K8: the compacted item is a flagged stride group
(``stride`` phases, positions stride*q + d), its phase nibble is
``ptab``'s bits within the valid phases for a clean span and the valid
phases for a dirty one or without a ``ptab``, and there is neither a t16
filter nor K10.

``expand_raw`` is the unpacked branch (``scan.py:680-719``, ``:965-977``)
behind K9a: each flagged position of a raw-byte plane (one byte per
position) looks up the bucket of its W-mer; there is no phase stage, so
``pos_total`` is 0, as in the JAX totals of that path.

Kernel: ``csrc/expand.cu``, one launch per call in a unit mode, a group
mode and a raw mode (one item per flag word): each block takes a tile of
64 to 256 flag words (about 256 tiles per call), lists its items in
shared memory, works out each item's phase bits once (one item per
thread), writes one lane per (item, phase),
makes each lane's t16 test and bucket lookup once (one lane per thread)
and takes its pair base from a single-pass look-back scan; it writes the
pairs into buffers of ``tile_len / 16`` pairs and the totals into pinned
memory, so the one host read is a stream synchronise (beside them the
tile's front-end flag count, which that kernel leaves in the scan state
for ``front_end.flag_count``). Past that capacity
a second launch writes the pairs from the stored lanes into buffers of
exactly ``pair_total`` entries. Given ``totals``, the wrappers make the
same launch for the deferred tile scan (``ops.scan.dispatch_stream``):
the totals go to device memory, nothing is read, and a tile whose pairs
pass the buffer is rerun by the deferred scan. The lane buffers are scratch of
12 bytes per scan position of the tile. On the card it is bound by launch latency
and dependent gathers: only flagged items (a few per 10^3-10^4 on a clean
genome) gather from ``ptab``, ``t16`` and the CSR. ``expand_plain``,
``expand_loose_plain`` and ``expand_raw_plain`` are the same functions in
plain PyTorch; the wrappers use them only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .front_end import GOLD
from .units import (M32, group_regs, kernel_route, mask_bases, mul32,
                    raw_hashes, require, u32, unit_regs, units_of, valid_phases)

# bucket lookups, by the kind of ``csr`` argument (see ``_csr_kind``)
CSR_ROWS, CSR_STARTS, CSR_SEARCH = 0, 1, 2
# item modes of the kernel's C entries: units, stride groups, raw positions
STRICT, LOOSE, RAW = 0, 1, 2
# the one-launch path writes up to tile_len / PAIRS_PER_CAP pairs (at least
# 1024); more take a second launch (``pair_cap``)
PAIRS_PER_CAP = 16
# a test's smaller pair buffer (None: ``pair_cap``'s rule), to reach the
# second launch and the deferred scan's rerun on small inputs
_pair_cap_override = None


def pair_cap(tile_len: int) -> int:
    """Pairs of the first launch's buffers for a tile of ``tile_len``
    positions: tile_len / PAIRS_PER_CAP, at least 1024."""
    return _pair_cap_override or max(1024, tile_len // PAIRS_PER_CAP)


def _csr_kind(csr) -> int:
    """``csr`` is ``bsc`` int32[4^W, 2], ``bstart`` int32[4^W + 1], or the
    pair (``uhash`` int32[U] holding uint32 keys, ``ustart`` int32[U + 1])."""
    if isinstance(csr, (tuple, list)):
        uhash, ustart = csr
        if uhash.dim() != 1 or ustart.numel() != uhash.numel() + 1:
            raise ValueError("csr pair must be (uhash[U], ustart[U + 1])")
        return CSR_SEARCH
    if csr.dim() == 2 and csr.shape[1] == 2:
        return CSR_ROWS
    if csr.dim() == 1:
        return CSR_STARTS
    raise ValueError(f"csr of shape {tuple(csr.shape)} is no bucket table")


def csr_lookup(csr, phh, keep):
    """(start, count) of the buckets of W-mers ``phh`` (int64 values),
    count 0 where ``keep`` is false (``exact_csr``, ``scan.py:721-741``)."""
    kind = _csr_kind(csr)
    if kind == CSR_ROWS:
        sc = csr.to(torch.int64)[phh]
        return sc[:, 0], torch.where(keep, sc[:, 1], 0)
    if kind == CSR_STARTS:
        start = csr.to(torch.int64)[phh]
        return start, torch.where(keep, csr.to(torch.int64)[phh + 1] - start, 0)
    uhash, ustart = u32(csr[0]), csr[1].to(torch.int64)  # unsigned key order
    n_keys = uhash.numel()
    u = torch.searchsorted(uhash, phh)
    uc = u.clamp(max=n_keys - 1)
    found = (u < n_keys) & (uhash[uc] == phh) & keep
    start = ustart[uc]
    return start, torch.where(found, ustart[uc + 1] - start, 0)


def _bloom_phases(A, B, bloom, bloom_bits: int, W: int):
    """Bit d set iff phase d's W-mer (bases d..d+W-1 of the unit window)
    is a key of ``bloom``, or at 2W > bloom_bits shares the top bloom_bits
    bits of one (``scan.py:811-820``)."""
    m2w = mask_bases(W)
    shift = 2 * W - bloom_bits
    bl = u32(bloom)
    wbf = torch.zeros_like(A)
    for d in range(8):
        wm = (A >> (2 * d)) & m2w
        if 2 * (d + W) > 32:
            wm = wm | ((B << (32 - 2 * d)) & m2w)
        bk = wm >> shift
        wbf = wbf | (((bl[bk >> 5] >> (bk & 31)) & 1) << d)
    return wbf


def _flagged(words):
    """Ascending indices of the set bits of a tile's flag words."""
    w = u32(words)
    flags = ((w[:, None] >> torch.arange(32, device=w.device)) & 1).reshape(-1)
    return torch.nonzero(flags).flatten()


def _span_phases(Ak, Aak, nbv_g, pt, pf_bits: int, W: int, stride: int,
                 dirty_g=None):
    """Phase bits of one stride group (``ptab_bits`` ``scan.py:832-871``):
    a clean W+stride-1-base span trusts ptab's ``stride`` phase bits
    (32/stride span values per word) within the valid ones, a dirty span
    keeps its valid phases (``dirty_g``: those the K10 bloom kept)."""
    m2kb = mask_bases(W + stride - 1)
    per_word = 32 // stride
    kf = Ak & m2kb & ((1 << pf_bits) - 1)
    nbt = (pt[kf // per_word] >> ((kf % per_word) * stride)) & ((1 << stride) - 1)
    span_clean = (Aak & m2kb) == 0
    return torch.where(span_clean, nbt & nbv_g, nbv_g if dirty_g is None else dirty_g)


def phase_nibbles(tile, words, ptab, pf_bits: int, wordsize: int, lead: int,
                  n_scan: int, stride: int, exact_group: bool,
                  bloom=None, bloom_bits: int = 0):
    """(cpos, (A, Aa, B, Ba), nb) of a tile's strict-flagged units: their
    unit indices, window registers and phase nibbles, bit d of ``nb`` set
    iff phase d expands (the JAX stage's ``nb`` at ``stop="nb"``,
    ``scan.py:876-878``)."""
    W = wordsize
    cpos = _flagged(words)  # ascending flagged units
    units = units_of(tile[: tile.numel() // 4 * 4])
    A, Aa, B, Ba = unit_regs(units, cpos + lead // 8)
    nbv = valid_phases(Aa, Ba, cpos * 8, 8, W, n_scan)
    wbf = None if bloom is None else _bloom_phases(A, B, bloom, bloom_bits, W)
    if not exact_group:  # no phase table: every valid phase (scan.py:872-875)
        return cpos, (A, Aa, B, Ba), nbv if wbf is None else nbv & wbf
    pt = u32(ptab)
    ms = (1 << stride) - 1
    nb = torch.zeros_like(nbv)
    for p in range(8 // stride):  # the unit's stride groups
        sh = 2 * stride * p
        Ak = ((A >> sh) | (B << (32 - sh))) & M32 if sh else A
        Aak = ((Aa >> sh) | (Ba << (32 - sh))) & M32 if sh else Aa
        nbv_p = (nbv >> (stride * p)) & ms
        dirty_p = None if wbf is None else nbv_p & (wbf >> (stride * p)) & ms
        nb = nb | (_span_phases(Ak, Aak, nbv_p, pt, pf_bits, W, stride, dirty_p)
                   << (stride * p))
    return cpos, (A, Aa, B, Ba), nb


def group_nibbles(tile, words, ptab, pf_bits: int, wordsize: int, lead: int,
                  n_scan: int, stride: int, exact_group: bool):
    """(cpos, (A, Aa, B, Ba), nb) of a tile's loose-flagged stride groups:
    their group indices, window registers (``scan.py:777-795``) and
    ``stride``-phase nibbles (``:863-875``; the JAX stage's ``nb`` at
    ``stop="nb"``). The loose path has no K10 filter."""
    cpos = _flagged(words)  # ascending flagged groups
    units = units_of(tile[: tile.numel() // 4 * 4])
    A, Aa, B, Ba = group_regs(units, cpos, lead // 8, stride)
    nbv = valid_phases(Aa, Ba, cpos * stride, stride, wordsize, n_scan)
    if exact_group:
        nbv = _span_phases(A, Aa, nbv, u32(ptab), pf_bits, wordsize, stride)
    return cpos, (A, Aa, B, Ba), nbv


def _pairs(cpos, regs, nb, n_phases: int, t16, t16_bits: int, csr,
           n_entries: int, W: int):
    """(entry, ppos, pos_total, pair_total) of the phase bits ``nb`` of the
    compacted items ``cpos`` (``n_phases`` scan positions each), in (item,
    phase, bucket slot) order (``scan.py:880-964``)."""
    dev = nb.device
    A, Aa, B, Ba = regs
    d = torch.arange(n_phases, device=dev)
    sel = ((nb[:, None] >> d) & 1) == 1
    pos_total = int(sel.sum())
    ui, ph = torch.nonzero(sel, as_tuple=True)  # (item, phase) ascending
    Au, Bu = A[ui], B[ui]
    win = ((Au >> (2 * ph)) | (Bu << (32 - 2 * ph))) & M32  # bases ph..ph+15
    phh = win & mask_bases(W)
    pposx = cpos[ui] * n_phases + ph
    if t16_bits:
        va16 = ((Aa[ui] >> (2 * ph)) | (Ba[ui] << (32 - 2 * ph))) & M32
        bk = mul32(win, GOLD) >> (32 - t16_bits)
        keep = (((u32(t16)[bk >> 5] >> (bk & 31)) & 1) == 1) | (va16 != 0)
    else:
        keep = torch.ones_like(phh, dtype=torch.bool)
    start, cnt = csr_lookup(csr, phh, keep)
    entry, ppos, pair_total = _bucket_pairs(start, cnt, pposx, n_entries)
    return entry, ppos, pos_total, pair_total


def _bucket_pairs(start, cnt, pposx, n_entries: int):
    """(entry int32[P], ppos int32[P], pair_total) of the buckets (start,
    cnt) of positions ``pposx``, in (position, bucket slot) order
    (``scan.py:953-964``)."""
    pair_total = int(cnt.sum())
    src = torch.repeat_interleave(torch.arange(len(cnt), device=cnt.device), cnt)
    excl = torch.cumsum(cnt, 0) - cnt
    slot = torch.arange(pair_total, device=cnt.device) - excl[src]
    entry = (start[src] + slot).clamp(0, n_entries - 1)
    return entry.to(torch.int32), pposx[src].to(torch.int32), pair_total


def expand_plain(tile, words, ptab, pf_bits: int, t16, t16_bits: int, csr,
                 n_entries: int, wordsize: int, lead: int, tile_len: int,
                 n_scan: int, stride: int, exact_group: bool,
                 bloom=None, bloom_bits: int = 0):
    """(entry int32[P], ppos int32[P], pos_total, pair_total) of the strict
    expansion in plain PyTorch."""
    cpos, regs, nb = phase_nibbles(tile, words, ptab, pf_bits, wordsize, lead,
                                   n_scan, stride, exact_group, bloom, bloom_bits)
    return _pairs(cpos, regs, nb, 8, t16, t16_bits, csr, n_entries, wordsize)


def expand_loose_plain(tile, words, ptab, pf_bits: int, csr, n_entries: int,
                       wordsize: int, lead: int, tile_len: int, n_scan: int,
                       stride: int, exact_group: bool):
    """(entry int32[P], ppos int32[P], pos_total, pair_total) of the loose
    expansion in plain PyTorch: ``stride`` phases per flagged group, no
    t16."""
    cpos, regs, nb = group_nibbles(tile, words, ptab, pf_bits, wordsize, lead,
                                   n_scan, stride, exact_group)
    return _pairs(cpos, regs, nb, stride, None, 0, csr, n_entries, wordsize)


def _csr_tensors(csr) -> tuple:
    return tuple(csr) if isinstance(csr, (tuple, list)) else (csr,)


def _launch(mode: int, tile, words, ptab, pf_bits: int, t16, t16_bits: int,
            csr, n_entries: int, wordsize: int, lead: int, tile_len: int,
            n_scan: int, bloom, bloom_bits: int, stride: int,
            exact_group: bool, totals=None):
    """One launch of ``csrc/expand.cu`` and one host read of (pos_total,
    pair_total); the pairs are the first pair_total entries of buffers of
    ``cap`` pairs, or, past ``cap``, a second launch writes them into
    buffers of exactly pair_total entries. ``mode``: STRICT (units), LOOSE
    (stride groups) or RAW (flag words of a byte plane, 32 positions each;
    no ptab, t16 or bloom). With ``totals`` (the deferred mode) the kernel
    writes (c_total, pos_total, pair_total) into its first three device
    ints and the call returns the buffers of ``cap`` pairs, reading
    nothing."""
    kind = _csr_kind(csr)
    keys, *rest = _csr_tensors(csr)
    for t, name in ((words, "words"), (keys, "csr"), *((t, "ustart") for t in rest)):
        require(t, torch.int32, name)
    require(tile, torch.uint8, "tile")
    if totals is not None:
        require(totals, torch.int32, "totals")
    if mode != RAW:
        require(ptab, torch.int32, "ptab")
        if stride not in (2, 4):
            raise ValueError(f"stride {stride} is neither 2 nor 4")
    n_buckets = 1 << (2 * wordsize)
    if ((kind == CSR_ROWS and keys.shape[0] != n_buckets)
            or (kind == CSR_STARTS and keys.numel() != n_buckets + 1)):
        raise ValueError(f"csr of shape {tuple(keys.shape)} does not cover 4^{wordsize} buckets")
    if exact_group and ptab.numel() * 32 != stride << pf_bits:
        raise ValueError(f"ptab of {ptab.numel()} words is not 2^{pf_bits} span values")
    if t16 is not None:
        require(t16, torch.int32, "t16")
        if t16_bits and t16.numel() * 32 != 1 << t16_bits:
            raise ValueError(f"t16 of {t16.numel()} words is not 2^{t16_bits} bits")
    if bloom is not None:
        require(bloom, torch.int32, "bloom")
        if not 0 < bloom_bits <= 2 * wordsize or bloom.numel() * 32 != 1 << bloom_bits:
            raise ValueError(f"bloom of {bloom.numel()} words is not 2^{bloom_bits} bits")
    n_units = tile_len // 8
    if mode == RAW:  # flag words of 32 positions of a plane of bytes
        n_items, first, n_bytes = tile_len // 32, lead, lead + tile_len + wordsize - 1
    else:  # units or stride groups of a nibble plane
        n_items = n_units * (8 // stride) if mode == LOOSE else n_units
        first, n_bytes = lead // 2, lead // 2 + 4 * (n_units + 2)
    flag_bits = n_items * (32 if mode == RAW else 1)
    if words.numel() * 32 != flag_bits or tile.numel() < n_bytes:
        raise ValueError("words/tile do not match tile_len")
    dev = tile.device
    n_words = words.numel()
    P, I = kernels.P, kernels.I
    tiles = kernels.function("expand", "mp_expand_tiles", [I])
    n_tiles = tiles(n_words)  # tiles of flag words, one block each
    # a tile's lanes are among its scan positions: tile_len bounds them all
    lanes = torch.empty(3 * tile_len + 2 * n_tiles, dtype=torch.int32, device=dev)
    lane_ppos, lane_start, lane_off = (lanes[k * tile_len : (k + 1) * tile_len]
                                       for k in range(3))
    blk = lanes[3 * tile_len :]  # (lanes, pair base) per tile
    cap = pair_cap(tile_len)
    entry = torch.empty(cap, dtype=torch.int32, device=dev)
    ppos = torch.empty(cap, dtype=torch.int32, device=dev)
    fn = kernels.function(
        "expand", "mp_expand",
        [P, P, P, I, P, I, I, P, P, I, I, P, I, I, I, I, I, I,
         P, P, I, P, P, P, P, P, P, I, P, I, P])
    with kernels.on_device(tile):
        s = kernels.stream(tile)
        st = kernels.scan_state(tile)
        seq = st.tag(n_tiles)
        out = st.host if totals is None else totals
        kernels.call(
            fn, tile.data_ptr() + first, words.data_ptr(),
            ptab.data_ptr() if exact_group else None, pf_bits,
            None if t16 is None else t16.data_ptr(), t16_bits,
            kind, keys.data_ptr(), rest[0].data_ptr() if rest else None,
            keys.numel() if kind == CSR_SEARCH else 0, n_entries,
            None if bloom is None else bloom.data_ptr(),
            2 * wordsize - bloom_bits, wordsize, stride, n_words, n_scan, mode,
            st.ticket.data_ptr(), st.status.data_ptr(), seq, lane_ppos.data_ptr(),
            lane_start.data_ptr(), lane_off.data_ptr(), blk.data_ptr(),
            entry.data_ptr(), ppos.data_ptr(), cap, out.data_ptr(),
            int(totals is not None), s)
        if totals is not None:
            return entry, ppos
        pos_total, pair_total = st.read(2)
        if pair_total <= cap:
            return entry[:pair_total], ppos[:pair_total], pos_total, pair_total
        entry = torch.empty(pair_total, dtype=torch.int32, device=dev)
        ppos = torch.empty(pair_total, dtype=torch.int32, device=dev)
        overflow = kernels.function("expand", "mp_expand_overflow",
                                    [P, P, P, P, I, I, I, I, I, P, P, P])
        kernels.call(overflow, lane_ppos.data_ptr(), lane_start.data_ptr(),
                     lane_off.data_ptr(), blk.data_ptr(), n_words, mode, stride,
                     pair_total, n_entries, entry.data_ptr(), ppos.data_ptr(), s)
    return entry, ppos, pos_total, pair_total


def deferred_plain(out, c_total, totals, tile_len: int):
    """A plain version's ``out`` (entry, ppos, pos_total, pair_total) under
    the deferred mode's buffer contract: (c_total, pos_total, pair_total)
    into totals[0:3], at most ``pair_cap(tile_len)`` pairs kept."""
    entry, ppos, pos_total, pair_total = out
    totals[0], totals[1], totals[2] = int(c_total[0]), pos_total, pair_total
    cap = pair_cap(tile_len)
    return entry[:cap], ppos[:cap]


def expand(tile, words, ptab, pf_bits: int, t16, t16_bits: int, csr,
           n_entries: int, wordsize: int, lead: int, tile_len: int,
           n_scan: int, stride: int, exact_group: bool, bloom=None,
           bloom_bits: int = 0, totals=None, c_total=None):
    """Candidate pairs of one tile's strict-flagged units: the CUDA kernel
    for tensors on the card, ``expand_plain`` for CPU tensors.

    ``words``: the tile's flag words from ``front_end``; ``ptab``/``t16``:
    int32 words of the phase and 16-base tables (``t16``/``t16_1`` at
    -N 0/1), ``ptab`` read only with ``exact_group``; ``csr``: the bucket
    table over ``n_entries`` table entries, ``bsc`` int32[4^W, 2],
    ``bstart`` int32[4^W + 1] or the pair (``uhash``, ``ustart``)
    (``Table.csr``); ``bloom``: int32 words of the 2^bloom_bits-bit W-mer
    occupancy map, or None to leave the dirty-span filter (K10) off;
    ``stride``: scan positions per ptab group.

    ``totals`` None (count first): returns (entry, ppos, pos_total,
    pair_total) after one host read. ``totals`` given (the deferred mode of
    the tile scan, ``ops.scan``): the tile's five int32 totals on its
    device; one launch and no host read: the kernel writes (c_total,
    pos_total, pair_total) into totals[0:3], taking c_total from the scan
    state where the front end left it (on the CPU ``c_total``, the front
    end's count tensor, is read), and the call returns (entry, ppos),
    buffers of ``pair_cap(tile_len)`` pairs whose first min(pair_total,
    cap) entries are the pairs (a tile past cap is the deferred scan's to
    rerun). ``expand.launches`` counts the count-first launches,
    ``expand.launches_deferred`` the deferred ones."""
    tables = (ptab, t16, *_csr_tensors(csr)) + tuple(
        t for t in (bloom, totals) if t is not None)
    if not kernel_route(tile, words, *tables):
        out = expand_plain(tile, words, ptab, pf_bits, t16, t16_bits, csr,
                           n_entries, wordsize, lead, tile_len, n_scan,
                           stride, exact_group, bloom, bloom_bits)
        return out if totals is None else deferred_plain(out, c_total, totals, tile_len)
    out = _launch(STRICT, tile, words, ptab, pf_bits, t16, t16_bits, csr,
                  n_entries, wordsize, lead, tile_len, n_scan, bloom,
                  bloom_bits, stride, exact_group, totals)
    kernels.count_launch(expand, totals is not None)
    return out


expand.launches = expand.launches_deferred = 0


def expand_loose(tile, words, ptab, pf_bits: int, csr, n_entries: int,
                 wordsize: int, lead: int, tile_len: int, n_scan: int,
                 stride: int, exact_group: bool, totals=None, c_total=None):
    """Candidate pairs of one tile's loose-flagged stride groups (the
    loose branch of K3 with K5): the CUDA kernel for tensors on the card,
    ``expand_loose_plain`` for CPU tensors.

    ``words``: the tile's group-ordered flag words from
    ``front_end_loose``; ``csr``, ``totals``, ``c_total``, the result and
    the counts as for ``expand``, the pairs in (group, phase, bucket slot)
    order."""
    extra = () if totals is None else (totals,)
    if not kernel_route(tile, words, ptab, *_csr_tensors(csr), *extra):
        out = expand_loose_plain(tile, words, ptab, pf_bits, csr, n_entries,
                                 wordsize, lead, tile_len, n_scan, stride,
                                 exact_group)
        return out if totals is None else deferred_plain(out, c_total, totals, tile_len)
    out = _launch(LOOSE, tile, words, ptab, pf_bits, None, 0, csr, n_entries,
                  wordsize, lead, tile_len, n_scan, None, 0, stride, exact_group,
                  totals)
    kernels.count_launch(expand_loose, totals is not None)
    return out


expand_loose.launches = expand_loose.launches_deferred = 0


def expand_raw_plain(tile, words, csr, n_entries: int, wordsize: int,
                     lead: int, tile_len: int, n_scan: int):
    """K9b in plain PyTorch: (entry int32[P], ppos int32[P], pos_total = 0,
    pair_total) of a raw-byte tile's flagged positions, each through the
    bucket of its W-mer (``scan.py:965-977``, ``exact_csr`` ``:721-741``)."""
    cpos = _flagged(words)  # ascending flagged positions
    h, _amb = raw_hashes(tile, cpos + lead, wordsize)
    start, cnt = csr_lookup(csr, h, torch.ones_like(h, dtype=torch.bool))
    entry, ppos, pair_total = _bucket_pairs(start, cnt, cpos, n_entries)
    return entry, ppos, 0, pair_total


def expand_raw(tile, words, csr, n_entries: int, wordsize: int, lead: int,
               tile_len: int, n_scan: int, totals=None, c_total=None):
    """K9b: candidate pairs of a raw-byte tile (one byte per position), the
    CUDA kernel (the raw mode of ``csrc/expand.cu``) for tensors on the
    card, ``expand_raw_plain`` for CPU tensors.

    ``words``: the tile's flag words from ``front_end_raw``, one bit per
    position; ``csr``, ``totals``, ``c_total``, the result and the counts
    as for ``expand``, the pairs in (position, bucket slot) order;
    ``pos_total`` is 0, as in the JAX totals of this path
    (``scan.py:967``)."""
    extra = () if totals is None else (totals,)
    if not kernel_route(tile, words, *_csr_tensors(csr), *extra):
        out = expand_raw_plain(tile, words, csr, n_entries, wordsize, lead,
                               tile_len, n_scan)
        return out if totals is None else deferred_plain(out, c_total, totals, tile_len)
    out = _launch(RAW, tile, words, None, 0, None, 0, csr, n_entries, wordsize,
                  lead, tile_len, n_scan, None, 0, 1, False, totals)
    kernels.count_launch(expand_raw, totals is not None)
    return out


expand_raw.launches = expand_raw.launches_deferred = 0
