"""K2-K5 and K10 ``expand`` (strict) and ``expand_loose``: flagged units
or stride-4 groups -> candidate (entry, position) pairs.

Replaces ``merpcr_tpu/ops/scan.py::_scan_tile_impl`` stages K2-K5: the
flag-word compaction (``scan.py:680-719``, ``_rank_invert`` ``:317-341``,
``_blocked_scan`` ``:287-314``), the strict phase expansion through the
exact phase table ``ptab`` (``:757-927``; ``ptab_bits`` ``:832-862``), the
hashed 16-base position filter ``t16`` (``:929-949``) and the dense W <= 11
CSR pair expansion (``exact_csr`` ``:728-730``, ``:953-964``); and K10, the
dirty-span phase filter (``dirty_bloom``, ``:803-822`` applied at
``:859-861``): when ``bloom`` is given, a phase of a unit whose stride-4
span is dirty survives only if its W-mer is a key of the table's
occupancy bitmap ``bloom``. Ambiguity-heavy genomes (1 % scattered IUPAC
letters flag ~12 % of units) would otherwise expand every clean phase of
every such unit through the CSR.

Pairs are in (unit, phase, bucket slot) order, so pair j is the JAX
pipeline's pair j, whose index is the emission key ``pair_order``.
``pos_total`` counts phase bits before the t16 filter and ``pair_total``
bucket slots after it, as the JAX totals do. At -N 1 the strict1 variant
runs the same code with ``t16_1`` in place of ``t16``.

``expand_loose`` is the loose branch of the same stages (``scan.py:775-795``,
``:863-871``), behind K8: the compacted item is a flagged stride-4 group
(4 phases, positions 4q + d), its phase nibble is ``ptab``'s bits within
the valid phases for a clean span and the valid phases for a dirty one,
and there is neither a t16 filter nor K10.

Kernel: ``csrc/expand.cu``, reduce-then-scan with recompute (count pass,
one single-block scan of the block sums, write pass), in a unit mode and
a group mode. Its output buffers are sized from the count pass, which
costs one host read of ``pair_total`` per tile. On the card it is bound
by memory latency: only flagged items (a few per 10^3-10^4) gather from
``ptab``, ``t16`` and ``bsc``. ``expand_plain`` and ``expand_loose_plain``
are the same functions in plain PyTorch; the wrappers use them only for
CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .units import (M32, group_regs, kernel_route, mul32, require, u32,
                    unit_regs, units_of, valid_phases)

_GOLD = 0x9E3779B1  # t16 multiplicative hash
_STRIDE = 4  # ptab span group (the table compiler's stride for W <= 11)


def _bloom_phases(A, B, bloom, bloom_bits: int, W: int):
    """Bit d set iff phase d's W-mer (bases d..d+W-1 of the unit window)
    is a key of ``bloom`` (``scan.py:811-820``)."""
    m2w = (1 << (2 * W)) - 1
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


def _span_phases(Ak, Aak, nbv_g, pt, pf_bits: int, W: int, dirty_g=None):
    """Phase nibble of one stride-4 group (``ptab_bits`` ``scan.py:832-871``):
    a clean 14-base span trusts ptab's phase bits within the valid ones, a
    dirty span keeps its valid phases (``dirty_g``: those the K10 bloom
    kept)."""
    m2kb = (1 << (2 * (W + _STRIDE - 1))) - 1
    kf = Ak & m2kb & ((1 << pf_bits) - 1)
    nbt = (pt[kf >> 3] >> ((kf & 7) * 4)) & 0xF
    span_clean = (Aak & m2kb) == 0
    return torch.where(span_clean, nbt & nbv_g, nbv_g if dirty_g is None else dirty_g)


def phase_nibbles(tile, words, ptab, pf_bits: int, wordsize: int, lead: int,
                  n_scan: int, bloom=None, bloom_bits: int = 0):
    """(cpos, (A, Aa, B, Ba), nb) of a tile's strict-flagged units: their
    unit indices, window registers and phase nibbles, bit d of ``nb`` set
    iff phase d expands (the JAX stage's ``nb`` at ``stop="nb"``,
    ``scan.py:876-878``)."""
    W = wordsize
    cpos = _flagged(words)  # ascending flagged units
    units = units_of(tile[: tile.numel() // 4 * 4])
    A, Aa, B, Ba = unit_regs(units, cpos + lead // 8)
    nbv = valid_phases(Aa, Ba, cpos * 8, 8, W, n_scan)
    pt = u32(ptab)
    wbf = None if bloom is None else _bloom_phases(A, B, bloom, bloom_bits, W)
    nb = torch.zeros_like(nbv)
    for p in range(2):  # the unit's two stride-4 groups
        sh = 2 * _STRIDE * p
        Ak = ((A >> sh) | (B << (32 - sh))) & M32 if sh else A
        Aak = ((Aa >> sh) | (Ba << (32 - sh))) & M32 if sh else Aa
        nbv_p = (nbv >> (4 * p)) & 0xF
        dirty_p = None if wbf is None else nbv_p & ((wbf >> (4 * p)) & 0xF)
        nb = nb | (_span_phases(Ak, Aak, nbv_p, pt, pf_bits, W, dirty_p) << (4 * p))
    return cpos, (A, Aa, B, Ba), nb


def group_nibbles(tile, words, ptab, pf_bits: int, wordsize: int, lead: int,
                  n_scan: int):
    """(cpos, (A, Aa, B, Ba), nb) of a tile's loose-flagged stride-4 groups:
    their group indices, window registers (``scan.py:777-795``) and
    4-phase nibbles (``:863-871``; the JAX stage's ``nb`` at
    ``stop="nb"``). The loose path has no K10 filter."""
    cpos = _flagged(words)  # ascending flagged groups
    units = units_of(tile[: tile.numel() // 4 * 4])
    A, Aa, B, Ba = group_regs(units, cpos, lead // 8)
    nbv = valid_phases(Aa, Ba, cpos * 4, 4, wordsize, n_scan)
    return cpos, (A, Aa, B, Ba), _span_phases(A, Aa, nbv, u32(ptab), pf_bits, wordsize)


def _pairs(cpos, regs, nb, n_phases: int, t16, t16_bits: int, bsc,
           n_entries: int, W: int):
    """(entry, ppos, pos_total, pair_total) of the phase bits ``nb`` of the
    compacted items ``cpos`` (``n_phases`` scan positions each), in (item,
    phase, bucket slot) order (``scan.py:880-964``)."""
    dev = nb.device
    A, Aa, B, Ba = regs
    m2w = (1 << (2 * W)) - 1
    d = torch.arange(n_phases, device=dev)
    sel = ((nb[:, None] >> d) & 1) == 1
    pos_total = int(sel.sum())
    ui, ph = torch.nonzero(sel, as_tuple=True)  # (item, phase) ascending
    Au, Bu = A[ui], B[ui]
    win = ((Au >> (2 * ph)) | (Bu << (32 - 2 * ph))) & M32  # bases ph..ph+15
    phh = win & m2w
    pposx = cpos[ui] * n_phases + ph
    if t16_bits:
        va16 = ((Aa[ui] >> (2 * ph)) | (Ba[ui] << (32 - 2 * ph))) & M32
        bk = mul32(win, _GOLD) >> (32 - t16_bits)
        keep = (((u32(t16)[bk >> 5] >> (bk & 31)) & 1) == 1) | (va16 != 0)
    else:
        keep = torch.ones_like(phh, dtype=torch.bool)
    sc = bsc.to(torch.int64)[phh]
    start = sc[:, 0]
    cnt = torch.where(keep, sc[:, 1], 0)
    pair_total = int(cnt.sum())
    src = torch.repeat_interleave(torch.arange(len(cnt), device=dev), cnt)
    excl = torch.cumsum(cnt, 0) - cnt
    slot = torch.arange(pair_total, device=dev) - excl[src]
    entry = (start[src] + slot).clamp(0, n_entries - 1)
    return (entry.to(torch.int32), pposx[src].to(torch.int32), pos_total,
            pair_total)


def expand_plain(tile, words, ptab, pf_bits: int, t16, t16_bits: int, bsc,
                 n_entries: int, wordsize: int, lead: int, tile_len: int,
                 n_scan: int, bloom=None, bloom_bits: int = 0):
    """(entry int32[P], ppos int32[P], pos_total, pair_total) of the strict
    expansion in plain PyTorch."""
    cpos, regs, nb = phase_nibbles(tile, words, ptab, pf_bits, wordsize, lead,
                                   n_scan, bloom, bloom_bits)
    return _pairs(cpos, regs, nb, 8, t16, t16_bits, bsc, n_entries, wordsize)


def expand_loose_plain(tile, words, ptab, pf_bits: int, bsc, n_entries: int,
                       wordsize: int, lead: int, tile_len: int, n_scan: int):
    """(entry int32[P], ppos int32[P], pos_total, pair_total) of the loose
    expansion in plain PyTorch: 4 phases per flagged group, no t16."""
    cpos, regs, nb = group_nibbles(tile, words, ptab, pf_bits, wordsize, lead, n_scan)
    return _pairs(cpos, regs, nb, 4, None, 0, bsc, n_entries, wordsize)


def _launch(loose: bool, tile, words, ptab, pf_bits: int, t16, t16_bits: int,
            bsc, n_entries: int, wordsize: int, lead: int, tile_len: int,
            n_scan: int, bloom, bloom_bits: int):
    """Count pass, block-sum scan, one host read of the totals, write pass
    into buffers of exactly pair_total entries."""
    for t, name in ((words, "words"), (ptab, "ptab"), (bsc, "bsc")):
        require(t, torch.int32, name)
    require(tile, torch.uint8, "tile")
    if wordsize > 11:
        raise ValueError("the dense CSR exists for W <= 11 only")
    if t16 is not None:
        require(t16, torch.int32, "t16")
        if t16_bits and t16.numel() * 32 != 1 << t16_bits:
            raise ValueError(f"t16 of {t16.numel()} words is not 2^{t16_bits} bits")
    if bloom is not None:
        require(bloom, torch.int32, "bloom")
        if not 0 < bloom_bits <= 2 * wordsize or bloom.numel() * 32 != 1 << bloom_bits:
            raise ValueError(f"bloom of {bloom.numel()} words is not 2^{bloom_bits} bits")
    n_units = tile_len // 8
    n_items = 2 * n_units if loose else n_units  # stride-4 groups or units
    if words.numel() * 32 != n_items or tile.numel() < lead // 2 + 4 * (n_units + 2):
        raise ValueError("words/tile do not match tile_len")
    dev = tile.device
    n_blk = -(-n_items // 256)
    blk = torch.empty(2 * n_blk, dtype=torch.int32, device=dev)
    totals = torch.zeros(2, dtype=torch.int32, device=dev)
    P, I = kernels.P, kernels.I
    args = (tile.data_ptr() + lead // 2, words.data_ptr(), ptab.data_ptr(),
            pf_bits, None if t16 is None else t16.data_ptr(), t16_bits,
            bsc.data_ptr(), n_entries, None if bloom is None else bloom.data_ptr(),
            2 * wordsize - bloom_bits, wordsize, n_items, n_scan, int(loose))
    sig = [P, P, P, I, P, I, P, I, P, I, I, I, I, I]
    count = kernels.function("expand", "mp_expand_count", sig + [P, P, P, P])
    write = kernels.function("expand", "mp_expand_write", sig + [P, P, P, P])
    s = kernels.stream(tile)
    blk_sums, blk_off = blk[:n_blk], blk[n_blk:]
    kernels.call(count, *args, blk_sums.data_ptr(), blk_off.data_ptr(),
                 totals.data_ptr(), s)
    pos_total, pair_total = (int(v) for v in totals.tolist())
    entry = torch.empty(pair_total, dtype=torch.int32, device=dev)
    ppos = torch.empty(pair_total, dtype=torch.int32, device=dev)
    if pair_total:
        kernels.call(write, *args, blk_off.data_ptr(), entry.data_ptr(),
                     ppos.data_ptr(), s)
    return entry, ppos, pos_total, pair_total


def expand(tile, words, ptab, pf_bits: int, t16, t16_bits: int, bsc,
           n_entries: int, wordsize: int, lead: int, tile_len: int,
           n_scan: int, bloom=None, bloom_bits: int = 0):
    """Candidate pairs of one tile's strict-flagged units: the CUDA kernel
    for tensors on the card, ``expand_plain`` for CPU tensors.

    ``words``: the tile's flag words from ``front_end``; ``ptab``/``t16``:
    int32 words of the phase and 16-base tables (``t16``/``t16_1`` at
    -N 0/1); ``bsc``: int32[4^W, 2] CSR rows over ``n_entries`` table
    entries; ``bloom``: int32 words of the 2^bloom_bits-bit W-mer
    occupancy map, or None to leave the dirty-span filter (K10) off.
    Returns (entry, ppos, pos_total, pair_total)."""
    tables = (ptab, t16, bsc) + (() if bloom is None else (bloom,))
    if not kernel_route(tile, words, *tables):
        return expand_plain(tile, words, ptab, pf_bits, t16, t16_bits, bsc,
                            n_entries, wordsize, lead, tile_len, n_scan,
                            bloom, bloom_bits)
    out = _launch(False, tile, words, ptab, pf_bits, t16, t16_bits, bsc,
                  n_entries, wordsize, lead, tile_len, n_scan, bloom, bloom_bits)
    expand.launches += 1
    return out


expand.launches = 0


def expand_loose(tile, words, ptab, pf_bits: int, bsc, n_entries: int,
                 wordsize: int, lead: int, tile_len: int, n_scan: int):
    """Candidate pairs of one tile's loose-flagged stride-4 groups (the
    loose branch of K3 with K5): the CUDA kernel for tensors on the card,
    ``expand_loose_plain`` for CPU tensors.

    ``words``: the tile's group-ordered flag words from
    ``front_end_loose``. Returns (entry, ppos, pos_total, pair_total), the
    pairs in (group, phase, bucket slot) order."""
    if not kernel_route(tile, words, ptab, bsc):
        return expand_loose_plain(tile, words, ptab, pf_bits, bsc, n_entries,
                                  wordsize, lead, tile_len, n_scan)
    out = _launch(True, tile, words, ptab, pf_bits, None, 0, bsc, n_entries,
                  wordsize, lead, tile_len, n_scan, None, 0)
    expand_loose.launches += 1
    return out


expand_loose.launches = 0
