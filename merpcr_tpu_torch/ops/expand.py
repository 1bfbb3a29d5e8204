"""K2-K5 and K10 ``expand``: flagged units -> candidate (entry, position)
pairs.

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
bucket slots after it, as the JAX totals do.

Kernel: ``csrc/expand.cu``, reduce-then-scan with recompute (count pass,
one single-block scan of the block sums, write pass). Its output buffers
are sized from the count pass, which costs one host read of
``pair_total`` per tile. On the card it is bound by memory latency: only
flagged units (a few per 10^4) gather from ``ptab``, ``t16`` and ``bsc``.
``expand_plain`` is the same function in plain PyTorch; the wrapper uses
it only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .units import M32, kernel_route, mul32, require, u32, unit_regs, units_of

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


def phase_nibbles(tile, words, ptab, pf_bits: int, wordsize: int, lead: int,
                  n_scan: int, bloom=None, bloom_bits: int = 0):
    """(cpos, (A, Aa, B, Ba), nb) of a tile's flagged units: their unit
    indices, window registers and phase nibbles, bit d of ``nb`` set iff
    phase d expands (the JAX stage's ``nb`` at ``stop="nb"``,
    ``scan.py:876-878``)."""
    dev = tile.device
    W = wordsize
    m2w = (1 << (2 * W)) - 1
    w = u32(words)
    flags = ((w[:, None] >> torch.arange(32, device=dev)) & 1).reshape(-1)
    cpos = torch.nonzero(flags).flatten()  # ascending flagged units
    units = units_of(tile[: tile.numel() // 4 * 4])
    A, Aa, B, Ba = unit_regs(units, cpos + lead // 8)

    d = torch.arange(8, device=dev)
    # bases d .. d+W-1 (the spill from B is masked off where it is unused)
    pha = ((Aa[:, None] >> (2 * d)) | (Ba[:, None] << (32 - 2 * d))) & m2w
    ok = (pha == 0) & (cpos[:, None] * 8 + d < n_scan)
    nbv = (ok.to(torch.int64) << d).sum(dim=1)
    m2kb = (1 << (2 * (W + _STRIDE - 1))) - 1
    m2pf = (1 << pf_bits) - 1
    pt = u32(ptab)
    wbf = None if bloom is None else _bloom_phases(A, B, bloom, bloom_bits, W)
    nb = torch.zeros_like(nbv)
    for p in range(2):  # the unit's two stride-4 groups
        sh = 2 * _STRIDE * p
        Ak = ((A >> sh) | (B << (32 - sh))) & M32 if sh else A
        Aak = ((Aa >> sh) | (Ba << (32 - sh))) & M32 if sh else Aa
        kf = Ak & m2kb & m2pf
        nbt = (pt[kf >> 3] >> ((kf & 7) * 4)) & 0xF
        nbv_p = (nbv >> (4 * p)) & 0xF
        span_clean = (Aak & m2kb) == 0
        dirty_p = nbv_p if wbf is None else nbv_p & ((wbf >> (4 * p)) & 0xF)
        nb = nb | (torch.where(span_clean, nbt & nbv_p, dirty_p) << (4 * p))
    return cpos, (A, Aa, B, Ba), nb


def expand_plain(tile, words, ptab, pf_bits: int, t16, t16_bits: int, bsc,
                 n_entries: int, wordsize: int, lead: int, tile_len: int,
                 n_scan: int, bloom=None, bloom_bits: int = 0):
    """(entry int32[P], ppos int32[P], pos_total, pair_total) in plain
    PyTorch."""
    dev = tile.device
    W = wordsize
    m2w = (1 << (2 * W)) - 1
    cpos, (A, Aa, B, Ba), nb = phase_nibbles(tile, words, ptab, pf_bits, W, lead,
                                              n_scan, bloom, bloom_bits)
    d = torch.arange(8, device=dev)
    sel = ((nb[:, None] >> d) & 1) == 1
    pos_total = int(sel.sum())
    ui, ph = torch.nonzero(sel, as_tuple=True)  # (unit, phase) ascending
    Au, Bu = A[ui], B[ui]
    win = ((Au >> (2 * ph)) | (Bu << (32 - 2 * ph))) & M32  # bases ph..ph+15
    phh = win & m2w
    pposx = cpos[ui] * 8 + ph
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


def expand(tile, words, ptab, pf_bits: int, t16, t16_bits: int, bsc,
           n_entries: int, wordsize: int, lead: int, tile_len: int,
           n_scan: int, bloom=None, bloom_bits: int = 0):
    """Candidate pairs of one tile: the CUDA kernel for tensors on the
    card, ``expand_plain`` for CPU tensors.

    ``words``: the tile's flag words from ``front_end``; ``ptab``/``t16``:
    int32 words of the phase and 16-base tables; ``bsc``: int32[4^W, 2]
    CSR rows over ``n_entries`` table entries; ``bloom``: int32 words of
    the 2^bloom_bits-bit W-mer occupancy map, or None to leave the
    dirty-span filter (K10) off. Returns (entry, ppos, pos_total,
    pair_total)."""
    tables = (ptab, t16, bsc) + (() if bloom is None else (bloom,))
    if not kernel_route(tile, words, *tables):
        return expand_plain(tile, words, ptab, pf_bits, t16, t16_bits, bsc,
                            n_entries, wordsize, lead, tile_len, n_scan,
                            bloom, bloom_bits)
    for t, name in ((words, "words"), (ptab, "ptab"), (t16, "t16"), (bsc, "bsc")):
        require(t, torch.int32, name)
    require(tile, torch.uint8, "tile")
    if wordsize > 11:
        raise ValueError("the dense CSR exists for W <= 11 only")
    if bloom is not None:
        require(bloom, torch.int32, "bloom")
        if not 0 < bloom_bits <= 2 * wordsize or bloom.numel() * 32 != 1 << bloom_bits:
            raise ValueError(f"bloom of {bloom.numel()} words is not 2^{bloom_bits} bits")
    n_units = tile_len // 8
    if words.numel() * 32 != n_units or tile.numel() < lead // 2 + 4 * (n_units + 2):
        raise ValueError("words/tile do not match tile_len")
    dev = tile.device
    n_blk = -(-n_units // 256)
    blk = torch.empty(2 * n_blk, dtype=torch.int32, device=dev)
    totals = torch.zeros(2, dtype=torch.int32, device=dev)
    P, I = kernels.P, kernels.I
    args = (tile.data_ptr() + lead // 2, words.data_ptr(), ptab.data_ptr(),
            pf_bits, t16.data_ptr(), t16_bits, bsc.data_ptr(), n_entries,
            None if bloom is None else bloom.data_ptr(),
            2 * wordsize - bloom_bits, wordsize, n_units, n_scan)
    sig = [P, P, P, I, P, I, P, I, P, I, I, I, I]
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
    expand.launches += 1
    return entry, ppos, pos_total, pair_total


expand.launches = 0
