"""The three front ends of a tile: K1 ``front_end`` (strict), K8
``front_end_loose`` and K9a ``front_end_raw`` (raw-byte planes).

K1 replaces ``merpcr_tpu/ops/scan.py::_scan_tile_impl``, packed decode and
strict branch (``scan.py:452-502``, ``:522-578``; ``_bit_at`` ``:252``).
For every u32 unit (8 scan positions) of the tile's scan span: one bit of
the strict table keyed by window bases 7..19, an exact-width OR-smear
telling whether some phase's W-mer window is clean, and ``flag = in bounds
& some clean phase & (table hit | dirty key)``. Flags are packed LSB-first
into 32-unit words; ``c_total`` counts them. The table is ``qbloom_s`` at
-N 0 and ``qbloom_s1`` (the strict1 variant) at -N 1.

K8 replaces the loose branch (``scan.py:579-659``), which -N >= 2, -N 1
without strict1, and STS sets that disarm strict take: one bit of the
group table ``qbloom`` per stride group, flags in group order. The word
size picks the table (``table.py:567-574``): W <= 11 an exact table over
the W+3-base span of 4 scan positions (two groups per unit); W = 12, 13
an exact table over the W+1-base span of 2 positions (four groups per
unit, K12a); W >= 14 a mult-hash bloom over the first min(16, W+1) bases
of that span (``scan.py:605-611``). K1 is the same at every W: its table
keys fixed window bases.

K9a replaces the unpacked branch (``scan.py:660-678``, ``bloom_flag``
``:445-450``), which records with bytes outside the 16-letter alphabet
take at every -N: the plane holds one byte per position, each scan
position hashes its W bytes (``units.scode``: A, C, G, T/U in either case,
every other byte ambiguous), and a clean W-mer is flagged when the table's
occupancy map ``bloom`` holds its top ``bloom_bits`` bits (exact at
2W <= 24, a prefix filter above). One bit per position.

Kernels: ``csrc/front_end.cu``, one launch per call each, with no fill
and no copy. Each item (unit, group or position) reads its plane bytes once
and looks one key up in an 0.5-32 MB table; a random 4-byte gather there
costs a 32-byte L2 sector, which bounds the strict kernel. K1 takes 4
units per thread from one 16-byte load and issues its 4 table gathers back
to back. K8 and K9a first test a prefilter, the table folded to at most
2^19 bits (``Table.loose_prefilter``/``raw_prefilter``, ``table.fold_bits``),
staged in shared memory by about one block per SM, and gather from the
full table only where its bit is set
(0.2-3 % of the items on a random genome); K8 takes 4 units per thread,
K9a 16 positions with a rolling W-mer (one new code per position). In all
three the block that finishes last (one 64-bit atomic per block carries
its count and its completion) writes ``c_total`` and leaves the count in
the device's scan state, which the tile's ``expand`` hands to the host
with its own totals (``flag_count`` reads it there). ``front_end_plain``,
``front_end_loose_plain`` and ``front_end_raw_plain`` are the same
functions in plain PyTorch; the wrappers use them only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .units import (M32, group_regs, kernel_route, mask_bases, mul32, raw_hashes,
                    require, to_i32, u32, unit_regs, units_of, valid_phases)

_PROJ_SHIFT = 14  # 2 * PROJ_UNIT_START: the key starts at window base 7
_PROJ_HI = 0xFF  # bases 16..19 come from the B register
GOLD = 0x9E3779B1  # multiplier of the hashed tables (t16, mult-hash qbloom)
HOST_WORD = 2  # the strict kernel's c_total in ``ScanState.host``, via expand


def _dirty_smear(Aa, Ba, W: int):
    """Field d of the result is nonzero iff bases d..d+W-1 hold a dirty
    base (scan.py:546-560)."""
    lo, hi = [Aa], [Ba]
    for k in range(1, 5):
        s = 1 << k
        lo.append(lo[-1] | (lo[-1] >> s) | ((hi[-1] << (32 - s)) & M32))
        hi.append(hi[-1] | (hi[-1] >> s))
    acc = torch.zeros_like(Aa)
    got = 0
    for k in range(4, -1, -1):
        if W & (1 << k):
            s = 2 * got
            acc = acc | (lo[k] if s == 0 else (lo[k] >> s) | ((hi[k] << (32 - s)) & M32))
            got += 1 << k
    return acc


def _check(tile, lead: int, tile_len: int, n_scan: int) -> int:
    n_units = tile_len // 8
    if not 0 <= n_scan <= tile_len:
        raise ValueError(f"n_scan {n_scan} outside [0, {tile_len}]")
    if tile_len % 256:
        raise ValueError(f"tile_len {tile_len} is not a multiple of 256")
    if lead % 32:
        raise ValueError(f"lead {lead} is not a multiple of 32")
    if tile.numel() < lead // 2 + 4 * (n_units + 2):
        raise ValueError("tile plane shorter than lead + tile_len + 3 units")
    return n_units


def front_end_plain(tile, qbloom_s, gq: int, wordsize: int, lead: int,
                    tile_len: int, n_scan: int):
    """(words int32[tile_len/256], c_total int32[1]) in plain PyTorch."""
    n_units = _check(tile, lead, tile_len, n_scan)
    units = units_of(tile[: tile.numel() // 4 * 4])
    r = torch.arange(n_units, device=tile.device)
    A, Aa, B, Ba = unit_regs(units, r + lead // 8)
    kfull = (A >> _PROJ_SHIFT) | ((B & _PROJ_HI) << (32 - _PROJ_SHIFT))
    vfull = (Aa >> _PROJ_SHIFT) | ((Ba & _PROJ_HI) << (32 - _PROJ_SHIFT))
    m2q = (1 << gq) - 1
    bk = kfull & m2q
    key_clean = (vfull & m2q) == 0
    hit = ((u32(qbloom_s)[bk >> 5] >> (bk & 31)) & 1) == 1
    acc = _dirty_smear(Aa, Ba, wordsize)
    some_phase_clean = ((acc | (acc >> 1)) & 0x5555) != 0x5555
    flag = some_phase_clean & (r * 8 < n_scan) & (hit | ~key_clean)
    lanes = torch.arange(32, device=tile.device)
    words = (flag.view(-1, 32).to(torch.int64) << lanes).sum(dim=1)
    c_total = flag.sum().to(torch.int32).reshape(1)
    return to_i32(words), c_total


def front_end(tile, qbloom_s, gq: int, wordsize: int, lead: int,
              tile_len: int, n_scan: int):
    """Flag words and c_total of one tile: the CUDA kernel for tensors on
    the card, ``front_end_plain`` for CPU tensors.

    ``tile``: uint8 plane of the halo-padded tile (2 bases per byte);
    ``qbloom_s``: int32 words of the strict table (2^gq bits). On the card
    the call is one launch: the kernel writes ``c_total`` and leaves the
    count in the device's scan state, which the tile's ``expand`` hands to
    the host (``flag_count``)."""
    if not kernel_route(tile, qbloom_s):
        return front_end_plain(tile, qbloom_s, gq, wordsize, lead, tile_len, n_scan)
    require(tile, torch.uint8, "tile")
    require(qbloom_s, torch.int32, "qbloom_s")
    n_units = _check(tile, lead, tile_len, n_scan)
    units = tile.data_ptr() + lead // 2
    if units % 4:
        raise ValueError("tile plane is not 4-byte aligned")
    words = torch.empty(n_units // 32, dtype=torch.int32, device=tile.device)
    c_total = torch.empty(1, dtype=torch.int32, device=tile.device)
    P, I = kernels.P, kernels.I
    fn = kernels.function("front_end", "mp_front_end",
                          [P, P, I, I, I, I, I, P, P, P, P])
    with kernels.on_device(tile):
        st = kernels.scan_state(tile)
        kernels.call(
            fn, units, qbloom_s.data_ptr(), gq, wordsize, n_units, n_scan,
            int(units % 16 == 0), words.data_ptr(), st.ticket.data_ptr(),
            c_total.data_ptr(), kernels.stream(tile),
        )
    front_end.launches += 1
    return words, c_total


def flag_count(c_total: torch.Tensor) -> int:
    """``c_total`` of a tile's front end (``front_end``, ``front_end_loose``
    or ``front_end_raw``) as an int, once the tile's ``expand`` has run. A
    CPU tensor gives its value; on the card that ``expand`` wrote the count
    into the device's pinned host word with its own totals, read here (no
    copy). The word holds the count of the device's latest front end that
    an ``expand`` followed."""
    if not c_total.is_cuda:
        return int(c_total.item())
    return kernels.scan_state(c_total).read(HOST_WORD + 1)[HOST_WORD]


front_end.launches = 0


def front_end_loose_plain(tile, qbloom, q_bits: int, wordsize: int, lead: int,
                          tile_len: int, n_scan: int, stride: int,
                          qbloom_bits: int):
    """K8 in plain PyTorch: (words int32[tile_len/(32*stride)], c_total
    int32[1]) of the loose front end (``scan.py:579-659``).

    Group q = P*r + p (P = 8/stride) covers scan positions stride*q ..
    stride*q + stride-1 of unit r. Its flag is ``some in-bounds phase has
    a clean W-mer & (qbloom holds its key | the keyed bases are dirty)``.
    The key is the low q_bits bits of the span value for an exact table
    (``qbloom_bits`` 0) and ``(first 16 span bases * 0x9E3779B1) >> (32 -
    qbloom_bits)`` for the mult-hash bloom of the wide words
    (``:605-611``). Flags are packed LSB-first in group order, so bit
    q & 31 of word q >> 5 (the JAX stage's parity interleave,
    ``_spread``)."""
    _check(tile, lead, tile_len, n_scan)
    W = wordsize
    units = units_of(tile[: tile.numel() // 4 * 4])
    q = torch.arange(tile_len // stride, device=tile.device)
    A, Aa, _B, Ba = group_regs(units, q, lead // 8, stride)
    # keyed bases: the whole span W + stride - 1 of an exact table (at most
    # 14), the first 16 span bases of the hashed one (scan.py:473-474)
    m2kb = mask_bases(W + stride - 1)
    some_phase_clean = valid_phases(Aa, Ba, stride * q, stride, W, n_scan) != 0
    if qbloom_bits:
        bk = mul32(A & m2kb, GOLD) >> (32 - qbloom_bits)
    else:
        bk = A & m2kb & ((1 << q_bits) - 1)
    hit = ((u32(qbloom)[bk >> 5] >> (bk & 31)) & 1) == 1
    span_clean = (Aa & m2kb) == 0
    flag = some_phase_clean & (hit | ~span_clean)
    lanes = torch.arange(32, device=tile.device)
    words = (flag.view(-1, 32).to(torch.int64) << lanes).sum(dim=1)
    return to_i32(words), flag.sum().to(torch.int32).reshape(1)


PREFILTER_MAX_BITS = 20  # a staged prefilter takes at most 128 KB of the SM's 227 KB


def _prefilter(prefilter, t_bits: int) -> tuple:
    """(words, bits, shift) of a kernel's prefilter: 2^bits bits (32 to
    2^20) at key bit ``shift`` of a 2^t_bits-bit table. A prefilter as large
    as its table is taken for the table itself, which the kernel then
    confirms nowhere: a copy of the table is as good as the table."""
    if prefilter is None:
        raise ValueError("the kernel needs the table's prefilter (Table.loose_prefilter, "
                         "Table.raw_prefilter)")
    pre, pre_bits, pre_shift = prefilter
    require(pre, torch.int32, "prefilter")
    if (pre.numel() * 32 != 1 << pre_bits or not 5 <= pre_bits <= PREFILTER_MAX_BITS
            or pre_shift < 0 or pre_shift + pre_bits > t_bits):
        raise ValueError(f"prefilter of {pre.numel()} words is no 2^{pre_bits}-bit window "
                         f"at bit {pre_shift} of a 2^{t_bits}-bit table")
    return pre, pre_bits, pre_shift


def front_end_loose(tile, qbloom, q_bits: int, wordsize: int, lead: int,
                    tile_len: int, n_scan: int, stride: int,
                    qbloom_bits: int, prefilter=None):
    """K8: flag words and c_total of one tile's loose front end, the CUDA
    kernel for tensors on the card, ``front_end_loose_plain`` for CPU
    tensors.

    ``qbloom``: int32 words of the group table (2^q_bits bits): exact over
    the span values of ``stride`` positions when ``qbloom_bits`` is 0,
    else the mult-hash bloom (then q_bits == qbloom_bits). Returns (words
    int32[tile_len/(32*stride)], c_total int32[1]), one bit per group in
    group order. ``prefilter``: (words, bits, shift) of ``qbloom`` folded
    by ``table.fold_bits`` (``Table.loose_prefilter``), which the kernel
    stages in shared memory: required on the card, unused by the plain
    version. The call is one launch; ``flag_count`` reads the count after
    the tile's ``expand``."""
    if not kernel_route(tile, qbloom):
        return front_end_loose_plain(tile, qbloom, q_bits, wordsize, lead,
                                     tile_len, n_scan, stride, qbloom_bits)
    require(tile, torch.uint8, "tile")
    require(qbloom, torch.int32, "qbloom")
    n_units = _check(tile, lead, tile_len, n_scan)
    if stride not in (2, 4):
        raise ValueError(f"stride {stride} is neither 2 nor 4")
    if (qbloom.numel() * 32 != 1 << q_bits or qbloom_bits not in (0, q_bits)
            or q_bits > 2 * min(16, wordsize + stride - 1)):
        raise ValueError(f"qbloom of {qbloom.numel()} words is not 2^{q_bits} key bits")
    pre, pre_bits, pre_shift = _prefilter(prefilter, q_bits)
    kernel_route(tile, pre)
    units = tile.data_ptr() + lead // 2
    if units % 4:
        raise ValueError("tile plane is not 4-byte aligned")
    n_groups = n_units * (8 // stride)
    words = torch.empty(n_groups // 32, dtype=torch.int32, device=tile.device)
    c_total = torch.empty(1, dtype=torch.int32, device=tile.device)
    P, I = kernels.P, kernels.I
    fn = kernels.function("front_end", "mp_front_end_loose",
                          [P, P, I, I, I, I, I, I, I, P, I, I, P, P, P, P])
    with kernels.on_device(tile):
        st = kernels.scan_state(tile)
        kernels.call(
            fn, units, qbloom.data_ptr(), q_bits, qbloom_bits, wordsize, stride,
            n_groups, n_scan, int(units % 16 == 0), pre.data_ptr(), pre_bits, pre_shift,
            words.data_ptr(), st.ticket.data_ptr(), c_total.data_ptr(), kernels.stream(tile),
        )
    front_end_loose.launches += 1
    return words, c_total


front_end_loose.launches = 0


def _check_raw(tile, bloom, bloom_bits: int, wordsize: int, lead: int,
               tile_len: int, n_scan: int) -> None:
    if not 0 <= n_scan <= tile_len:
        raise ValueError(f"n_scan {n_scan} outside [0, {tile_len}]")
    if tile_len % 256:
        raise ValueError(f"tile_len {tile_len} is not a multiple of 256")
    if tile.numel() < lead + tile_len + wordsize - 1:
        raise ValueError("raw tile plane shorter than lead + tile_len + W - 1 bytes")
    if not 0 < bloom_bits <= 2 * wordsize or bloom.numel() * 32 != 1 << bloom_bits:
        raise ValueError(f"bloom of {bloom.numel()} words is not 2^{bloom_bits} bits")


def front_end_raw_plain(tile, bloom, bloom_bits: int, wordsize: int, lead: int,
                        tile_len: int, n_scan: int):
    """K9a in plain PyTorch: (words int32[tile_len/32], c_total int32[1]).

    Position i of the tile (plane byte lead + i) is flagged iff i < n_scan,
    its W bytes hold no ambiguous byte, and ``bloom`` holds the top
    ``bloom_bits`` bits of their W-mer (``scan.py:660-678``, ``bloom_flag``
    ``:445-450``); bit i & 31 of word i >> 5."""
    _check_raw(tile, bloom, bloom_bits, wordsize, lead, tile_len, n_scan)
    i = torch.arange(tile_len, device=tile.device)
    h, amb = raw_hashes(tile, i + lead, wordsize)
    bk = h >> (2 * wordsize - bloom_bits)
    hit = ((u32(bloom)[bk >> 5] >> (bk & 31)) & 1) == 1
    flag = hit & ~amb & (i < n_scan)
    lanes = torch.arange(32, device=tile.device)
    words = (flag.view(-1, 32).to(torch.int64) << lanes).sum(dim=1)
    return to_i32(words), flag.sum().to(torch.int32).reshape(1)


def front_end_raw(tile, bloom, bloom_bits: int, wordsize: int, lead: int,
                  tile_len: int, n_scan: int, prefilter=None):
    """K9a: flag words and c_total of a raw-byte tile (one byte per
    position), the CUDA kernel for tensors on the card,
    ``front_end_raw_plain`` for CPU tensors.

    ``bloom``: int32 words of the table's W-mer occupancy map (2^bloom_bits
    bits, ``Table.bloom``). Returns (words int32[tile_len/32], c_total
    int32[1]), one bit per scan position. ``prefilter``: the bloom's low
    bits (``Table.raw_prefilter``, shift 0), as in ``front_end_loose``;
    the call is one launch."""
    if not kernel_route(tile, bloom):
        return front_end_raw_plain(tile, bloom, bloom_bits, wordsize, lead,
                                   tile_len, n_scan)
    require(tile, torch.uint8, "tile")
    require(bloom, torch.int32, "bloom")
    _check_raw(tile, bloom, bloom_bits, wordsize, lead, tile_len, n_scan)
    pre, pre_bits, pre_shift = _prefilter(prefilter, bloom_bits)
    kernel_route(tile, pre)
    if pre_shift:
        raise ValueError("the raw prefilter is the bloom's low bits (shift 0)")
    plane = tile.data_ptr() + lead
    words = torch.empty(tile_len // 32, dtype=torch.int32, device=tile.device)
    c_total = torch.empty(1, dtype=torch.int32, device=tile.device)
    P, I = kernels.P, kernels.I
    fn = kernels.function("front_end", "mp_front_end_raw",
                          [P, P, I, I, I, I, I, P, I, P, P, P, P])
    with kernels.on_device(tile):
        st = kernels.scan_state(tile)
        kernels.call(
            fn, plane, bloom.data_ptr(), 2 * wordsize - bloom_bits, wordsize, tile_len,
            n_scan, int(plane % 16 == 0), pre.data_ptr(), pre_bits, words.data_ptr(),
            st.ticket.data_ptr(), c_total.data_ptr(), kernels.stream(tile),
        )
    front_end_raw.launches += 1
    return words, c_total


front_end_raw.launches = 0
