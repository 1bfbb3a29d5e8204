"""K6, K11, K14 ``verify_p1``: primer-1 verify of the candidate pairs -> anchors.

Replaces ``merpcr_tpu/ops/scan.py::_scan_tile_impl`` stage K6, the primer-1
verify (``scan.py:979-1045``; ``_row_window`` ``:350-382``), with K14's
record lookup (``:985-1005``) and K11's IUPAC match (``:1020-1022``): per
pair, the entry's ``emeta`` row, the anchor ``k = position - hash_offset``,
the record that owns the scan position (``records_at``) and the bounds in
its coordinates (``:1010``), then the genome's 4-bit codes against the
primer over its length -- code equality against ``p1_codes``, or at -I 1
the expansion-set test against ``p1_exp`` -- with the mismatch budget (-N)
and the '+' strand's last-X-bases protection (-X). The passing pairs, in
pair order, are the anchors; ``a_idx`` holds their pair indices, and
``anch_total`` is its length.

The JAX stage gathers whole 16-byte rows and clamps them into the plane;
the kernel compares 16 bases per step at -I 0 on a nibble plane (64-bit
genome words funnel-shifted to the window, XOR the primer codes packed in
registers from 8-byte loads of the ``p1_codes`` row, an OR-fold and a
popcount under the length mask; the last-X protection and the positions
outside the plane, which mismatch, are masks over the same nibbles), and
site by site at -I 1 and on raw planes. ``verify_words_model`` in
``tests/test_torch_verify_words.py`` is that arithmetic in numpy.

``verify_p1_raw`` is its byte mode, K9c (``scan.py:1026-1031``), for
raw-byte planes (one byte per position): genome bytes against the
primer bytes ``p1_bytes``, case-insensitively at -I 0 and through the
reference's 256 x 256 ``match`` table at -I 1. A byte read outside the
plane is -1, which equals no byte (the JAX stage clamps instead; no
in-bounds window reaches the plane's edge).

Kernel: ``csrc/verify_p1.cu``, one launch per call: one thread per pair,
and the passing pair indices compacted in pair order in the same launch by
a single-pass look-back scan (``csrc/compact.cuh``) into a buffer of one
entry per pair; the kernel writes ``anch_total`` into pinned host memory,
so the one host read is a stream synchronise. Given ``totals``, the
wrappers launch the same kernel for the deferred tile scan (``ops.scan``):
it reads the pair count that ``expand`` left on the card, covers the pair
buffer's capacity with as many blocks as the card holds at once, which
loop over the pair tiles, and writes ``anch_total`` to device memory,
with no host read. On the card it is launch-bound: pairs number in the
hundreds per 2^23-base tile of a clean genome.
``verify_p1_plain`` and ``verify_p1_raw_plain`` are the same functions in
plain PyTorch; the wrappers use them only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .units import (base_matches, byte_matches, bytes_at, check_codes,
                    check_match, check_records, kernel_route, nibbles_at,
                    record_args, records_at, require)


def _verify_plain(tile, entry, ppos, emeta, p_max: int, matches,
                  tile_start: int, rmeta, recmap, lead: int, mismatches: int,
                  three_prime: int):
    """a_idx of the pairs whose primer 1 passes; ``matches(pos, e)`` tells
    whether the genome at tile positions pos [n, p_max] matches primer row
    e [n]."""
    e = entry.to(torch.int64)
    em = emeta.to(torch.int64)[e]
    hoff, l1 = em[:, 0], em[:, 1]
    pos = ppos.to(torch.int64)
    _, rstart, rlen = records_at(rmeta, recmap, tile_start + pos)
    kg = tile_start + pos - hoff - rstart  # record-local anchor
    inb = (kg >= 0) & (kg + l1 <= rlen)  # scan.py:1010
    i = torch.arange(p_max, device=tile.device)
    mm = (i < l1[:, None]) & ~matches((pos - hoff + lead)[:, None] + i, e)
    prot = i >= (l1[:, None] - three_prime)  # '+': last X bases
    ok = inb & ~(mm & prot).any(dim=1) & (mm.sum(dim=1) <= mismatches)
    return torch.nonzero(ok).flatten().to(torch.int32)


def verify_p1_plain(tile, entry, ppos, emeta, p1_codes, p1_exp,
                    tile_start: int, rmeta, recmap, lead: int,
                    mismatches: int, three_prime: int):
    """a_idx int32[anch_total] (pair indices, ascending) in plain PyTorch."""
    return _verify_plain(
        tile, entry, ppos, emeta, p1_codes.shape[1],
        lambda pos, e: base_matches(nibbles_at(tile, pos), e, p1_codes, p1_exp),
        tile_start, rmeta, recmap, lead, mismatches, three_prime)


def verify_p1_raw_plain(tile, entry, ppos, emeta, p1_bytes, match,
                        tile_start: int, rmeta, recmap, lead: int,
                        mismatches: int, three_prime: int):
    """K9c: a_idx of a raw-byte tile in plain PyTorch."""
    return _verify_plain(
        tile, entry, ppos, emeta, p1_bytes.shape[1],
        lambda pos, e: byte_matches(bytes_at(tile, pos), e, p1_bytes, match),
        tile_start, rmeta, recmap, lead, mismatches, three_prime)


def _launch(wrapper, raw: bool, tile, entry, ppos, emeta, p1, p1_exp, match,
            tile_start: int, rmeta, recmap, lead: int, mismatches: int,
            three_prime: int, totals):
    """One kernel launch into an ``a_idx`` buffer of n entries, then the one
    host read of ``anch_total`` (a pinned word the kernel writes); returns
    the buffer's first ``anch_total`` entries. ``kernels.count_launch``
    counts the launch (none without pairs). ``p1``: primer codes (nibble
    plane) or bytes (``raw``). With ``totals`` (the deferred mode) the
    pairs are the first totals[2] of the n in the buffers, read on the
    card, the kernel writes anch_total into totals[3], and the call returns
    the whole buffer, reading nothing."""
    require(tile, torch.uint8, "tile")
    for t, name in ((entry, "entry"), (ppos, "ppos"), (emeta, "emeta")):
        require(t, torch.int32, name)
    if totals is not None:
        require(totals, torch.int32, "totals")
    check_codes(p1, p1_exp, "p1")
    check_match(match)
    check_records(rmeta, recmap)
    if entry.shape != ppos.shape:
        raise ValueError("entry and ppos differ in length")
    if not raw and p1_exp is None and (p1.shape[1] % 8 or p1.data_ptr() % 8):
        # the word compare reads the primer rows 8 bytes at a time
        raise ValueError(f"p1_codes rows of {p1.shape[1]} bytes at offset "
                         f"{p1.data_ptr() % 8} are not 8-byte words")
    dev = tile.device
    n = entry.numel()
    if n == 0:  # nothing to launch over
        return torch.empty(0, dtype=torch.int32, device=dev)
    a_idx = torch.empty(n, dtype=torch.int32, device=dev)
    P, I, LL = kernels.P, kernels.I, kernels.LL
    fn = kernels.function(
        "verify_p1", "mp_verify_p1",
        [P, LL, I, P, P, I, P, P, P, P, P, I, LL, P, P, LL, I, I, I, P, P, I, P, P, P],
    )
    deferred = totals is not None
    with kernels.on_device(tile):
        st = kernels.scan_state(tile)
        seq = st.tag(-(-n // 256))
        kernels.call(
            fn, tile.data_ptr(), tile.numel() * (1 if raw else 2), int(raw),
            entry.data_ptr(), ppos.data_ptr(), n,
            totals[2:].data_ptr() if deferred else None, emeta.data_ptr(),
            p1.data_ptr(), None if p1_exp is None else p1_exp.data_ptr(),
            None if match is None else match.data_ptr(), p1.shape[1],
            tile_start, *record_args(rmeta, recmap), lead, mismatches,
            three_prime, st.ticket.data_ptr(), st.status.data_ptr(), seq,
            a_idx.data_ptr(), (totals[3:] if deferred else st.host).data_ptr(),
            kernels.stream(tile),
        )
        kernels.count_launch(wrapper, deferred)
        if deferred:
            return a_idx
        (anch_total,) = st.read(1)
    return a_idx[:anch_total]


def deferred_plain(verify, tile, entry, ppos, totals, *args):
    """``verify`` (a plain version) under the deferred mode's buffer
    contract: the first min(totals[2], len) pairs verified, anch_total
    into totals[3]."""
    n = min(int(totals[2]), entry.numel())
    a_idx = verify(tile, entry[:n], ppos[:n], *args)
    totals[3] = a_idx.numel()
    return a_idx


def _route(wrapper, plain, raw: bool, tile, entry, ppos, emeta, p1, p1x,
           tile_start: int, rmeta, recmap, lead: int, mismatches: int,
           three_prime: int, totals):
    """The kernel for tensors on the card, ``plain`` for CPU tensors (under
    the deferred buffer contract when ``totals`` is given). ``p1x``: the
    -I 1 table (``p1_exp``, or ``match`` when ``raw``), None at -I 0."""
    extra = tuple(t for t in (p1x, recmap, totals) if t is not None)
    if kernel_route(tile, entry, ppos, emeta, p1, rmeta, *extra):
        return _launch(wrapper, raw, tile, entry, ppos, emeta, p1,
                       None if raw else p1x, p1x if raw else None, tile_start,
                       rmeta, recmap, lead, mismatches, three_prime, totals)
    args = (emeta, p1, p1x, tile_start, rmeta, recmap, lead, mismatches, three_prime)
    if totals is None:
        return plain(tile, entry, ppos, *args)
    return deferred_plain(plain, tile, entry, ppos, totals, *args)


def verify_p1(tile, entry, ppos, emeta, p1_codes, p1_exp, tile_start: int,
              rmeta, recmap, lead: int, mismatches: int, three_prime: int,
              totals=None):
    """Anchors of one tile: the CUDA kernel for tensors on the card,
    ``verify_p1_plain`` for CPU tensors.

    ``entry``/``ppos``: int32 pairs from ``expand``; ``emeta``: int32[E, 8];
    ``p1_codes``: uint8[E, P1MAX]; ``p1_exp``: int32[E, P1MAX] IUPAC masks
    for -I 1, or None for -I 0; ``tile_start``: plane position of the
    tile's first scan position; ``rmeta``/``recmap``: the plane's records
    (``units.records_at``); ``lead``: the first scan position's index in
    the tile.

    ``totals`` None (count first): returns the anchors, after one host
    read. ``totals`` given (the deferred mode of the tile scan,
    ``ops.scan``): the tile's five int32 totals on its device; one launch
    and no host read: ``entry``/``ppos`` are ``expand``'s deferred
    buffers, whose first totals[2] pairs (read on the card) are verified,
    the kernel writes anch_total into totals[3], and the call returns the
    ``a_idx`` buffer (as long as ``entry``), its first anch_total entries
    the anchors. ``verify_p1.launches`` counts the count-first launches,
    ``verify_p1.launches_deferred`` the deferred ones."""
    return _route(verify_p1, verify_p1_plain, False, tile, entry, ppos, emeta, p1_codes,
                  p1_exp, tile_start, rmeta, recmap, lead, mismatches, three_prime,
                  totals)


verify_p1.launches = verify_p1.launches_deferred = 0


def verify_p1_raw(tile, entry, ppos, emeta, p1_bytes, match, tile_start: int,
                  rmeta, recmap, lead: int, mismatches: int, three_prime: int,
                  totals=None):
    """K9c: anchors of one raw-byte tile (one byte per position), the CUDA
    kernel (the byte mode of ``csrc/verify_p1.cu``) for tensors on the
    card, ``verify_p1_raw_plain`` for CPU tensors.

    ``p1_bytes``: uint8[E, P1MAX] primer bytes (``Table.p1_bytes``);
    ``match``: uint8[65536] match table (``Table.match``) for -I 1, or None
    for -I 0; the rest, ``totals`` and the counts as for ``verify_p1``."""
    return _route(verify_p1_raw, verify_p1_raw_plain, True, tile, entry, ppos, emeta,
                  p1_bytes, match, tile_start, rmeta, recmap, lead, mismatches,
                  three_prime, totals)


verify_p1_raw.launches = verify_p1_raw.launches_deferred = 0
