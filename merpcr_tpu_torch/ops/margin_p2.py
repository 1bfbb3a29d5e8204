"""K7, K11, K14 ``margin_p2``: margin-window primer-2 verify and hit emission.

Replaces ``merpcr_tpu/ops/scan.py::_margin_stage`` (``scan.py:1047-1318``)
at every margin, its static-slice branch (R <= 257) and its rank-chunked
one (K13, ``:1103-1127``, ``:1201-1235``; R up to 20,097 at -M 10000): per
(anchor, rank) the reference clamps of the expected product end exp/hi/lo
(``:1070-1077``), rank r ->
offset d = 0, -1, +1, -2, ... (``_rank_d`` ``:344``), the structural bounds
(``:1241-1248``), the rank mask (``:1249-1257``) and the primer-2 verify
with the '-' strand's first-X-bases protection (``_p2_ok_of``
``:1133-1158``; at -I 1 K11's expansion-set test against ``p2_exp``,
``:1139-1143``). Every clamp and bound runs in the coordinates of the
anchor's record (K14, ``:1058-1077``): the record that owns the pair's
scan position gives the length ``arl`` and the index ``arec``; the plane
reads use the plane anchor. Hits come out anchor-major, rank-minor as
int32 rows (pos1, pos2, entry, pair_order, rank, rec), pos1/pos2
record-local; ``hit_total`` is their count.

``margin_p2_raw`` is its byte mode, K9c (``scan.py:1147-1152``, the
window read ``:1179-1181``), for raw-byte planes: genome bytes against the
primer bytes ``p2_bytes``, case-insensitively at -I 0 and through the
reference's ``match`` table at -I 1; the clamps, bounds and rank mask
are the same.

The JAX stage reads a window sized by the margin cap and clamps its row
gathers; here only the sites of ranks that the clamps, bounds and rank
mask let through are read, so no read leaves the record. Ranks past 2M+1
(runtime -M) can never emit; the rank numbering does not depend on the cap.

Kernel: ``csrc/margin_p2.cu``, one launch per call and one block per
anchor: the anchor's clamps once, only its live ranks (the clamps and the
rank mask are monotone in the offset, so they form one range), its
primer-2 window staged once in shared memory, the compare at -I 0 on a
nibble plane 16 bases per step (``csrc/nibwords.cuh``, shared with
``verify_p1``; ``tests/test_torch_margin_words.py`` models it in numpy),
site by site at -I 1 and on raw planes, and the rows compacted in
(anchor, rank) order in the same launch by the single-pass look-back scan
of ``csrc/compact.cuh``. The kernel writes ``hit_total`` into pinned host
memory, so the one host read is a stream synchronise. Rows go into a
buffer of at most ``ROW_CAP`` rows; more hits take a second launch into a
buffer of exactly ``hit_total`` rows. Given ``totals`` and ``rows``, the
wrappers launch the same kernel for the deferred tile scan (``ops.scan``):
it reads the anchor count that ``verify_p1`` left on the card, covers the
anchor buffer's capacity with as many blocks as the card holds at once,
which loop over the anchors, writes
``hit_total`` to device memory and at most ``ROW_CAP`` rows into the
scan's buffer, with no host read; the deferred scan reruns a tile past
it. The kernel keeps nothing per (anchor, rank) item, so a launch takes
any number of anchors and ranks;
the plain version, whose [anchors, ranks, P2MAX] temporaries are int64,
goes through the anchors in chunks of at most ``PLAIN_MAX_ITEMS`` items
and concatenates their rows, which chunk order keeps in (anchor, rank)
order. No number of anchors or ranks raises or drops a hit.
``margin_p2_plain`` and ``margin_p2_raw_plain`` are the same functions in
plain PyTorch; the wrappers use them only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import kernels
from .units import (base_matches, byte_matches, bytes_at, check_codes,
                    check_match, check_records, kernel_route, nibbles_at,
                    record_args, records_at, require)

# (anchor, rank) items of one pass of the plain version (a few
# int64[items, P2MAX] temporaries)
PLAIN_MAX_ITEMS = 1 << 17
# rows of the kernel's first launch; more hits take a second launch
ROW_CAP = 1 << 13


def _anchor_chunks(a_idx: torch.Tensor, margin: int, max_items: int):
    """``a_idx`` in order, cut so that chunk anchors x (2M+1) ranks stay
    within ``max_items`` (one anchor at least)."""
    return a_idx.split(max(1, max_items // (2 * margin + 1)))


def rank_offsets(margin: int, device=None) -> torch.Tensor:
    """Rank r -> window offset 0, -1, +1, -2, +2, ... for r < 2M+1 (the
    reference's expected-first-then-+-i order, engine.py:543-593; the JAX
    package's ``_rank_d``)."""
    r = torch.arange(2 * margin + 1, device=device)
    dmag = (r + 1) // 2
    return torch.where(r % 2 == 1, -dmag, dmag)


def _margin_plain(tile, a_idx, entry, ppos, emeta, p_max: int, matches,
                  tile_start: int, rmeta, recmap, lead: int, margin: int,
                  mismatches: int, three_prime: int):
    """Hit rows int32[hit_total, 6], at most ``PLAIN_MAX_ITEMS`` (anchor,
    rank) items at a time; ``matches(pos, e)`` tells whether the genome at
    tile positions pos [a, R, p_max] matches primer row e [a, 1]."""
    chunks = _anchor_chunks(a_idx, margin, PLAIN_MAX_ITEMS)
    rows = [_margin_rows(tile, a, entry, ppos, emeta, p_max, matches,
                         tile_start, rmeta, recmap, lead, margin, mismatches,
                         three_prime) for a in chunks]
    return torch.cat(rows) if len(rows) > 1 else rows[0]


def margin_p2_plain(tile, a_idx, entry, ppos, emeta, p2_codes, p2_exp,
                    tile_start: int, rmeta, recmap, lead: int, margin: int,
                    mismatches: int, three_prime: int):
    """Hit rows int32[hit_total, 6] in plain PyTorch."""
    return _margin_plain(
        tile, a_idx, entry, ppos, emeta, p2_codes.shape[1],
        lambda pos, e: base_matches(nibbles_at(tile, pos), e, p2_codes, p2_exp),
        tile_start, rmeta, recmap, lead, margin, mismatches, three_prime)


def margin_p2_raw_plain(tile, a_idx, entry, ppos, emeta, p2_bytes, match,
                        tile_start: int, rmeta, recmap, lead: int, margin: int,
                        mismatches: int, three_prime: int):
    """K9c: hit rows of a raw-byte tile in plain PyTorch."""
    return _margin_plain(
        tile, a_idx, entry, ppos, emeta, p2_bytes.shape[1],
        lambda pos, e: byte_matches(bytes_at(tile, pos), e, p2_bytes, match),
        tile_start, rmeta, recmap, lead, margin, mismatches, three_prime)


def _margin_rows(tile, a_idx, entry, ppos, emeta, p_max: int, matches,
                 tile_start: int, rmeta, recmap, lead: int, margin: int,
                 mismatches: int, three_prime: int):
    """The rows of one chunk of anchors."""
    dev = tile.device
    j = a_idx.to(torch.int64)
    e = entry.to(torch.int64)[j]
    em = emeta.to(torch.int64)[e]
    hoff, l1, l2, exp0 = em[:, 0], em[:, 1], em[:, 2], em[:, 3]
    gpos = tile_start + ppos.to(torch.int64)[j]
    arec, rstart, arl = records_at(rmeta, recmap, gpos)
    ak = gpos - hoff - rstart  # record-local anchor
    room = arl - (ak + l1) >= l2  # engine.py:524-525
    actual = arl - ak
    clamped = exp0 > actual
    exp = torch.where(clamped, actual, exp0)
    hi = torch.where(clamped, 0, torch.clamp(arl - ak - exp, max=margin))
    lo = torch.clamp(torch.clamp(exp - l1 - l2, max=margin), min=0)
    d = rank_offsets(margin, dev)
    dmag = d.abs()
    rmask = (d == 0) | torch.where(d < 0, dmag <= lo[:, None], dmag <= hi[:, None])
    p2 = (ak + exp - l2)[:, None] + d
    # k + len_p1 <= p2 is checked for d <= 0 only (engine.py:546, 568)
    fits = (p2 + l2[:, None] <= arl[:, None]) & ((d > 0) | (p2 >= (ak + l1)[:, None]))
    i = torch.arange(p_max, device=dev)
    site = (p2 + (rstart - tile_start + lead)[:, None])[:, :, None] + i
    mm = (i < l2[:, None, None]) & ~matches(site, e[:, None])
    prot = i < three_prime  # '-': first X bases
    p2_ok = ~(mm & prot).any(dim=2) & (mm.sum(dim=2) <= mismatches)
    hit = room[:, None] & rmask & fits & p2_ok
    ai, ri = torch.nonzero(hit, as_tuple=True)  # anchor-major, rank-minor
    rows = torch.stack(
        [ak[ai], p2[ai, ri] + l2[ai] - 1, e[ai], j[ai], ri, arec[ai]],
        dim=1,
    )
    return rows.to(torch.int32).reshape(-1, 6)


def _launch(wrapper, raw: bool, tile, a_idx, entry, ppos, emeta, p2, p2_exp,
            match, tile_start: int, rmeta, recmap, lead: int, margin: int,
            mismatches: int, three_prime: int, totals, rows):
    """One kernel launch (a block per anchor) into a buffer of a row per
    (anchor, rank) item, at most ``ROW_CAP`` rows, then the one host read of
    ``hit_total`` (a pinned word the kernel writes); past the buffer a
    second launch into one of exactly ``hit_total`` rows.
    ``kernels.count_launch`` counts the launches (none without anchors).
    ``p2``: primer codes (nibble plane) or bytes (``raw``). With ``totals``
    (the deferred mode) the anchors are the first totals[3] of ``a_idx``,
    read on the card by as many blocks as the card holds at once, which
    loop over them; the kernel writes hit_total into totals[4] and at most
    ``len(rows)`` rows into ``rows``, and the call reads nothing."""
    require(tile, torch.uint8, "tile")
    for t, name in ((a_idx, "a_idx"), (entry, "entry"), (ppos, "ppos"),
                    (emeta, "emeta")):
        require(t, torch.int32, name)
    deferred = totals is not None
    if deferred:
        require(totals, torch.int32, "totals")
        require(rows, torch.int32, "rows")
        if rows.dim() != 2 or rows.shape[1] != 6 or not rows.is_contiguous():
            raise ValueError("rows is not a contiguous int32[cap, 6] buffer")
    check_codes(p2, p2_exp, "p2")
    check_match(match)
    check_records(rmeta, recmap)
    if not raw and p2_exp is None and (p2.shape[1] % 8 or p2.data_ptr() % 8):
        # the word compare reads the primer rows 8 bytes at a time
        raise ValueError(f"p2_codes rows of {p2.shape[1]} bytes at offset "
                         f"{p2.data_ptr() % 8} are not 8-byte words")
    dev = tile.device
    n_anch = a_idx.numel()
    if n_anch == 0:  # nothing to launch over
        return torch.empty((0, 6), dtype=torch.int32, device=dev)
    P, I, LL = kernels.P, kernels.I, kernels.LL
    fn = kernels.function(
        "margin_p2", "mp_margin_p2",
        [P, LL, I, P, I, P, P, P, P, P, P, P, I, LL, P, P, LL, I, I, I, I, P, P, I, P, I, P,
         P])
    args = (tile.data_ptr(), tile.numel() * (1 if raw else 2), int(raw),
            a_idx.data_ptr(), n_anch, totals[3:].data_ptr() if deferred else None,
            entry.data_ptr(), ppos.data_ptr(),
            emeta.data_ptr(), p2.data_ptr(),
            None if p2_exp is None else p2_exp.data_ptr(),
            None if match is None else match.data_ptr(), p2.shape[1],
            tile_start, *record_args(rmeta, recmap), lead, margin,
            mismatches, three_prime)
    with kernels.on_device(tile):
        st = kernels.scan_state(tile)

        def launch(rows, hit_total):
            seq = st.tag(n_anch)
            kernels.call(fn, *args, st.ticket.data_ptr(), st.status.data_ptr(), seq,
                         rows.data_ptr(), rows.shape[0], hit_total.data_ptr(),
                         kernels.stream(tile))
            kernels.count_launch(wrapper, deferred)

        if deferred:
            launch(rows, totals[4:])
            return rows

        def counted(cap: int):
            rows = torch.empty((cap, 6), dtype=torch.int32, device=dev)
            launch(rows, st.host)
            (hit_total,) = st.read(1)
            return rows, hit_total

        rows, hit_total = counted(min(n_anch * (2 * margin + 1), ROW_CAP))
        if hit_total > rows.shape[0]:
            rows, _ = counted(hit_total)
    return rows[:hit_total]


def deferred_plain(margin_fn, tile, a_idx, totals, rows, *args):
    """``margin_fn`` (a plain version) under the deferred mode's buffer
    contract: the first totals[3] anchors, hit_total into totals[4], at
    most ``len(rows)`` rows kept in ``rows``, which it returns."""
    got = margin_fn(tile, a_idx[: int(totals[3])], *args)
    totals[4] = got.shape[0]
    kept = got[: rows.shape[0]]
    rows[: kept.shape[0]] = kept
    return rows


def _route(wrapper, plain, raw: bool, tile, a_idx, entry, ppos, emeta, p2, p2x,
           tile_start: int, rmeta, recmap, lead: int, margin: int, mismatches: int,
           three_prime: int, totals, rows):
    """The kernel for tensors on the card, ``plain`` for CPU tensors (under
    the deferred buffer contract when ``totals`` is given). ``p2x``: the
    -I 1 table (``p2_exp``, or ``match`` when ``raw``), None at -I 0."""
    if (totals is None) != (rows is None):
        raise ValueError("the deferred mode takes both totals and rows")
    extra = tuple(t for t in (p2x, recmap, totals, rows) if t is not None)
    if kernel_route(tile, a_idx, entry, ppos, emeta, p2, rmeta, *extra):
        return _launch(wrapper, raw, tile, a_idx, entry, ppos, emeta, p2,
                       None if raw else p2x, p2x if raw else None, tile_start, rmeta,
                       recmap, lead, margin, mismatches, three_prime, totals, rows)
    args = (entry, ppos, emeta, p2, p2x, tile_start, rmeta, recmap, lead, margin,
            mismatches, three_prime)
    if totals is None:
        return plain(tile, a_idx, *args)
    return deferred_plain(plain, tile, a_idx, totals, rows, *args)


def margin_p2(tile, a_idx, entry, ppos, emeta, p2_codes, p2_exp,
              tile_start: int, rmeta, recmap, lead: int, margin: int,
              mismatches: int, three_prime: int, totals=None, rows=None):
    """Hit rows of one tile: the CUDA kernel for tensors on the card,
    ``margin_p2_plain`` for CPU tensors.

    ``a_idx``: int32 anchor pair indices from ``verify_p1``; ``entry``/
    ``ppos``: the tile's pairs; ``p2_codes``: uint8[E, P2MAX];
    ``p2_exp``: int32[E, P2MAX] IUPAC masks for -I 1, or None;
    ``rmeta``/``recmap``: the plane's records (``units.records_at``).

    ``totals`` None (count first): returns the rows, after one host read.
    ``totals`` and ``rows`` given (the deferred mode of the tile scan,
    ``ops.scan``): the tile's five int32 totals and an int32[cap, 6] row
    buffer on its device; one launch and no host read: ``a_idx`` is
    ``verify_p1``'s deferred buffer, whose first totals[3] anchors (read
    on the card) are scanned, the kernel writes hit_total into totals[4]
    and the first min(hit_total, cap) rows into ``rows``, which the call
    returns (a tile past it is the deferred scan's to rerun).
    ``margin_p2.launches`` counts the count-first launches,
    ``margin_p2.launches_deferred`` the deferred ones."""
    return _route(margin_p2, margin_p2_plain, False, tile, a_idx, entry, ppos, emeta,
                  p2_codes, p2_exp, tile_start, rmeta, recmap, lead, margin, mismatches,
                  three_prime, totals, rows)


margin_p2.launches = margin_p2.launches_deferred = 0


def margin_p2_raw(tile, a_idx, entry, ppos, emeta, p2_bytes, match,
                  tile_start: int, rmeta, recmap, lead: int, margin: int,
                  mismatches: int, three_prime: int, totals=None, rows=None):
    """K9c: hit rows of one raw-byte tile (one byte per position), the CUDA
    kernel (the byte mode of ``csrc/margin_p2.cu``) for tensors on the
    card, ``margin_p2_raw_plain`` for CPU tensors.

    ``p2_bytes``: uint8[E, P2MAX] primer bytes (``Table.p2_bytes``);
    ``match``: uint8[65536] match table (``Table.match``) for -I 1, or None
    for -I 0; the rest, ``totals``/``rows`` and the counts as for
    ``margin_p2``."""
    return _route(margin_p2_raw, margin_p2_raw_plain, True, tile, a_idx, entry, ppos,
                  emeta, p2_bytes, match, tile_start, rmeta, recmap, lead, margin,
                  mismatches, three_prime, totals, rows)


margin_p2_raw.launches = margin_p2_raw.launches_deferred = 0
