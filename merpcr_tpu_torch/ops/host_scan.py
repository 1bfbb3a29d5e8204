"""Host (NumPy) scan fast path for small inputs: the port's own copy of
``merpcr_tpu/ops/host_scan.py``.

A one-shot run on a small genome pays more for the card than for the scan:
the compiled table's upload (~74 MB at W = 11), the kernel libraries' load
(or their ``nvcc`` build on first use) and four launches per tile. This
module computes the same rows in NumPy on the host, with the device
path's conventions: the same LSB-first W-mer keys and CSR (``uhash``,
``ustart``) as the table, the same 256x256 match matrix (so IUPAC and case
folding cannot diverge), and the same margin clamps and emission-rank
order as the kernels (reference engine.py:453-642). It reads raw record
bytes, so a record outside the 16-letter alphabet needs nothing extra.

The rows have the device path's schema and ordering keys, and the engine's
one emitter consumes both. Dense floods (candidates or anchor-window work
past a cap) return None: the engine then scans that record on the device
path, which owns the flood machinery. Primer 1 is verified for every
candidate at once, so a window-work flood is refused before any rank is
scanned; the rows and the None cases are the JAX package's.
"""

from __future__ import annotations

import numpy as np

from .encoding import AMBIG, SCODE

# Past these, the device path is both faster and the better-tested flood
# machinery (count-then-size buffers).
MAX_CANDIDATES = 20_000
MAX_WINDOW_WORK = 400_000  # anchors x (2*margin + 1)


def host_scan_record(
    table,  # HostTable of NumPy arrays
    meta,  # TableMeta
    seq_bytes: np.ndarray,  # uint8[n], raw record bytes
    margin: int,
    mismatches: int,
    three_prime: int,
) -> np.ndarray | None:
    """Scan one record on the host; returns int64[(n_hits, 6)] rows
    (pos1, pos2, entry, tile=0, pair_order, rank) in the device path's
    schema, or None when the workload exceeds the small-input caps (the
    caller falls back to the device path)."""
    W = meta.wordsize
    n = len(seq_bytes)
    empty = np.zeros((0, 6), dtype=np.int64)
    if n <= W or meta.n_entries == 0:
        return empty
    total = n - W + 1

    code = SCODE[seq_bytes]
    amb = code == AMBIG
    c2 = np.where(amb, 0, code).astype(np.uint64)
    # LSB-first W-mer value per scan position (base i at bits [2i, 2i+2)),
    # the table's bucket-key convention (table._lsb_keys)
    h = np.zeros(total, dtype=np.uint64)
    bad = np.zeros(total, dtype=bool)
    for i in range(W):
        h |= c2[i : i + total] << np.uint64(2 * i)
        bad |= amb[i : i + total]

    # uint64 on both sides: keys at W = 16 reach 2^32 - 1
    uh = np.asarray(table.uhash).astype(np.uint64)
    ustart = np.asarray(table.ustart)
    idx = np.searchsorted(uh, h)
    idxc = np.minimum(idx, len(uh) - 1)
    found = (~bad) & (idx < len(uh)) & (uh[idxc] == h)
    pos = np.nonzero(found)[0]
    if not len(pos):
        return empty
    starts = ustart[idx[pos]]
    counts = ustart[idx[pos] + 1] - starts
    if int(counts.sum()) > MAX_CANDIDATES:
        return None

    M = np.asarray(table.match).reshape(256, 256)
    emeta = np.asarray(table.emeta)
    p1b = np.asarray(table.p1_bytes)
    p2b = np.asarray(table.p2_bytes)
    Mdyn, NMM, X = int(margin), int(mismatches), int(three_prime)
    R = 2 * Mdyn + 1

    # every candidate entry in scan order (position, then its bucket's
    # entries): its index is its pair_order, skipped or not
    n_cand = int(counts.sum())
    cpos = np.repeat(pos, counts)
    first = np.repeat(np.cumsum(counts) - counts, counts)
    cent = np.repeat(starts, counts).astype(np.int64) + np.arange(n_cand) - first
    hoff, l1, l2, exp0 = (emeta[cent, j].astype(np.int64) for j in range(4))
    k = cpos - hoff
    anchor = (k >= 0) & (k + l1 <= n)  # reference engine.py:487
    # primer 1 of every candidate at once
    col = np.arange(p1b.shape[1])
    site = np.clip(k[:, None] + col, 0, n - 1)
    mm = (M[seq_bytes[site], p1b[cent]] == 0) & (col < l1[:, None])
    if X > 0:  # '+': last X bases
        anchor &= ~(mm & (col >= np.maximum(l1 - X, 0)[:, None])).any(axis=1)
    anchor &= mm.sum(axis=1) <= NMM
    anchor &= n - (k + l1) >= l2  # room
    anchors = np.nonzero(anchor)[0]
    # R ranks of window work per surviving anchor: the JAX package adds
    # them anchor by anchor and stops once past the cap, which is this
    # test on their sum, made before any rank is scanned
    if len(anchors) * R > MAX_WINDOW_WORK:
        return None

    rows = []
    for a in anchors.tolist():
        e, kk, L1, L2, e0 = (int(v[a]) for v in (cent, k, l1, l2, exp0))
        # margin window (reference engine.py:517-593 clamps, in the
        # form the margin_p2 kernel uses)
        actual = n - kk
        clamped = e0 > actual
        exp = actual if clamped else e0
        hi = 0 if clamped else min(Mdyn, n - kk - exp)
        lo = max(0, min(Mdyn, exp - L1 - L2))
        pb2 = p2b[e, :L2]
        for r in range(R):  # rank order d = 0, +1, -1, +2, -2, ...
            dmag = (r + 1) // 2
            d = -dmag if r % 2 == 1 else r // 2
            if d < 0 and dmag > lo:
                continue
            if d > 0 and dmag > hi:
                continue
            p2 = kk + exp - L2 + d
            if p2 + L2 > n:
                continue
            # k + len_p1 <= p2 is checked for d <= 0 only
            # (reference engine.py:546,568; the hi loop omits it)
            if d <= 0 and p2 < kk + L1:
                continue
            mm2 = M[seq_bytes[p2 : p2 + L2], pb2] == 0
            if X > 0 and mm2[:X].any():  # '-': first X bases
                continue
            if int(mm2.sum()) > NMM:
                continue
            rows.append((kk, p2 + L2 - 1, e, 0, a, r))
    if not rows:
        return empty
    return np.asarray(rows, dtype=np.int64)
