"""Plain PyTorch reference of me-PCR's search (the reference merpcr's T=1
rules), written for the benchmark from the rules alone. It imports nothing
of the program under test and takes nothing it made: it builds its own
entries from the STS rows and scans the genome bytes the benchmark made.

Rules (the original merpcr ``engine.py``):

* STS: primers uppercased; an STS with a primer shorter than W is dropped;
  a stated size below the primers' sum is raised to it. Each line gives a
  (+) entry (primer 1, primer 2 as written) and a (-) entry (primer 2 as
  written, the reverse complement of primer 1), in that order; an entry
  whose primer 1 holds no W bases free of ambiguity letters is dropped, and
  the first such W bases (at ``hoff``) are its hashed word.
* A genome word equal to an entry's hashed word, W bases of A, C, G, T
  inside one record, anchors primer 1 at ``k = position - hoff``; primer 1
  must lie in the record, leave room for primer 2 after it, match its last
  X bases and hold at most N mismatches.
* Primer 2 is tried at offsets d = 0, +1, -1, +2, -2, ... of the stated
  size (the record's end clamps it), d >= -lo and d <= hi with
  lo = min(M, size - l1 - l2) and hi = min(M, n - k - size); at d <= 0 it
  may not overlap primer 1. It must match its first X bases and hold at
  most N mismatches. Every offset that passes is a hit, printed as
  ``label  k+1..end  id  alias  (strand)``.
* A base matches a primer letter when both, upper-cased, are equal, or at
  -I 1 when both are IUPAC letters whose expansion sets meet.

The search runs in blocks of positions, pairs and anchors, so that it fits
beside whatever else the device holds, on the CPU or the card alike.
"""

from __future__ import annotations

import torch

IUPAC = {
    "A": "A", "C": "C", "G": "G", "T": "TU", "U": "TU",
    "R": "AGR", "Y": "CTUY", "M": "ACM", "K": "GTUK", "S": "CGS",
    "W": "ATUW", "B": "CGTUYKSB", "D": "AGTURKWD", "H": "ACTUYMWH",
    "V": "ACGRMSV", "N": "ACGTURYMKSWBDHVN",
}
COMPLEMENT = dict(zip("ACGTURYMKSWBDHVNX", "TGCAAYRKMSWVHDBNX"))
AMBIG = 4
POS_BLOCK = 1 << 24
PAIR_BLOCK = 1 << 20
WINDOW_BLOCK = 1 << 22  # (anchor, offset) items per block


def base_codes() -> torch.Tensor:
    """int64[256]: A, C, G, T (and U) of either case -> 0..3, else 4."""
    codes = torch.full((256,), AMBIG, dtype=torch.int64)
    for i, b in enumerate("ACGT"):
        codes[ord(b)] = codes[ord(b.lower())] = i
    codes[ord("U")] = codes[ord("u")] = 3
    return codes


def match_table(iupac: bool) -> torch.Tensor:
    """bool[256 * 256]: entry s * 256 + p says whether genome byte s
    matches primer byte p."""
    up = torch.tensor([b - 32 if ord("a") <= b <= ord("z") else b for b in range(256)])
    table = up[:, None] == up[None, :]
    if iupac:
        sets = {ord(k): set(v) for k, v in IUPAC.items()}
        known = torch.tensor([int(u) in sets for u in up.tolist()])
        meet = torch.zeros(256, 256, dtype=torch.bool)
        for a, sa in sets.items():
            for b, sb in sets.items():
                meet[a, b] = bool(sa & sb)
        both = known[:, None] & known[None, :]
        table = torch.where(both, meet[up][:, up], table)
    return table.reshape(-1)


# reverse complement table: an unknown letter becomes N, as in the reference
_COMP_TABLE = {b: COMPLEMENT.get(chr(b), "N") for b in range(256)}


def revcomp(primer: str) -> str:
    return primer.translate(_COMP_TABLE)[::-1]


class Entries:
    """The searchable entries of an STS set, as the reference builds them."""

    def __init__(self, rows, wordsize: int):
        a_s, b_s, meta = [], [], []
        for i, (_sid, p1, p2, size, _alias) in enumerate(rows):
            p1 = (p1.decode() if isinstance(p1, bytes) else p1).upper()
            p2 = (p2.decode() if isinstance(p2, bytes) else p2).upper()
            if len(p1) < wordsize or len(p2) < wordsize:
                continue
            size = max(int(size), len(p1) + len(p2))
            a_s += [p1, p2]
            b_s += [p2, revcomp(p1)]
            meta += [(i, 0, size), (i, 1, size)]
        hoff, key = _first_words(a_s, wordsize)
        keep = torch.nonzero(hoff >= 0).flatten()  # the entries that hash
        m = torch.tensor(meta, dtype=torch.int64).reshape(-1, 3)[keep]
        self.sts = m[:, 0].tolist()
        self.strand = ["+-"[d] for d in m[:, 1].tolist()]
        self.size = m[:, 2]
        self.wordsize = wordsize
        self.key, self.hoff = key[keep], hoff[keep]
        self.p1, self.l1 = _pad([a_s[j] for j in keep.tolist()])
        self.p2, self.l2 = _pad([b_s[j] for j in keep.tolist()])
        # entries by key: bucket b holds order[start[b]:start[b + 1]]
        self.order = torch.argsort(self.key, stable=True)
        self.ukey, counts = torch.unique_consecutive(self.key[self.order], return_counts=True)
        self.start = torch.cat([torch.zeros(1, dtype=torch.int64), counts.cumsum(0)])

    def to(self, device) -> "Entries":
        for name in ("key", "hoff", "l1", "l2", "size", "p1", "p2", "order", "ukey", "start"):
            setattr(self, name, getattr(self, name).to(device))
        return self


def _pad(primers) -> tuple:
    """(uint8[n, longest] primer letters, zero-padded; int64[n] lengths)."""
    lens = torch.tensor([len(p) for p in primers], dtype=torch.int64)
    width = int(lens.max()) if len(primers) else 1
    out = torch.zeros(len(primers), width, dtype=torch.uint8)
    flat = torch.frombuffer(bytearray("".join(primers).encode("latin-1")), dtype=torch.uint8)
    out[torch.arange(width)[None, :] < lens[:, None]] = flat  # row-major order
    return out, lens


def _first_words(primers, wordsize: int) -> tuple:
    """(offset, key) of each primer's first W letters free of ambiguity
    (-1, 0 where there are none); a key holds two bits a base, the first
    base highest."""
    pad, lens = _pad(primers)
    codes = base_codes()[pad.long()]
    clean = (codes != AMBIG) & (torch.arange(pad.shape[1])[None, :] < lens[:, None])
    runs = torch.cat([torch.zeros(len(primers), 1, dtype=torch.int64), clean.long().cumsum(1)], 1)
    if pad.shape[1] < wordsize:
        return torch.full((len(primers),), -1), torch.zeros(len(primers), dtype=torch.int64)
    full = (runs[:, wordsize:] - runs[:, :-wordsize]) == wordsize
    has = full.any(1)
    hoff = full.int().argmax(1)
    cols = hoff[:, None] + torch.arange(wordsize)
    word = codes.gather(1, cols.clamp(max=pad.shape[1] - 1)) & 3
    key = (word << (2 * torch.arange(wordsize - 1, -1, -1))).sum(1)
    return torch.where(has, hoff, -1), torch.where(has, key, 0)


def search(genome: torch.Tensor, starts: torch.Tensor, lengths: torch.Tensor,
           ent: Entries, margin: int, mismatches: int, three_prime: int,
           iupac: bool) -> torch.Tensor:
    """Every hit as int64[(n, 4)] rows (record, pos1, pos2, entry), 0-based
    and inclusive, sorted by record, pos1, pos2 and entry. ``genome``:
    uint8 records end to end on the device the search runs on; ``starts``
    and ``lengths``: int64 per record, there too; ``ent`` on that device."""
    dev = genome.device
    match = match_table(iupac).to(dev)
    hits = []
    for pos, bucket in _words(genome, starts, lengths, ent):
        counts = ent.start[bucket + 1] - ent.start[bucket]
        first = torch.repeat_interleave(ent.start[bucket], counts)
        step = torch.arange(int(counts.sum()), device=dev) - torch.repeat_interleave(
            counts.cumsum(0) - counts, counts)
        p = torch.repeat_interleave(pos, counts)
        e = ent.order[first + step]
        for a in range(0, len(p), PAIR_BLOCK):
            anchors = _primer1(genome, starts, lengths, ent, match, p[a : a + PAIR_BLOCK],
                               e[a : a + PAIR_BLOCK], mismatches, three_prime)
            hits.extend(_primer2(genome, starts, lengths, ent, match, *anchors,
                                 margin, mismatches, three_prime))
    if not hits:
        return torch.zeros((0, 4), dtype=torch.int64, device=dev)
    rows = torch.cat(hits)
    for col in (3, 2, 1, 0):  # lexicographic by a stable sort per column
        rows = rows[torch.argsort(rows[:, col], stable=True)]
    return rows


def _words(genome, starts, lengths, ent):
    """(positions, bucket) of the genome words that equal some entry's
    hashed word, in blocks of positions."""
    dev = genome.device
    W = ent.wordsize
    codes = base_codes().to(dev)
    total = genome.numel()
    # a word may not run past its record's end
    tail = torch.zeros(total + 1, dtype=torch.int32, device=dev)
    ends = starts + lengths
    tail.index_add_(0, torch.maximum(ends - W + 1, starts), torch.ones_like(ends, dtype=torch.int32))
    tail.index_add_(0, ends, -torch.ones_like(ends, dtype=torch.int32))
    tail = tail.cumsum(0)[:total] > 0
    for a in range(0, max(total - W + 1, 0), POS_BLOCK):
        n = min(POS_BLOCK, total - W + 1 - a)
        c = codes[genome[a : a + n + W - 1].long()]
        amb = (c == AMBIG).int()
        bad = torch.zeros(n, dtype=torch.int32, device=dev)
        key = torch.zeros(n, dtype=torch.int64, device=dev)
        for j in range(W):
            key = (key << 2) | (c[j : j + n] & 3)
            bad += amb[j : j + n]
        ok = (bad == 0) & ~tail[a : a + n]
        idx = torch.searchsorted(ent.ukey, key)
        hit = ok & (idx < ent.ukey.numel())
        hit &= ent.ukey[idx.clamp(max=ent.ukey.numel() - 1)] == key
        where = torch.nonzero(hit).flatten()
        yield where + a, idx[where]


def _mismatch(genome, match, sites, primers, width_ok):
    """bool mismatches of primer letters against the genome bytes at
    ``sites`` (columns past a primer's length are no mismatch)."""
    g = genome[sites.clamp(0, genome.numel() - 1)].long()
    return ~match[g * 256 + primers.long()] & width_ok


def _primer1(genome, starts, lengths, ent, match, p, e, nmm: int, x: int):
    """The pairs (position, entry) whose primer 1 passes: (record, record
    start, record length, k, entry) of each anchor."""
    dev = genome.device
    r = torch.searchsorted(starts, p, right=True) - 1
    s, n = starts[r], lengths[r]
    k = p - s - ent.hoff[e]
    l1, l2 = ent.l1[e], ent.l2[e]
    ok = (k >= 0) & (k + l1 <= n) & (n - (k + l1) >= l2)
    col = torch.arange(ent.p1.shape[1], device=dev)
    mm = _mismatch(genome, match, (s + k)[:, None] + col, ent.p1[e], col < l1[:, None])
    if x > 0:
        ok &= ~(mm & (col >= (l1 - x).clamp(min=0)[:, None])).any(1)
    ok &= mm.sum(1) <= nmm
    keep = torch.nonzero(ok).flatten()
    return r[keep], s[keep], n[keep], k[keep], e[keep]


def _primer2(genome, starts, lengths, ent, match, r, s, n, k, e, margin: int,
             nmm: int, x: int) -> list:
    """The hits of the anchors: one row per margin offset whose primer 2
    passes."""
    dev = genome.device
    d = torch.arange(-margin, margin + 1, device=dev)
    out = []
    step = max(1, WINDOW_BLOCK // d.numel())
    for a in range(0, len(k), step):
        rr, ss, nn, kk, ee = (t[a : a + step] for t in (r, s, n, k, e))
        l1, l2, stated = ent.l1[ee], ent.l2[ee], ent.size[ee]
        actual = nn - kk
        clamped = stated > actual
        exp = torch.where(clamped, actual, stated)
        hi = torch.where(clamped, torch.zeros_like(exp), torch.clamp(nn - kk - exp, max=margin))
        lo = torch.clamp(exp - l1 - l2, min=0, max=margin)
        dd = d[None, :]
        p2 = (kk + exp - l2)[:, None] + dd
        ok = (dd == 0) | ((dd < 0) & (-dd <= lo[:, None])) | ((dd > 0) & (dd <= hi[:, None]))
        ok &= p2 + l2[:, None] <= nn[:, None]
        ok &= (dd > 0) | (p2 >= (kk + l1)[:, None])
        ai, di = torch.nonzero(ok, as_tuple=True)
        if not len(ai):
            continue
        q = p2[ai, di]
        col = torch.arange(ent.p2.shape[1], device=dev)
        el2 = l2[ai]
        mm = _mismatch(genome, match, (ss[ai] + q)[:, None] + col, ent.p2[ee[ai]],
                       col < el2[:, None])
        good = mm.sum(1) <= nmm
        if x > 0:
            good &= ~mm[:, :x].any(1)
        g = torch.nonzero(good).flatten()
        out.append(torch.stack([rr[ai[g]], kk[ai[g]], q[g] + el2[g] - 1, ee[ai[g]]], 1))
    return out


def lines(rows: torch.Tensor, labels, ent: Entries, sts_rows) -> list:
    """The printed lines of ``search``'s rows, in its order."""
    out = []
    for r, k, end, e in rows.tolist():
        i = ent.sts[e]
        out.append(f"{labels[r]}\t{k + 1}..{end + 1}\t{sts_rows[i][0]}\t{sts_rows[i][4]}"
                   f"\t({ent.strand[e]})")
    return out
