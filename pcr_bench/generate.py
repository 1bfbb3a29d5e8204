"""The inputs of one cell, made from its configuration, its traffic mix and
the seed: the one general generator that every configuration and traffic
file feeds.

A configuration (``configs/<name>.json``) fixes the genome's records
(``records``: each record's label and length, in FASTA order), its
ambiguity letters and the STS set (count, primer and product lengths,
degenerate primer letters). A traffic mix (``traffic/<name>.json``) fixes
the searches (their -N and -M, in turn), the loop that drives them
(``loop``: ``loops/<loop>.py``) and the amplicons planted in the genome
(``plants``: each key a kind, ``plants/<kind>.py``, with its parameters;
the kinds run in the order given). The seed only draws bases, primers and
places: every seed gets the same records and the same number of each kind
of plant, so the work of a search does not move with the seed.

Every plant is a whole amplicon of one STS, whose line the search must
print at the parameters that admit it (``Inputs.expected``); each kind's
module says where it plants. On a degenerate STS (configuration key
``degenerate_every``) the planted primers hold ACGT bases that resolve its
R/Y/N letters: -I 1 finds them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import spec

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
RESOLVE = {ord("R"): b"AG", ord("Y"): b"CT", ord("N"): b"ACGT"}
COMP = bytes.maketrans(b"ACGTRYKMSWBDHVN", b"TGCAYRMKSWVHDBN")
TRANSITION = bytes.maketrans(b"ACGT", b"GTAC")
SLOT = 2048  # plants take whole slots of this many bases, so none overlap
EDGE = 16  # bases kept free at each end of a plant's slots
# a primer keeps its last 12 bases free of mismatches and degenerate
# letters: they hold the hashed word of an ACGT primer
WORD_END = 12


@dataclass
class Plant:
    record: int
    pos: int  # 0-based start of the amplicon in its record
    size: int  # real size
    sts: int
    strand: str
    kind: str  # the plant kind (``plants/<kind>.py``)
    k: int = 0  # mismatches per primer
    delta: int = 0  # real minus stated size


@dataclass
class Inputs:
    labels: list
    starts: np.ndarray  # int64[R]: each record's first base in ``genome``
    lengths: np.ndarray  # int64[R]
    genome: np.ndarray  # uint8[sum(lengths)]: the records end to end
    sts: list  # (id, primer1 bytes, primer2 bytes, stated size, alias)
    plants: list = field(default_factory=list)
    searches: list = field(default_factory=list)  # engine settings, in turn
    degenerate: set = field(default_factory=set)  # STS indices with R/Y/N

    @property
    def bases(self) -> int:
        return int(self.lengths.sum())

    def line(self, p: Plant) -> str:
        sid, _p1, _p2, _size, alias = self.sts[p.sts]
        return f"{self.labels[p.record]}\t{p.pos + 1}..{p.pos + p.size}\t{sid}\t{alias}\t({p.strand})"

    def expected(self, mismatches: int, margin: int, iupac: int) -> list:
        """The lines of the plants that a search at these settings must
        print (a plant on a degenerate STS: only at -I 1, where it needs
        no mismatch)."""
        out = []
        for p in self.plants:
            if p.sts in self.degenerate and not iupac:
                continue
            if p.k <= mismatches and abs(p.delta) <= margin:
                out.append(self.line(p))
        return out


def make_sts(rng, cfg: dict) -> tuple:
    """(rows, degenerate STS indices): ``sts_count`` STS of random ACGT
    primers of ``primer_len`` bases and products of ``product_len``; every
    ``degenerate_every``-th STS gets ``degenerate_per_primer`` letters of
    ``degenerate_letters`` in each primer, off its last 12 bases."""
    n = int(cfg["sts_count"])
    plo, phi = cfg["primer_len"]
    slo, shi = cfg["product_len"]
    l1 = rng.integers(plo, phi + 1, size=n)
    l2 = rng.integers(plo, phi + 1, size=n)
    sizes = rng.integers(slo, shi + 1, size=n)
    bases = ACGT[rng.integers(0, 4, size=int(l1.sum() + l2.sum()), dtype=np.uint8)].tobytes()
    every = cfg.get("degenerate_every") or 0
    letters = np.frombuffer(cfg.get("degenerate_letters", "RYN").encode(), dtype=np.uint8)
    per = int(cfg.get("degenerate_per_primer", 2))
    rows, degenerate, at = [], set(), 0
    for i in range(n):
        p1 = bases[at : at + l1[i]]
        p2 = bases[at + l1[i] : at + l1[i] + l2[i]]
        at += int(l1[i] + l2[i])
        if every and i % every == every - 1:
            p1, p2 = (_degenerate(rng, p, letters, per) for p in (p1, p2))
            degenerate.add(i)
        rows.append((f"STS{i}", p1, p2, int(sizes[i]), f"alias STS{i}"))
    return rows, degenerate


def _degenerate(rng, primer: bytes, letters: np.ndarray, per: int) -> bytes:
    site = bytearray(primer)
    for j in rng.choice(len(site) - WORD_END, size=per, replace=False):
        site[j] = int(letters[rng.integers(0, len(letters))])
    return bytes(site)


def make_genome(rng, cfg: dict) -> tuple:
    """(labels, starts, lengths, genome): the configuration's ``records``
    of random ACGT, with ``ambiguity_rate`` of the bases replaced by
    ``ambiguity_letters``."""
    labels = [label for label, _n in cfg["records"]]
    lens = np.asarray([int(n) for _label, n in cfg["records"]], dtype=np.int64)
    total = int(lens.sum())
    raw = np.frombuffer(rng.bytes(-(-total // 4)), dtype=np.uint8)
    codes = np.empty((len(raw), 4), dtype=np.uint8)
    for j in range(4):
        codes[:, j] = (raw >> (2 * j)) & 3
    genome = ACGT[codes.reshape(-1)[:total]]
    rate = float(cfg.get("ambiguity_rate", 0.0))
    if rate:
        amb = np.frombuffer(cfg["ambiguity_letters"].encode(), dtype=np.uint8)
        hit = rng.integers(0, total, size=int(total * rate))
        genome[hit] = amb[rng.integers(0, len(amb), size=len(hit))]
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    return labels, starts, lens, genome


class _Slots:
    """Free runs of SLOT bases inside records, handed out in a seeded order;
    a plant longer than one slot takes consecutive slots of one record."""

    def __init__(self, rng, lengths: np.ndarray, reserved):
        rec, off = [], []
        for r, n in enumerate(lengths.tolist()):
            k = n // SLOT
            rec.append(np.full(k, r, dtype=np.int64))
            off.append(np.arange(k, dtype=np.int64) * SLOT)
        self.rec = np.concatenate(rec)
        self.off = np.concatenate(off)
        self.free = np.ones(len(self.rec), dtype=bool)
        for r, lo, hi in reserved:  # (record, first base, end)
            self.free[(self.rec == r) & (self.off < hi) & (self.off + SLOT > lo)] = False
        self.order = rng.permutation(len(self.rec))
        self.next = 0
        self.rng = rng

    def take(self, span: int) -> tuple:
        """(record, start) of a free place for ``span`` bases."""
        m = -(-(span + 2 * EDGE) // SLOT)
        while self.next < len(self.order):
            i = int(self.order[self.next])
            self.next += 1
            j = i + m
            if (j <= len(self.rec) and self.free[i:j].all()
                    and self.rec[j - 1] == self.rec[i]
                    and self.off[j - 1] == self.off[i] + (m - 1) * SLOT):
                self.free[i:j] = False
                room = m * SLOT - span - 2 * EDGE
                return int(self.rec[i]), int(self.off[i]) + EDGE + int(self.rng.integers(0, room + 1))
        raise RuntimeError(f"no free place left for a plant of {span} bases")


def make_inputs(cfg: dict, traffic: dict, seed: int, bench_dir: str = spec.BENCH_DIR) -> Inputs:
    """The cell's records, STS set, plants and search settings for ``seed``;
    the plant kinds are read from ``bench_dir``."""
    seed = int(seed) % (1 << 64)
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 0x5EED])
    labels, starts, lengths, genome = make_genome(rng, cfg)
    rows, degenerate = make_sts(rng, cfg)
    inp = Inputs(labels, starts, lengths, genome, rows, degenerate=degenerate)
    defaults = {"margin": cfg["margin"], "mismatches": cfg.get("mismatches", 0)}
    inp.searches = [{**defaults, **s} for s in traffic["searches"]]
    _plant_all(inp, rng, traffic.get("plants", {}), bench_dir)
    return inp


class Plan:
    """What the plant kinds ask for, before any base is written: each kind's
    ``add(plan, params)`` takes STS with ``fresh`` and appends to ``wanted``
    (placed in free slots) or ``fixed`` (at set places, kept clear of the
    slots by ``reserved``)."""

    def __init__(self, inp: Inputs):
        self.inp = inp
        self.used = set()
        self.wanted = []  # (sts, strand, kind, k, delta)
        self.fixed = []  # (record, pos, sts, strand, kind)
        self.reserved = []  # (record, first base, end)

    def fresh(self, pred=lambda i: True) -> int:
        """The next STS no plant took yet (and not degenerate)."""
        for i in range(len(self.inp.sts)):
            if i not in self.used and i not in self.inp.degenerate and pred(i):
                self.used.add(i)
                return i
        raise RuntimeError("no STS left to plant")


def _plant_all(inp: Inputs, rng, kinds: dict, bench_dir: str) -> None:
    plan = Plan(inp)
    for kind, params in kinds.items():
        spec.load(bench_dir, "plants", kind).add(plan, params)
    slots = _Slots(rng, inp.lengths, plan.reserved)
    for r, pos, i, strand, kind in plan.fixed:
        _plant(inp, rng, r, pos, i, strand, kind, 0, 0)
    for i, strand, kind, k, delta in plan.wanted:
        r, pos = slots.take(inp.sts[i][3] + delta)
        _plant(inp, rng, r, pos, i, strand, kind, k, delta)


def _mutate(rng, primer: bytes, lo: int, hi: int, k: int) -> bytes:
    site = bytearray(primer)
    for j in rng.choice(np.arange(lo, hi), size=k, replace=False):
        site[j : j + 1] = bytes(site[j : j + 1]).translate(TRANSITION)
    return bytes(site)


def _resolve(rng, primer: bytes) -> bytes:
    return bytes(int(rng.choice(list(RESOLVE[b]))) if b in RESOLVE else b for b in primer)


def _plant(inp: Inputs, rng, r: int, pos: int, i: int, strand: str, kind: str,
           k: int, delta: int) -> None:
    """Write the amplicon of STS ``i`` at ``pos`` of record ``r``: (+) its
    primer 1 then primer 2 as written, (-) primer 2 as written then the
    reverse complement of primer 1 (me-PCR's two entries of an STS line)."""
    _sid, p1, p2, stated, _alias = inp.sts[i]
    size = stated + delta
    left, right = (p1, p2) if strand == "+" else (p2, p1.translate(COMP)[::-1])
    if k:
        # primer 1 (left) past its first word, off its protected last
        # bases; primer 2 (right) off its protected first bases
        left = _mutate(rng, left, WORD_END, len(left) - 2, k)
        right = _mutate(rng, right, 2, len(right) - 2, k)
    if i in inp.degenerate:
        left, right = _resolve(rng, left), _resolve(rng, right)
    s = int(inp.starts[r])
    if pos < 0 or pos + size > int(inp.lengths[r]):
        raise RuntimeError(f"plant of {size} bases at {pos} leaves record {r}")
    inp.genome[s + pos : s + pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
    inp.genome[s + pos + size - len(right) : s + pos + size] = np.frombuffer(right, dtype=np.uint8)
    inp.plants.append(Plant(r, pos, size, i, strand, kind, k, delta))


def write_sts(path: str, rows) -> str:
    with open(path, "w") as fh:
        fh.writelines(f"{sid}\t{p1.decode()}\t{p2.decode()}\t{size}\t{alias}\n"
                      for sid, p1, p2, size, alias in rows)
    return path


def write_fasta(path: str, inp: Inputs, width: int = 80) -> str:
    """Every record, ``width`` bases per line."""
    with open(path, "wb") as fh:
        for label, s, n in zip(inp.labels, inp.starts.tolist(), inp.lengths.tolist()):
            seq = inp.genome[s : s + n]
            full = n - n % width
            body = np.empty((full // width, width + 1), dtype=np.uint8)
            body[:, :width] = seq[:full].reshape(-1, width)
            body[:, width] = ord("\n")
            fh.write(f">{label} synthetic {n} bp\n".encode())
            fh.write(body.tobytes())
            if full < n:
                fh.write(seq[full:].tobytes() + b"\n")
    return path


def write_inputs(tmp: str, inp: Inputs) -> tuple:
    """(STS path, FASTA path) of the inputs, written under ``tmp``."""
    return (write_sts(os.path.join(tmp, "cell.sts"), inp.sts),
            write_fasta(os.path.join(tmp, "cell.fa"), inp))
