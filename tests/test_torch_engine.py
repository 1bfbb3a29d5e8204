"""Whole searches: the PyTorch port (plain kernel versions, ``device="cpu"``)
is byte-identical to the JAX package's device path.

The reference side is ``merpcr_tpu.MerPCR`` with ``MERPCR_TPU_HOST_MAX=0``
(its device path, not its NumPy host fast path). Each corpus gets fresh
engines on both sides, so no cache of one search can serve another.
"""

from __future__ import annotations

import numpy as np
import pytest

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, run_search  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _both(sts, fa, tile_len=None, **params):
    """(port output, JAX output) of one search with fresh engines."""
    outs = []
    for eng in (MerPCR(device="cpu", **params), JaxMerPCR(**params)):
        eng._tile_len_override = tile_len
        assert eng.load_sts_file(sts)
        outs.append(run_search(eng, eng.load_fasta_file(fa)))
    return outs


def _write_corpus(tmp_path, seed: int, lengths, n_sts: int = 30,
                  planted_every: int = 2):
    """STS + FASTA with ``len(lengths)`` records of random ACGT and planted
    amplicons (both orientations, some off the stated size); records of
    8 kb and more also get a lowercase run and a few ambiguity letters."""
    rng = np.random.default_rng(seed)
    recs = [rng.choice(ACGT, size=n) for n in lengths]
    lines = []
    for i in range(n_sts):
        p1 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        p2 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        size = int(rng.integers(100, 400))
        lines.append(f"E{i}\t{p1.decode()}\t{p2.decode()}\t{size}\t(alias {i})\n")
        if i % planted_every:
            continue
        r = int(rng.integers(0, len(recs)))
        seq = recs[r]
        s = size + (int(rng.integers(-45, 46)) if i % 4 else 0)
        if len(seq) < s + 10:
            continue
        left, right = (p1, p2) if i % 3 else (p2, p1.translate(COMP)[::-1])
        pos = int(rng.integers(0, len(seq) - s))
        seq[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
        seq[pos + s - len(right) : pos + s] = np.frombuffer(right, dtype=np.uint8)
    sts = tmp_path / "e.sts"
    sts.write_text("".join(lines))
    fa = tmp_path / "e.fa"
    with open(fa, "w") as fh:
        for r, seq in enumerate(recs):
            if len(seq) >= 8_000:  # ambiguity below the K10 filter's threshold
                seq[100:130] = np.frombuffer(seq[100:130].tobytes().lower(), dtype=np.uint8)
                seq[rng.integers(0, len(seq), size=3)] = ord("N")
            body = seq.tobytes().decode()
            fh.write(f">rec{r} synthetic record {r}\n")
            fh.write("".join(body[i : i + 60] + "\n" for i in range(0, len(body), 60)))
    return str(sts), str(fa)


@pytest.mark.parametrize("margin", [50, 0, 64, 128])
def test_golden(margin):
    port, ref = _both(GOLDEN_STS, GOLDEN_FA, margin=margin)
    assert port == ref
    if margin >= 50:
        assert port == GOLDEN_LINE + "\n"


@pytest.mark.parametrize("tile_len", [1 << 12, 1 << 13, None])
def test_planted_multi_tile(tmp_path, tile_len):
    sts, fa = _write_corpus(tmp_path, 11, [40_000])
    port, ref = _both(sts, fa, tile_len=tile_len)
    assert port == ref
    assert port.count("\n") >= 5


@pytest.mark.parametrize("three_prime", [0, 1, 3])
def test_multi_record(tmp_path, three_prime):
    sts, fa = _write_corpus(tmp_path, 12, [9_000, 0, 5, 11, 12, 3_000, 17_000, 700])
    port, ref = _both(sts, fa, tile_len=1 << 12, three_prime_match=three_prime)
    assert port == ref
    assert len({line.split("\t")[0] for line in port.splitlines()}) >= 2


def test_short_records_and_empty_sts(tmp_path):
    sts, fa = _write_corpus(tmp_path, 13, [1, 10, 11, 12])
    assert _both(sts, fa) == ["", ""]
    empty = tmp_path / "empty.sts"
    empty.write_text("# comments only\n\n")
    sts2, fa2 = _write_corpus(tmp_path, 14, [5_000])
    port, ref = _both(str(empty), fa2)
    assert port == ref == ""


def test_output_file_and_stdout_name(tmp_path):
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    recs = eng.load_fasta_file(GOLDEN_FA)
    out = tmp_path / "o.txt"
    assert eng.search(recs, str(out)) == 1
    assert out.read_text() == GOLDEN_LINE + "\n"
    assert run_search(eng, recs) == GOLDEN_LINE + "\n"
    assert eng.total_hits == 1


@pytest.mark.parametrize(
    "params",
    [{"wordsize": 16}, {"margin": 10000}, {"wordsize": 12}, {"margin": 129}],
)
def test_unported_parameters_raise(params):
    """The word sizes above 11 and the margins above 128 that the port
    once refused: the engine takes them, and the golden search prints the
    JAX package's bytes."""
    port, ref = _both(GOLDEN_STS, GOLDEN_FA, **params)
    assert port == ref and GOLDEN_LINE + "\n" in port


def test_bounds_validation_matches_jax():
    for params in ({"wordsize": 2}, {"mismatches": 11}, {"margin": -1},
                   {"three_prime_match": -1}, {"default_pcr_size": 0}):
        with pytest.raises(ValueError) as a:
            MerPCR(device="cpu", **params)
        with pytest.raises(ValueError) as b:
            JaxMerPCR(**params)
        assert str(a.value) == str(b.value)


@pytest.mark.parametrize("params", [{}, {"iupac_mode": 1}, {"mismatches": 1}])
def test_raw_byte_record_matches_jax_bytes(params):
    """A record with a byte outside the 16-letter alphabet (only the API
    passes one) takes the raw-byte path (K9) and prints the JAX package's
    bytes; the golden genome rendered with U for T and junk bytes keeps
    the golden line wherever the JAX package keeps it."""
    from merpcr_tpu.models import FASTARecord as JaxFASTARecord
    from merpcr_tpu_torch.models import FASTARecord

    golden = JaxMerPCR().load_fasta_file(GOLDEN_FA)[0].sequence
    rna = golden.replace("T", "U").replace("t", "u")
    seqs = ["ACGT" * 10 + "E" + "ACGT" * 10, rna[:500] + "é-ÿ" + rna[503:]]
    outs = []
    for eng, rec in ((MerPCR(device="cpu", **params), FASTARecord),
                     (JaxMerPCR(**params), JaxFASTARecord)):
        assert eng.load_sts_file(GOLDEN_STS)
        outs.append(run_search(eng, [rec(defline=f">L78833 r{i}", sequence=s)
                                     for i, s in enumerate(seqs)]))
    assert outs[0] == outs[1]
    assert (GOLDEN_LINE in outs[0]) == bool(params.get("iupac_mode"))


def test_dirty_genome_arms_k10(tmp_path):
    """An N every 300 bases (~1.7 % of positions dirty in their 16-base
    window but clean in their W-mer) arms the dirty-span filter on both
    sides, and the outputs agree byte for byte."""
    dirty = "".join("N" if i % 300 == 0 else "ACGT"[i * 7 % 4] for i in range(4000))
    fa = tmp_path / "d.fa"
    fa.write_text(">d\n" + dirty + "\n")
    port, ref = _both(GOLDEN_STS, str(fa))
    assert port == ref
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    eng.search(eng.load_fasta_file(str(fa)))
    assert [c.dirty_bloom for c, _, _ in eng.last_scans] == [True]
