"""The port's CUDA kernels against their plain PyTorch versions, and the
rules around them.

This file imports neither JAX nor ``merpcr_tpu``, so it runs on a machine
with a CUDA card and no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py

Tests marked ``gpu`` decide inside a fixture whether a card is present and
skip without one. The others run on the CPU: routing, refusal of mixed
devices, a build that cannot find nvcc, the no-card default, and the
port's independence of JAX. Everything compared is an integer, so kernel
and plain version must agree exactly (tolerance 0).
"""

from __future__ import annotations

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from chip_smoke import Deferred, flood_corpus  # imports neither jax nor merpcr_tpu
from merpcr_tpu_torch import MerPCR
from merpcr_tpu_torch.ops import kernels
from merpcr_tpu_torch.models import FASTARecord
from merpcr_tpu_torch.ops import expand as expand_mod
from merpcr_tpu_torch.ops import scan as scan_mod
from merpcr_tpu_torch.ops import verify_p1 as verify_mod
from merpcr_tpu_torch.ops.expand import (
    expand,
    expand_loose,
    expand_loose_plain,
    expand_plain,
    expand_raw,
    expand_raw_plain,
)
from merpcr_tpu_torch.ops.front_end import (
    front_end,
    front_end_loose,
    front_end_loose_plain,
    front_end_plain,
    front_end_raw,
    front_end_raw_plain,
)
from merpcr_tpu_torch.ops import margin_p2 as margin_mod
from merpcr_tpu_torch.ops.margin_p2 import (
    margin_p2,
    margin_p2_plain,
    margin_p2_raw,
    margin_p2_raw_plain,
)
from merpcr_tpu_torch.ops.scan import record_rmeta
from merpcr_tpu_torch.parallel.sharded import replicate
from merpcr_tpu_torch.ops.verify_p1 import (
    verify_p1,
    verify_p1_plain,
    verify_p1_raw,
    verify_p1_raw_plain,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_STS = os.path.join(ROOT, "tests", "data", "test.sts")
GOLDEN_FA = os.path.join(ROOT, "tests", "data", "test.fa")
GOLDEN_LINE = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


@pytest.fixture(autouse=True)
def _device_path(monkeypatch):
    """Keep small corpora on the kernels: on its default gate the engine
    scans an input of at most 2,000,000 bases on the host, so a card search
    here would launch nothing. ``tests/conftest.py`` sets the same, but the
    card runs skip it (``--noconftest``); the host-path tests lift it."""
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _corpus(tmp_path, n: int = 300_000, n_sts: int = 200, seed: int = 3):
    """STS file + FASTA file: random genome, every 4th STS planted in both
    orientations (some off the stated size, some across 2^15 tile
    boundaries), a few ambiguity letters."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(ACGT, size=n)
    lines = []
    for i in range(n_sts):
        p1 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        p2 = rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes()
        size = int(rng.integers(100, 400))
        lines.append(f"T{i}\t{p1.decode()}\t{p2.decode()}\t{size}\n")
        if i % 4 == 0:
            rc1 = p1.translate(COMP)[::-1]
            for left, right, pos in ((p1, p2, int(rng.integers(0, n - 500))),
                                     (p2, rc1, (i // 4 + 1) * (1 << 15) - 50)):
                s = size + (int(rng.integers(-30, 31)) if i % 8 else 0)
                if pos + s <= n:
                    seq[pos : pos + len(left)] = np.frombuffer(left, dtype=np.uint8)
                    seq[pos + s - len(right) : pos + s] = np.frombuffer(right, dtype=np.uint8)
    seq[rng.integers(0, n, size=20)] = ord("N")
    sts = tmp_path / "k.sts"
    sts.write_text("".join(lines))
    fa = tmp_path / "k.fa"
    body = seq.tobytes().decode()
    fa.write_text(">k synthetic\n" + "\n".join(body[i : i + 80] for i in range(0, n, 80)) + "\n")
    return str(sts), str(fa)


def _assembly(tmp_path, n_rec: int = 400, seed: int = 5, dirty: float = 0.01):
    """STS + FASTA files of a scaffold assembly: ``n_rec`` records of 200
    to 3,000 random bases with ``dirty`` of them scattered ambiguity
    letters, every third STS with R/Y/N letters in its primers, every
    other STS planted (resolved) inside one record."""
    rng = np.random.default_rng(seed)
    recs = [rng.choice(ACGT, size=int(n)) for n in rng.integers(200, 3_001, size=n_rec)]
    amb = np.frombuffer(b"NRYKMSWBDHV", dtype=np.uint8)
    for seq in recs:
        k = rng.random(len(seq)) < dirty
        seq[k] = rng.choice(amb, size=int(k.sum()))
    resolve = {ord("R"): b"AG", ord("Y"): b"CT", ord("N"): b"ACGT"}
    lines = []
    for i in range(120):
        p1, p2 = (bytearray(rng.choice(ACGT, size=int(rng.integers(18, 26))).tobytes())
                  for _ in range(2))
        if i % 3 == 0:
            for p in (p1, p2):
                p[int(rng.integers(0, len(p)))] = int(rng.choice(list(b"RYN")))
        size = int(rng.integers(100, 190))
        lines.append(f"A{i}\t{p1.decode()}\t{p2.decode()}\t{size}\n")
        if i % 2 == 0:
            seq = recs[int(rng.integers(0, n_rec))]
            pos = int(rng.integers(0, len(seq) - size))
            for p, at in ((p1, pos), (p2, pos + size - len(p2))):
                site = bytes(int(rng.choice(list(resolve[b]))) if b in resolve else b for b in p)
                seq[at : at + len(p)] = np.frombuffer(site, dtype=np.uint8)
    sts = tmp_path / "a.sts"
    sts.write_text("".join(lines))
    fa = tmp_path / "a.fa"
    fa.write_text("".join(f">scaf{r}\n{seq.tobytes().decode()}\n" for r, seq in enumerate(recs)))
    return str(sts), str(fa)


def _search(engine, sts, fa) -> str:
    assert engine.load_sts_file(sts)
    recs = engine.load_fasta_file(fa)
    buf = io.StringIO()
    with redirect_stdout(buf):
        engine.search(recs)
    return buf.getvalue()


def _rna_records(fa, every: int = 1) -> list:
    """The records of ``fa``, every ``every``-th rendered as RNA (T -> U)
    with a '-' and a latin-1 'é' in it: records outside the 16-letter
    alphabet, which take the raw-byte path (K9)."""
    recs = MerPCR(device="cpu").load_fasta_file(fa)
    for r, rec in enumerate(recs):
        if r % every == 0:
            s = rec.sequence.replace("T", "U").replace("t", "u")
            recs[r] = FASTARecord(defline=rec.defline, sequence=s[:7] + "-é" + s[9:])
    return recs


def _search_records(engine, sts, recs) -> str:
    assert engine.load_sts_file(sts)
    buf = io.StringIO()
    with redirect_stdout(buf):
        engine.search(recs)
    return buf.getvalue()


# ---------------------------------------------------------------- CPU rules
RAW_WRAPPERS = (front_end_raw, expand_raw, verify_p1_raw, margin_p2_raw)
# the deferred modes of the tile scan's stages, which a search launches
# (their ``launches_deferred`` counts, read as ``launches``)
DEFERRED = tuple(Deferred(f) for f in (expand, expand_loose, expand_raw, verify_p1,
                                       verify_p1_raw, margin_p2, margin_p2_raw))
(expand_deferred, expand_loose_deferred, expand_raw_deferred, verify_p1_deferred,
 verify_p1_raw_deferred, margin_p2_deferred, margin_p2_raw_deferred) = DEFERRED
WRAPPERS = (front_end, front_end_loose, expand, expand_loose, verify_p1, margin_p2,
            *RAW_WRAPPERS, *DEFERRED)
# a search's path: the front end and the deferred stages
PATH = (front_end, expand_deferred, verify_p1_deferred, margin_p2_deferred)
RAW_PATH = (front_end_raw, expand_raw_deferred, verify_p1_raw_deferred,
            margin_p2_raw_deferred)


@pytest.mark.parametrize("mismatches", [0, 1, 2])
def test_cpu_tensors_take_the_plain_versions(tmp_path, mismatches):
    counts = [f.launches for f in WRAPPERS]
    out = _search(MerPCR(device="cpu", mismatches=mismatches), GOLDEN_STS, GOLDEN_FA)
    assert GOLDEN_LINE + "\n" in out
    raw = _search_records(MerPCR(device="cpu", mismatches=mismatches, iupac_mode=1),
                          GOLDEN_STS, _rna_records(GOLDEN_FA))
    assert GOLDEN_LINE + "\n" in raw
    assert [f.launches for f in WRAPPERS] == counts


def test_mixed_devices_raise():
    tile = torch.zeros(4096, dtype=torch.uint8)
    table = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        front_end(tile, table, 7, 11, 64, 1 << 12, 100)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernels.build()


def test_default_device_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    # the default is the card, unless MERPCR_TPU_PLATFORM (tox.ini: cpu) says otherwise
    monkeypatch.delenv("MERPCR_TPU_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MerPCR()
    from merpcr_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([GOLDEN_STS, GOLDEN_FA])


def test_cuda_iupac_table_equals_encoding():
    """csrc/records.cuh's kExpNib is ops/encoding.py's genome-letter
    expansion table, entry for entry."""
    import re

    from merpcr_tpu_torch.ops.units import EXP_NIB

    with open(os.path.join(kernels.CSRC, "records.cuh")) as fh:
        src = fh.read()
    body = re.search(r"kExpNib\[16\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v, 16) for v in re.findall(r"0x[0-9a-fA-F]+", body)) == EXP_NIB
    assert len(EXP_NIB) == 16


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, merpcr_tpu_torch\n"
        "for m in pkgutil.walk_packages(merpcr_tpu_torch.__path__, 'merpcr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "for m in ('engine', 'ops.scan', 'ops.units', 'ops.expand', 'ops.verify_p1',\n"
        "          'ops.margin_p2', 'ops.table', 'ops.host_scan'):\n"
        "    assert 'merpcr_tpu_torch.' + m in sys.modules, m\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'merpcr_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('merpcr_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 16  # every module was imported


# ---------------------------------------------------------------- on the card
def _tiles(tmp_path, device, **params):
    """(engine on ``device``, cfg, per-tile argument tuples) of the corpus."""
    sts, fa = _corpus(tmp_path)
    eng = MerPCR(device=device, **params)
    assert eng.load_sts_file(sts)
    rec = eng.load_fasta_file(fa)[0]
    from merpcr_tpu_torch.io.fasta import record_packed

    packed = record_packed(rec)
    n = len(rec.sequence)
    total = n - eng.wordsize + 1
    cfg = eng._base_config(1 << 15)
    L = cfg.tile_len
    n_tiles = -(-total // L)
    plane = torch.from_numpy(eng._plane(packed, cfg.lead + n_tiles * L + cfg.tail, cfg.lead,
                                        packed=True)).to(device)
    tiles = [(plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in], t * L,
              min(L, total - t * L), n) for t in range(n_tiles)]
    return eng, cfg, tiles


@pytest.mark.gpu
def test_kernels_equal_plain_versions(cuda, tmp_path):
    eng, cfg, tiles = _tiles(tmp_path, cuda)
    tb = eng._table
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    seen_hits = 0
    for tile, t0, n_scan, n in tiles:
        w, c = front_end(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
        wp, cp = front_end_plain(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
        assert torch.equal(w, wp) and torch.equal(c, cp)
        args = (tile, w, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.bsc,
                tb.emeta.shape[0], W, lead, L, n_scan, 4, True)
        e, p, pt, qt = expand(*args)
        ep, pp, ptp, qtp = expand_plain(*args)
        assert (pt, qt) == (ptp, qtp)
        assert torch.equal(e, ep) and torch.equal(p, pp)
        for nmm, x in ((0, 1), (0, 0), (0, 3)):
            rm = record_rmeta(n, cuda)
            vargs = (tile, e, p, tb.emeta, tb.p1_codes, None, t0, rm, None, lead, nmm, x)
            a = verify_p1(*vargs)
            assert torch.equal(a, verify_p1_plain(*vargs))
            for margin in (0, 50, 64):
                margs = (tile, a, e, p, tb.emeta, tb.p2_codes, None, t0, rm, None,
                         lead, margin, nmm, x)
                h = margin_p2(*margs)
                assert torch.equal(h, margin_p2_plain(*margs))
                seen_hits += h.shape[0]
    torch.cuda.synchronize()
    assert seen_hits > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mismatches", [1, 2])
def test_mismatch_kernels_equal_plain_versions(cuda, tmp_path, mismatches):
    """-N 1: front_end/expand over the strict1 tables; -N 2: the loose
    front end (K8) and the loose expand; then verify_p1/margin_p2 at
    mismatch budgets above 0."""
    eng, cfg, tiles = _tiles(tmp_path, cuda, mismatches=mismatches)
    assert (cfg.strict, cfg.strict_n) == ((True, 1) if mismatches == 1 else (False, 0))
    tb = eng._table
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    seen_hits = 0
    for tile, t0, n_scan, n in tiles:
        if cfg.strict:
            fe_args = (tile, tb.qbloom_s1, tb.gq1, W, lead, L, n_scan)
            w, c = front_end(*fe_args)
            wp, cp = front_end_plain(*fe_args)
            args = (tile, w, tb.ptab, tb.pf_bits, tb.t16_1, tb.t16_1_bits, tb.bsc,
                    tb.emeta.shape[0], W, lead, L, n_scan, 4, True)
            kernel, plain = expand, expand_plain
        else:
            fe_args = (tile, tb.qbloom, tb.q_bits, W, lead, L, n_scan, 4, 0)
            w, c = front_end_loose(*fe_args, tb.loose_prefilter)
            wp, cp = front_end_loose_plain(*fe_args)
            args = (tile, w, tb.ptab, tb.pf_bits, tb.bsc, tb.emeta.shape[0], W, lead,
                    L, n_scan, 4, True)
            kernel, plain = expand_loose, expand_loose_plain
        assert torch.equal(w, wp) and torch.equal(c, cp)
        e, p, pt, qt = kernel(*args)
        ep, pp, ptp, qtp = plain(*args)
        assert (pt, qt) == (ptp, qtp) and torch.equal(e, ep) and torch.equal(p, pp)
        rm = record_rmeta(n, cuda)
        for nmm, x in ((mismatches, 1), (3, 0), (2, 3)):
            vargs = (tile, e, p, tb.emeta, tb.p1_codes, None, t0, rm, None, lead, nmm, x)
            a = verify_p1(*vargs)
            assert torch.equal(a, verify_p1_plain(*vargs))
            margs = (tile, a, e, p, tb.emeta, tb.p2_codes, None, t0, rm, None,
                     lead, 50, nmm, x)
            h = margin_p2(*margs)
            assert torch.equal(h, margin_p2_plain(*margs))
            seen_hits += h.shape[0]
    torch.cuda.synchronize()
    assert seen_hits > 0


def _front_and_expand(cfg, tb, tile, n_scan, kernel: bool, bloom=None):
    """(words, c_total, entry, ppos, pos_total, pair_total) of the config's
    front end and expansion: the wrappers (kernels on the card) or their
    plain versions."""
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    if cfg.strict:
        fe, ex = (front_end, expand) if kernel else (front_end_plain, expand_plain)
        w, c = fe(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
        out = ex(tile, w, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.csr,
                 tb.emeta.shape[0], W, lead, L, n_scan, cfg.stride,
                 cfg.exact_group, bloom, tb.bloom_bits)
    else:
        args = (tile, tb.qbloom, tb.q_bits, W, lead, L, n_scan, cfg.stride, cfg.qbloom_bits)
        if kernel:
            (w, c), ex = front_end_loose(*args, tb.loose_prefilter), expand_loose
        else:
            (w, c), ex = front_end_loose_plain(*args), expand_loose_plain
        out = ex(tile, w, tb.ptab, tb.pf_bits, tb.csr, tb.emeta.shape[0], W,
                 lead, L, n_scan, cfg.stride, cfg.exact_group)
    return (w, c, *out)


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g, w) if isinstance(g, torch.Tensor) else g == w


@pytest.mark.gpu
@pytest.mark.parametrize("mismatches", [0, 2])
@pytest.mark.parametrize("wordsize", [12, 13, 14, 16])
def test_wordsize_kernels_equal_plain_versions(cuda, tmp_path, wordsize, mismatches):
    """K12: the stride-2 exact tables (W = 12, 13), the mult-hash bloom
    without a phase table (W = 14, 16) and the three bucket lookups, strict
    (-N 0, with and without the K10 bloom) and loose (-N 2)."""
    eng, cfg, tiles = _tiles(tmp_path, cuda, wordsize=wordsize, mismatches=mismatches)
    assert cfg.stride == 2 and cfg.exact_group == (wordsize <= 13)
    assert cfg.strict == (mismatches == 0)
    tb = eng._table
    pairs = 0
    for tile, _t0, n_scan, _n in tiles:
        for bloom in ((None, tb.bloom) if cfg.strict else (None,)):
            got = _front_and_expand(cfg, tb, tile, n_scan, True, bloom)
            _assert_same(got, _front_and_expand(cfg, tb, tile, n_scan, False, bloom))
            pairs += got[5]
    torch.cuda.synchronize()
    assert pairs > 0


@pytest.mark.gpu
@pytest.mark.parametrize("wordsize,margin,mismatches",
                         [(12, 50, 0), (13, 300, 0), (14, 50, 2), (16, 2000, 1), (3, 129, 0)])
def test_card_wordsize_search_equals_cpu_search(cuda, tmp_path, wordsize, margin, mismatches):
    sts, fa = _corpus(tmp_path, n=120_000 if wordsize > 3 else 20_000, n_sts=80)
    params = {"wordsize": wordsize, "margin": margin, "mismatches": mismatches}
    eng = MerPCR(device=cuda, **params)
    eng._tile_len_override = 1 << 15
    counts = [f.launches for f in WRAPPERS]
    on_card = _search(eng, sts, fa)
    assert sum(f.launches - c0 for f, c0 in zip(WRAPPERS, counts)) == 4 * eng.last_scans[0][1]
    cpu = MerPCR(device="cpu", **params)
    cpu._tile_len_override = 1 << 15
    assert on_card == _search(cpu, sts, fa)
    assert on_card.count("\n") > 0


@pytest.mark.gpu
@pytest.mark.parametrize("margin", [129, 2000, 10000])
def test_margin_kernel_equals_plain_and_chunks(cuda, tmp_path, monkeypatch, margin):
    """K13: margins above 128 against the plain version, and a first row
    buffer of one row: past it the second launch writes the same rows."""
    eng, cfg, tiles = _tiles(tmp_path, cuda, margin=margin)
    tb = eng._table
    hits = anchors = 0
    for tile, t0, n_scan, n in tiles[:4]:
        _w, _c, e, p, _pt, _qt = _front_and_expand(cfg, tb, tile, n_scan, True)
        rm = record_rmeta(n, cuda)
        a = verify_p1(tile, e, p, tb.emeta, tb.p1_codes, None, t0, rm, None, cfg.lead, 0, 1)
        margs = (tile, a, e, p, tb.emeta, tb.p2_codes, None, t0, rm, None,
                 cfg.lead, margin, 0, 1)
        h = margin_p2(*margs)
        assert torch.equal(h, margin_p2_plain(*margs))
        with monkeypatch.context() as mp:
            mp.setattr(margin_mod, "ROW_CAP", 1)
            c0 = margin_p2.launches
            assert torch.equal(h, margin_p2(*margs))
            # none without anchors, a second launch past the buffer
            assert margin_p2.launches - c0 == min(a.numel(), 1) + (h.shape[0] > 1)
        anchors += a.numel()
        hits += h.shape[0]
    assert hits > 0 and anchors > 8


@pytest.mark.gpu
def test_card_mismatch_search_equals_cpu_search(cuda, tmp_path):
    """-N 1 (strict1), -N 2 and -N 3 (loose) on the card print the CPU
    bytes, through the kernels of their front end."""
    sts, fa = _corpus(tmp_path)
    for n_mm, used in ((1, (front_end, expand_deferred)),
                       (2, (front_end_loose, expand_loose_deferred)),
                       (3, (front_end_loose, expand_loose_deferred))):
        counts = [f.launches for f in WRAPPERS]
        eng = MerPCR(device=cuda, mismatches=n_mm)
        on_card = _search(eng, sts, fa)
        launched = dict(zip(WRAPPERS, (f.launches - c0 for f, c0 in zip(WRAPPERS, counts))))
        assert all((launched[f] > 0) == (f in used + (verify_p1_deferred, margin_p2_deferred))
                   for f in WRAPPERS), (n_mm, launched)
        assert [(c.strict, c.strict_n) for c, _, _ in eng.last_scans] == \
            [(n_mm == 1, int(n_mm == 1))]
        assert on_card == _search(MerPCR(device="cpu", mismatches=n_mm), sts, fa)
        assert on_card.count("\n") > 0


@pytest.mark.gpu
def test_stream_kernels_equal_plain_versions(cuda, tmp_path):
    """Each kernel's stream, dirty-span (K10) and IUPAC (K11) variants
    against its plain version on the tiles of a dirty scaffold plane."""
    sts, fa = _assembly(tmp_path)
    eng = MerPCR(device=cuda, iupac_mode=1)
    eng._tile_len_override = 1 << 17
    assert eng.load_sts_file(sts)
    (kind, _, items), = eng._plan(eng.load_fasta_file(fa))
    cfg, plane_np, total, _, rmeta_np, recmap_np = eng._stream_plane(items)
    assert kind == "stream" and cfg.dirty_bloom and cfg.iupac
    tb = eng._table
    plane = torch.from_numpy(plane_np).to(cuda)
    rmeta, recmap = torch.from_numpy(rmeta_np).to(cuda), torch.from_numpy(recmap_np).to(cuda)
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    hits, recs = 0, set()
    for t in range(-(-total // L)):
        tile = plane[t * L // 2 : t * L // 2 + cfg.tile_buf_in]
        n_scan = min(L, total - t * L)
        w, c = front_end(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
        assert torch.equal(w, front_end_plain(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)[0])
        for bloom in (tb.bloom, None):
            args = (tile, w, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.bsc,
                    tb.emeta.shape[0], W, lead, L, n_scan, 4, True, bloom,
                    tb.bloom_bits)
            e, p, pt, qt = expand(*args)
            ep, pp, ptp, qtp = expand_plain(*args)
            assert (pt, qt) == (ptp, qtp) and torch.equal(e, ep) and torch.equal(p, pp)
        for p1x, p2x in ((tb.p1_exp, tb.p2_exp), (None, None)):
            for x in (0, 1, 3):
                vargs = (tile, e, p, tb.emeta, tb.p1_codes, p1x, t * L, rmeta, recmap,
                         lead, 0, x)
                a = verify_p1(*vargs)
                assert torch.equal(a, verify_p1_plain(*vargs))
                for margin in (0, 50):
                    margs = (tile, a, e, p, tb.emeta, tb.p2_codes, p2x, t * L, rmeta,
                             recmap, lead, margin, 0, x)
                    h = margin_p2(*margs)
                    assert torch.equal(h, margin_p2_plain(*margs))
                    hits += h.shape[0]
                    recs |= set(h[:, 5].tolist())
    torch.cuda.synchronize()
    assert hits > 0 and len(recs) > 10


@pytest.mark.gpu
def test_card_stream_search_equals_cpu_search(cuda, tmp_path):
    """A dirty scaffold assembly at -I 0 and -I 1: the card prints the CPU
    bytes, and each kernel launches at most once per stream tile."""
    sts, fa = _assembly(tmp_path)
    wrappers = PATH
    for iupac in (0, 1):
        eng = MerPCR(device=cuda, iupac_mode=iupac)
        counts = [f.launches for f in wrappers]
        on_card = _search(eng, sts, fa)
        launched = [f.launches - c0 for f, c0 in zip(wrappers, counts)]
        (cfg, n_tiles, n_rec), = eng.last_scans
        assert cfg.stream and cfg.dirty_bloom and n_rec == 400
        assert 0 < min(launched) and max(launched) <= n_tiles, launched
        assert on_card == _search(MerPCR(device="cpu", iupac_mode=iupac), sts, fa)
        assert on_card.count("\n") > 0


@pytest.mark.gpu
@pytest.mark.parametrize("wordsize,margin", [(11, 2000), (14, 300)])
def test_card_stream_search_at_large_margins(cuda, tmp_path, wordsize, margin):
    """Margin windows far wider than the scaffolds, on the stream path."""
    sts, fa = _assembly(tmp_path)
    params = {"wordsize": wordsize, "margin": margin, "iupac_mode": 1}
    eng = MerPCR(device=cuda, **params)
    on_card = _search(eng, sts, fa)
    (cfg, _, n_rec), = eng.last_scans
    assert cfg.stream and n_rec == 400 and cfg.margin >= margin
    assert on_card == _search(MerPCR(device="cpu", **params), sts, fa)
    assert on_card.count("\n") > 0


@pytest.mark.gpu
def test_card_search_equals_cpu_search(cuda, tmp_path):
    sts, fa = _corpus(tmp_path)
    counts = [f.launches for f in PATH]
    on_card = _search(MerPCR(device=cuda), sts, fa)
    assert on_card == _search(MerPCR(device="cpu"), sts, fa)
    assert on_card.count("\n") > 0
    launched = [f.launches - c0 for f, c0 in zip(PATH, counts)]
    assert all(k > 0 for k in launched), launched
    assert _search(MerPCR(), GOLDEN_STS, GOLDEN_FA) == GOLDEN_LINE + "\n"


@pytest.mark.gpu
def test_wrapper_launches_on_the_last_device(cuda, tmp_path):
    """A tile on the last card launches there while another card is
    current (``kernels.on_device``)."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards")
    dev = torch.device("cuda", n - 1)
    eng, cfg, tiles = _tiles(tmp_path, dev)
    tb = eng._table
    tile, _t0, n_scan, _n = tiles[0]
    assert torch.cuda.current_device() != dev.index
    before = front_end.launches
    args = (tile, tb.qbloom_s, tb.gq, cfg.wordsize, cfg.lead, cfg.tile_len, n_scan)
    w, c = front_end(*args)
    torch.cuda.synchronize(dev)
    wp, cp = front_end_plain(*args)
    assert front_end.launches == before + 1 and w.device == dev
    assert torch.equal(w, wp) and torch.equal(c, cp) and int(c) > 0


@pytest.mark.gpu
def test_card_mesh_search_equals_cpu_search(cuda, tmp_path):
    """Two and three shards on one card, and a shard on every card: the
    CPU search's bytes, every wrapper launched, none more than once per
    global tile."""
    from merpcr_tpu_torch.parallel import make_mesh

    sts, fa = _corpus(tmp_path)
    want = _search(MerPCR(device="cpu"), sts, fa)
    assert want.count("\n") > 0
    for mesh in ((cuda,) * 2, (cuda,) * 3, None):
        counts = [f.launches for f in PATH]
        eng = MerPCR(device=cuda).use_mesh(make_mesh(mesh))
        eng._tile_len_override = 1 << 15
        assert _search(eng, sts, fa) == want
        (scan,) = eng.last_scans
        n_global = scan.shards * -(-scan.tiles // scan.shards)
        launched = [f.launches - c0 for f, c0 in zip(PATH, counts)]
        assert launched[0] == launched[1] == n_global, (mesh, launched)
        assert all(0 < k <= n_global for k in launched), (mesh, launched)


def _raw_tiles(tmp_path, device, **params):
    """(engine on ``device``, raw cfg, per-tile argument tuples) of the
    corpus record rendered as RNA with junk bytes (the raw-byte path)."""
    sts, fa = _corpus(tmp_path)
    eng = MerPCR(device=device, **params)
    assert eng.load_sts_file(sts)
    rec, = _rna_records(fa)
    from merpcr_tpu_torch.io.fasta import record_packed, record_seq_bytes

    assert record_packed(rec) is None
    seq = record_seq_bytes(rec)
    n = len(seq)
    total = n - eng.wordsize + 1
    cfg = eng._base_config(1 << 15, packed=False)
    L = cfg.tile_len
    n_tiles = -(-total // L)
    plane = torch.from_numpy(eng._plane(seq, cfg.lead + n_tiles * L + cfg.tail, cfg.lead,
                                        packed=False)).to(device)
    tiles = [(plane[t * L : t * L + cfg.tile_buf_in], t * L, min(L, total - t * L), n)
             for t in range(n_tiles)]
    return eng, cfg, tiles


@pytest.mark.gpu
@pytest.mark.parametrize("wordsize,iupac,margin", [(11, 1, 50), (11, 0, 50), (3, 1, 50),
                                                   (13, 1, 300), (16, 0, 2000)])
def test_raw_kernels_equal_plain_versions(cuda, tmp_path, wordsize, iupac, margin):
    """K9: front_end_raw, expand_raw (bsc rows, bstart, binary search) and
    the byte modes of verify_p1/margin_p2 (fold and match table) against
    their plain versions on the tiles of an RNA rendering."""
    eng, cfg, tiles = _raw_tiles(tmp_path, cuda, wordsize=wordsize, iupac_mode=iupac,
                                 margin=margin)
    assert not cfg.packed and not cfg.strict
    tb = eng._table
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    hits = 0
    for tile, t0, n_scan, n in tiles:
        fe_args = (tile, tb.bloom, tb.bloom_bits, W, lead, L, n_scan)
        w, c = front_end_raw(*fe_args, tb.raw_prefilter)
        _assert_same((w, c), front_end_raw_plain(*fe_args))
        args = (tile, w, tb.csr, tb.emeta.shape[0], W, lead, L, n_scan)
        e, p, pt, qt = expand_raw(*args)
        _assert_same((e, p, pt, qt), expand_raw_plain(*args))
        assert pt == 0
        rm = record_rmeta(n, cuda)
        for match in ((tb.match, None) if iupac else (None,)):
            for nmm, x in ((0, 1), (2, 0)):
                vargs = (tile, e, p, tb.emeta, tb.p1_bytes, match, t0, rm, None, lead,
                         nmm, x)
                a = verify_p1_raw(*vargs)
                assert torch.equal(a, verify_p1_raw_plain(*vargs))
                margs = (tile, a, e, p, tb.emeta, tb.p2_bytes, match, t0, rm, None,
                         lead, margin, nmm, x)
                h = margin_p2_raw(*margs)
                assert torch.equal(h, margin_p2_raw_plain(*margs))
                hits += h.shape[0]
    torch.cuda.synchronize()
    assert hits > 0


@pytest.mark.gpu
@pytest.mark.parametrize("mismatches", [0, 1, 2])
def test_card_raw_search_equals_cpu_search(cuda, tmp_path, mismatches):
    """An RNA rendering at -I 1 on the card prints the DNA record's bytes
    and the CPU's, through the raw wrappers only, once per tile; then a
    scaffold assembly with every 7th scaffold rendered: the raw wrappers
    launch for those scaffolds, the packed ones for the stream runs."""
    sts, fa = _corpus(tmp_path)
    params = {"iupac_mode": 1, "mismatches": mismatches}
    counts = [f.launches for f in WRAPPERS]
    eng = MerPCR(device=cuda, **params)
    eng._tile_len_override = 1 << 15
    on_card = _search_records(eng, sts, _rna_records(fa))
    launched = dict(zip(WRAPPERS, (f.launches - c0 for f, c0 in zip(WRAPPERS, counts))))
    (cfg, n_tiles, _), = eng.last_scans
    assert not cfg.packed and n_tiles > 1
    assert all(launched[f] == (n_tiles if f in RAW_PATH else 0) for f in WRAPPERS), launched
    assert on_card == _search_records(MerPCR(device="cpu", **params), sts, _rna_records(fa))
    assert on_card.count("\n") > 0
    asm_sts, asm_fa = _assembly(tmp_path)
    counts = [f.launches for f in RAW_PATH]
    recs = _rna_records(asm_fa, every=7)
    on_card = _search_records(MerPCR(device=cuda, **params), asm_sts, recs)
    assert [f.launches - c0 for f, c0 in zip(RAW_PATH, counts)] == [58] * 4
    assert on_card == _search_records(MerPCR(device="cpu", **params), asm_sts, recs)


# ---------------------------------------------------------------- redesign edges
def _verify_cases():
    from .test_torch_verify_words import CASES, _case

    return CASES, _case


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["16", "17", "32", "33", "mixed"])
def test_verify_p1_edges_equal_plain(cuda, case):
    """verify_p1 (one launch, single-pass compaction, the word compare at
    -I 0) and verify_p1_raw against their plain versions on synthetic
    planes: primers of 16, 17, 32 and 33 bases, -X 0 to past l1, -N 0-3,
    windows across both plane edges (the lead halo included), a plane that
    starts off an 8-byte boundary, -I 1, raw planes at -I 0 and -I 1, and
    1, 255, 256, 257 pairs and 40,961 (161 tiles of the scan)."""
    from merpcr_tpu_torch.ops.encoding import NIB_ALPHABET, iupac_exp_masks, match_matrix

    cases, make = _verify_cases()
    lens, p1_max = cases[case]
    _rng, tile, entry, ppos, emeta, codes, lead = make(7 + len(case), lens, p1_max)
    _, exp_primer = iupac_exp_masks()
    letters = np.frombuffer(NIB_ALPHABET.encode() + b"U*", dtype=np.uint8)
    nib = np.stack([tile & 15, tile >> 4], axis=1).reshape(-1)
    raw_tile = letters[nib].copy()
    raw_tile[1::7] |= 0x20  # lowercase
    raw_tile[np.flatnonzero(raw_tile == ord("T"))[::3]] = ord("U")
    raw_tile[5::97] = ord("-")
    p1_bytes = letters[codes].copy()
    p1_bytes[codes == 17] = 0
    rmeta = torch.tensor([[0, 1 << 20]], dtype=torch.int32, device=cuda)
    e_all, p_all = (torch.from_numpy(a).to(cuda) for a in (entry, ppos))
    reps = -(-40_961 // len(entry))
    pair_sets = [(e_all[:n], p_all[:n]) for n in (1, 255, 256, 257, len(entry))]
    pair_sets.append((e_all.repeat(reps)[:40_961], p_all.repeat(reps)[:40_961]))
    em = torch.from_numpy(emeta).to(cuda)
    c = torch.from_numpy(codes).to(cuda)
    x_exp = torch.from_numpy(exp_primer[codes].view(np.int32)).to(cuda)
    b = torch.from_numpy(p1_bytes).to(cuda)
    anchors = 0
    for mis in (0, 3):
        buf = torch.zeros(tile.size + 16, dtype=torch.uint8, device=cuda)
        t = buf[mis : mis + tile.size]
        t.copy_(torch.from_numpy(tile))
        rbuf = torch.zeros(raw_tile.size + 16, dtype=torch.uint8, device=cuda)
        rt = rbuf[mis : mis + raw_tile.size]
        rt.copy_(torch.from_numpy(raw_tile))
        for e, p in pair_sets:
            for nmm, x in ((0, 0), (1, 1), (2, max(lens)), (3, max(lens) + 7), (3, 3)):
                args = (e, p, em)
                rest = (10_000, rmeta, None, lead, nmm, x)
                for p1x in (None, x_exp):
                    got = verify_p1(t, *args, c, p1x, *rest)
                    assert torch.equal(got, verify_p1_plain(t, *args, c, p1x, *rest)), (nmm, x)
                    anchors += got.numel()
                for m in (None, torch.from_numpy(match_matrix(True).reshape(-1)).to(cuda)):
                    got = verify_p1_raw(rt, *args, b, m, *rest)
                    assert torch.equal(got, verify_p1_raw_plain(rt, *args, b, m, *rest))
    torch.cuda.synchronize()
    assert anchors > 0


def _first_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """``words`` with only its first ``k`` set bits kept."""
    w = words.cpu().numpy().view(np.uint32)
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    keep = np.flatnonzero(bits)[:k]
    out = np.zeros_like(bits)
    out[keep] = 1
    return torch.from_numpy(np.packbits(out, bitorder="little").view(np.int32)).to(words.device)


@pytest.mark.gpu
def test_expand_edges_equal_plain(cuda, tmp_path):
    """expand, expand_loose and expand_raw (one launch, two when the pairs
    pass its buffer; each lookup made once) against their plain versions: a tile with no
    flagged unit, saturated tiles (all flag bits set, and a W = 3 set
    whose loose front end flags every stride group), raw lane counts 1, 255, 256,
    257 and 769, pair counts 1, 255, 256 and 257, and a bucket of 300 entries
    (the largest of its table)."""
    eng, cfg, tiles = _tiles(tmp_path, cuda)
    tb = eng._table
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    tile, _t0, n_scan, _n = tiles[1]
    n_e = tb.emeta.shape[0]

    def both(kernel, plain, args):
        got, want = kernel(*args), plain(*args)
        _assert_same(got, want)
        return got

    w, _ = front_end(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
    for words in (torch.zeros_like(w), torch.full_like(w, -1), w):
        out = both(expand, expand_plain, (tile, words, tb.ptab, tb.pf_bits, tb.t16,
                                          tb.t16_bits, tb.bsc, n_e, W, lead, L, n_scan, 4, True))
        assert (out[2] == 0) == (not bool(words.any()))
    wl = torch.zeros(L // 128, dtype=torch.int32, device=cuda)
    for words in (wl, torch.full_like(wl, -1)):
        out = both(expand_loose, expand_loose_plain, (tile, words, tb.ptab, tb.pf_bits, tb.bsc,
                                                      n_e, W, lead, L, n_scan, 4, True))
        assert (out[2] == 0) == (not bool(words.any()))
    # W = 3: the loose front end flags every stride group (many tiles of
    # both scans, ~2 x 10^5 pairs); strict with every unit flagged
    e3, c3, t3 = _tiles(tmp_path, cuda, wordsize=3)
    tb3 = e3._table
    tile3, _t, n3, _n = t3[0]
    w3, c = front_end_loose(tile3, tb3.qbloom, tb3.q_bits, 3, c3.lead, c3.tile_len, n3,
                            c3.stride, c3.qbloom_bits, tb3.loose_prefilter)
    assert int(c) == c3.tile_len // c3.stride
    out = both(expand_loose, expand_loose_plain, (tile3, w3, tb3.ptab, tb3.pf_bits, tb3.csr,
                                                  tb3.emeta.shape[0], 3, c3.lead, c3.tile_len,
                                                  n3, c3.stride, c3.exact_group))
    assert out[2] == c3.tile_len and out[3] > 256 * 256  # past the buffer: two launches
    out = both(expand, expand_plain, (tile3, torch.full_like(w, -1), tb3.ptab, tb3.pf_bits,
                                      tb3.t16, tb3.t16_bits, tb3.csr, tb3.emeta.shape[0], 3,
                                      c3.lead, c3.tile_len, n3, c3.stride, c3.exact_group))
    assert out[2] == c3.tile_len
    # raw, W = 5 (dense buckets): the lanes are the flag bits of clean windows
    from merpcr_tpu_torch.ops.units import raw_hashes

    re, rc, rtiles = _raw_tiles(tmp_path, cuda, wordsize=5)
    rtile, _t, rn, _n = rtiles[1]
    L5 = rc.tile_len
    rargs = (re._table.csr, re._table.emeta.shape[0], 5, rc.lead, L5, rn)
    _h, amb = raw_hashes(rtile, torch.arange(L5, device=cuda) + rc.lead, 5)
    clean = (~amb & (torch.arange(L5, device=cuda) < rn)).to(torch.uint8).cpu().numpy()

    def flag_words(flags):
        return torch.from_numpy(np.packbits(flags, bitorder="little").view(np.int32)).to(cuda)

    for k in (1, 255, 256, 257, 769):
        flags = clean.copy()
        flags[np.flatnonzero(flags)[k:]] = 0
        out = both(expand_raw, expand_raw_plain, (rtile, flag_words(flags), *rargs))
        assert out[2] == 0
    # pair counts: flag positions whose buckets add up to exactly n pairs
    _e, ppos_all, _p, _q = expand_raw_plain(rtile, flag_words(clean), *rargs)
    per_pos = torch.bincount(ppos_all.long().cpu(), minlength=L5).numpy()
    for n_pairs in (1, 255, 256, 257):
        flags, left = np.zeros(L5, dtype=np.uint8), n_pairs
        for pos in np.argsort(-per_pos, kind="stable"):
            if 0 < per_pos[pos] <= left:
                flags[pos], left = 1, left - per_pos[pos]
        assert left == 0
        assert both(expand_raw, expand_raw_plain, (rtile, flag_words(flags), *rargs))[3] == n_pairs
    # a bucket of 300 entries: 300 STS share primer 1, planted in the genome
    rng = np.random.default_rng(11)
    p1 = rng.choice(ACGT, size=20).tobytes().decode()
    seq = rng.choice(ACGT, size=70_000)
    for pos in (1_000, 33_000, 52_345):
        seq[pos : pos + 20] = np.frombuffer(p1.encode(), dtype=np.uint8)
    sts = tmp_path / "big.sts"
    sts.write_text("".join(f"B{i}\t{p1}\t{rng.choice(ACGT, size=22).tobytes().decode()}\t150\n"
                           for i in range(300)))
    fa = tmp_path / "big.fa"
    fa.write_text(">big\n" + seq.tobytes().decode() + "\n")
    eb = MerPCR(device=cuda)
    assert eb.load_sts_file(str(sts))
    from merpcr_tpu_torch.io.fasta import record_packed

    rec = eb.load_fasta_file(str(fa))[0]
    cb = eb._base_config(1 << 15)
    total = len(rec.sequence) - 10
    plane = torch.from_numpy(eb._plane(record_packed(rec), cb.lead + 3 * cb.tile_len + cb.tail,
                                       cb.lead, packed=True)).to(cuda)
    biggest = int(eb._table.bsc[:, 1].max())
    assert biggest >= 300 and cb.strict
    seen = 0
    for t in range(-(-total // cb.tile_len)):
        bt = plane[t * cb.tile_len // 2 : t * cb.tile_len // 2 + cb.tile_buf_in]
        bn = min(cb.tile_len, total - t * cb.tile_len)
        tbb = eb._table
        bw, _ = front_end(bt, tbb.qbloom_s, tbb.gq, 11, cb.lead, cb.tile_len, bn)
        out = both(expand, expand_plain, (bt, bw, tbb.ptab, tbb.pf_bits, tbb.t16, tbb.t16_bits,
                                          tbb.bsc, tbb.emeta.shape[0], 11, cb.lead, cb.tile_len,
                                          bn, 4, True))
        seen = max(seen, int(torch.bincount(out[1].long().cpu()).max()) if out[3] else 0)
    torch.cuda.synchronize()
    assert seen == biggest


def _margin_cases():
    from .test_torch_margin_words import CASES, _case

    return CASES, _case


@pytest.mark.gpu
@pytest.mark.parametrize("margin", [0, 50, 1000, 10000])
@pytest.mark.parametrize("case", ["11", "16", "17", "32", "mixed"])
def test_margin_p2_edges_equal_plain(cuda, monkeypatch, case, margin):
    """margin_p2 and margin_p2_raw (one launch, a block per anchor, the
    staged window, the word compare at -I 0) against their plain versions
    on synthetic planes: primer-2 lengths 5 to 33, -M 0, 50, 1000, 10000,
    -N 0-3 with -X 0 to past l2, windows across both plane edges, a plane
    off an 8-byte boundary, a record that ends inside the plane (records
    shorter than the window), a stream plane (K14), -I 1, the byte mode at
    -I 0 and -I 1, and rows past the buffer (two launches)."""
    from merpcr_tpu_torch.ops.encoding import NIB_ALPHABET, iupac_exp_masks, match_matrix

    cases, make = _margin_cases()
    lens, p2_max = cases[case]
    _rng, tile, entry, ppos, emeta, codes, lead = make(3 + len(case) + margin, lens, p2_max,
                                                       margin, 64)
    _, exp_primer = iupac_exp_masks()
    letters = np.frombuffer(NIB_ALPHABET.encode() + b"U*", dtype=np.uint8)
    nib = np.stack([tile & 15, tile >> 4], axis=1).reshape(-1)
    raw_tile = letters[nib].copy()
    raw_tile[1::7] |= 0x20  # lowercase
    raw_tile[np.flatnonzero(raw_tile == ord("T"))[::3]] = ord("U")
    raw_tile[5::97] = ord("-")
    p2_bytes = letters[codes].copy()
    p2_bytes[codes == 17] = 0
    a_idx = torch.arange(len(entry), dtype=torch.int32, device=cuda)
    e, p, em = (torch.from_numpy(x).to(cuda) for x in (entry, ppos, emeta))
    c = torch.from_numpy(codes).to(cuda)
    x_exp = torch.from_numpy(exp_primer[codes].view(np.int32)).to(cuda)
    b = torch.from_numpy(p2_bytes).to(cuda)
    match = torch.from_numpy(match_matrix(True).reshape(-1)).to(cuda)
    starts = np.arange(0, 2 * tile.size + 8192, 512)
    stream = np.stack([starts, np.full_like(starts, 500)], axis=1).astype(np.int32)
    planes = (  # (rmeta, recmap, tile_start)
        (np.array([[0, 1 << 20]], dtype=np.int32), None, 10_000),
        (np.array([[0, 10_000 + 2 * tile.size - 300 - lead]], dtype=np.int32), None, 10_000),
        (stream, torch.from_numpy(np.repeat(np.arange(len(starts), dtype=np.int32), 64)), 4096),
    )
    top = max(lens)
    hits = 0
    for mis in (0, 3):
        buf = torch.zeros(tile.size + 16, dtype=torch.uint8, device=cuda)
        t = buf[mis : mis + tile.size]
        t.copy_(torch.from_numpy(tile))
        rbuf = torch.zeros(raw_tile.size + 16, dtype=torch.uint8, device=cuda)
        rt = rbuf[mis : mis + raw_tile.size]
        rt.copy_(torch.from_numpy(raw_tile))
        for rm_np, rc, t0 in planes:
            rm = torch.from_numpy(rm_np).to(cuda)
            rc = None if rc is None else rc.to(cuda)
            for nmm, x in ((0, 0), (1, 1), (2, top), (3, top + 7), (3, 3)):
                rest = (t0, rm, rc, lead, margin, nmm, x)
                for p2x in (None, x_exp):
                    got = margin_p2(t, a_idx, e, p, em, c, p2x, *rest)
                    assert torch.equal(got, margin_p2_plain(t, a_idx, e, p, em, c, p2x, *rest))
                    hits += got.shape[0]
                for m in (None, match):
                    got = margin_p2_raw(rt, a_idx, e, p, em, b, m, *rest)
                    assert torch.equal(got, margin_p2_raw_plain(rt, a_idx, e, p, em, b, m, *rest))
        rest = (10_000, torch.from_numpy(planes[0][0]).to(cuda), None, lead, margin, 3, 0)
        want = margin_p2_plain(t, a_idx, e, p, em, c, None, *rest)
        with monkeypatch.context() as mp:
            mp.setattr(margin_mod, "ROW_CAP", 3)
            for f, args in ((margin_p2, (t, a_idx, e, p, em, c, None)),
                            (margin_p2_raw, (rt, a_idx, e, p, em, b, match))):
                c0 = f.launches
                got = f(*args, *rest)
                assert f.launches - c0 == 1 + (got.shape[0] > 3)
                if f is margin_p2:
                    assert torch.equal(got, want)
    torch.cuda.synchronize()
    assert hits > 0 and want.shape[0] > 3


@pytest.mark.gpu
def test_front_end_edges_equal_plain(cuda, tmp_path):
    """front_end (one launch: 4 units a thread, the last block's c_total, no
    fill) against front_end_plain over qbloom_s and qbloom_s1: n_scan at 0,
    inside a thread's 4 units and at the tile's end, a tile whose last warp
    is partly live (tile_len 768: 24 threads), dirty keys (2 % ambiguity
    letters), a plane off a 16-byte boundary (scalar loads), and
    ``flag_count`` reading the count that the next ``expand`` hands to the
    host."""
    from merpcr_tpu_torch.ops import front_end as front_mod

    eng, cfg, tiles = _tiles(tmp_path, cuda, mismatches=1)
    assert cfg.strict_n == 1
    tb = eng._table
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    tile = tiles[1][0]
    rng = np.random.default_rng(4)
    nib = np.stack([(tile.cpu().numpy() & 15), tile.cpu().numpy() >> 4], axis=1).reshape(-1)
    dirty = rng.random(nib.size) < 0.02
    nib[dirty] = rng.integers(4, 16, int(dirty.sum()))
    dirty_tile = torch.from_numpy((nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)).to(cuda)
    buf = torch.zeros(tile.numel() + 16, dtype=torch.uint8, device=cuda)
    off = buf[4 : 4 + tile.numel()]  # units 4 bytes past a 16-byte boundary
    off.copy_(dirty_tile)
    flagged = 0
    for t in (tile, dirty_tile, off):
        for qb, gq in ((tb.qbloom_s, tb.gq), (tb.qbloom_s1, tb.gq1)):
            for tl in (L, 768):
                for n_scan in (0, 1, 7, 8, 9, 31, 33, tl - 5, tl):
                    args = (t, qb, gq, W, lead, tl, n_scan)
                    w, cnt = front_end(*args)
                    wp, cp = front_end_plain(*args)
                    assert torch.equal(w, wp) and torch.equal(cnt, cp), (tl, n_scan)
                    flagged += int(cp)
                # the tile's expand hands the count to the host
                expand(t, w, tb.ptab, tb.pf_bits, tb.t16_1, tb.t16_1_bits, tb.bsc,
                       tb.emeta.shape[0], W, lead, tl, tl, 4, True)
                assert front_mod.flag_count(cnt) == int(cp)
    torch.cuda.synchronize()
    assert flagged > 0


def _with_dirt(tile: torch.Tensor, rng, share: float, codes=(4, 16)) -> torch.Tensor:
    """A nibble plane with a share ``share`` of its codes replaced by codes
    in [codes[0], codes[1]) (4..15: ambiguity letters)."""
    p = tile.cpu().numpy()
    nib = np.stack([p & 15, p >> 4], axis=1).reshape(-1)
    m = rng.random(nib.size) < share
    nib[m] = rng.integers(codes[0], codes[1], int(m.sum()))
    return torch.from_numpy((nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)).to(tile.device)


def _off_boundary(tile: torch.Tensor, by: int) -> torch.Tensor:
    """``tile`` copied ``by`` bytes past a 16-byte boundary (scalar loads)."""
    buf = torch.zeros(tile.numel() + 32, dtype=torch.uint8, device=tile.device)
    off = buf[by : by + tile.numel()]
    off.copy_(tile)
    return off


@pytest.mark.gpu
@pytest.mark.parametrize("wordsize", [3, 8, 11, 12, 13, 14, 16])
def test_front_end_loose_edges_equal_plain(cuda, tmp_path, wordsize):
    """front_end_loose (one launch: 4 units a thread, a prefilter, the last
    block's c_total, no fill) against front_end_loose_plain: the table's
    prefilter, a copy of the table as its own prefilter where it has at most
    2^20 bits (as on a replica), a 2^12-bit fold (many confirming gathers),
    an all-ones prefilter and an all-ones table; n_scan at 0, inside a
    thread's units, mid-word and at the tile's end; a tile whose last warp
    is partly live (tile_len 768); 3 % dirty codes (dirty key spans), an
    all-dirty tile and a plane off a 16-byte boundary. ``flag_count`` after
    ``expand_loose`` reads each count, and a strict tile that follows a
    loose one on the same device reads its own."""
    from merpcr_tpu_torch.ops import front_end as front_mod
    from merpcr_tpu_torch.ops.table import fold_bits

    eng, cfg, tiles = _tiles(tmp_path, cuda, wordsize=wordsize, mismatches=2)
    assert not cfg.strict
    tb = eng._table
    W, lead, L, S = cfg.wordsize, cfg.lead, cfg.tile_len, cfg.stride
    rng = np.random.default_rng(wordsize)
    tile = tiles[1][0]
    dirty = _with_dirt(tile, rng, 0.03)
    variants = (tile, dirty, _with_dirt(tile, rng, 1.0), _off_boundary(dirty, 4))
    pre, pre_bits, pre_shift = tb.loose_prefilter
    prefilters = [tb.loose_prefilter]
    if tb.q_bits <= 20:  # (a prefilter as large as the table is the table)
        prefilters.append((tb.qbloom.clone(), tb.q_bits, 0))
    if pre_bits < tb.q_bits:
        prefilters.append((torch.full_like(pre, -1), pre_bits, pre_shift))
    if tb.q_bits > 12:
        sh = tb.q_bits - 14
        prefilters.append((fold_bits(tb.qbloom, sh, 12), 12, sh))
    full = torch.full_like(tb.qbloom, -1)
    tables = ((tb.qbloom, prefilters),
              (full, [(fold_bits(full, pre_shift, pre_bits), pre_bits, pre_shift)]))
    flagged = 0
    for qb, pfs in tables:
        for t in variants:
            for tl in (L, 768):
                for n_scan in (0, 1, 7, 8, 9, 31, 33, tl // 2 + 13, tl - 5, tl):
                    args = (t, qb, tb.q_bits, W, lead, tl, n_scan, S, cfg.qbloom_bits)
                    wp, cp = front_end_loose_plain(*args)
                    for pf in pfs:
                        w, cnt = front_end_loose(*args, prefilter=pf)
                        assert torch.equal(w, wp) and torch.equal(cnt, cp), (tl, n_scan, pf[1:])
                    flagged += int(cp)
                # the tile's expand hands the last count to the host
                expand_loose(t, w, tb.ptab, tb.pf_bits, tb.csr, tb.emeta.shape[0], W, lead,
                             tl, tl, S, cfg.exact_group)
                assert front_mod.flag_count(cnt) == int(cp)
    assert flagged > 0
    # a strict tile after the loose one reads its own count
    if eng._meta.strict:
        ws, cs = front_end(tile, tb.qbloom_s, tb.gq, W, lead, L, L)
        expand(tile, ws, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.csr, tb.emeta.shape[0],
               W, lead, L, L, S, cfg.exact_group)
        assert front_mod.flag_count(cs) == int(front_end_plain(tile, tb.qbloom_s, tb.gq, W,
                                                               lead, L, L)[1])
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("wordsize", [3, 7, 11, 12, 13, 16])
def test_front_end_raw_edges_equal_plain(cuda, tmp_path, wordsize):
    """front_end_raw (one launch: 16 positions a thread with a rolling
    W-mer, a prefilter, the last block's c_total, no fill) against
    front_end_raw_plain: the table's prefilter, a copy of the bloom as its
    own prefilter where it has at most 2^20 bits, a 2^10-bit fold, an
    all-ones prefilter and an all-ones bloom; n_scan at 0, 1, inside a thread's run, mid-word and at the
    tile's end; tile_len 768; ambiguous bytes at both ends of windows and
    at the tile's ends, an all-junk tile and a plane off a 16-byte
    boundary. ``flag_count`` after ``expand_raw`` reads each count."""
    from merpcr_tpu_torch.ops import front_end as front_mod
    from merpcr_tpu_torch.ops.table import fold_bits

    eng, cfg, tiles = _raw_tiles(tmp_path, cuda, wordsize=wordsize)
    tb = eng._table
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    tile = tiles[1][0]
    edged = tile.clone()
    for pos in range(lead, lead + L - W - 8, 301):  # a window's first and last byte
        edged[pos] = ord("N")
        edged[pos + W + 7] = ord("-")
    edged[lead] = edged[lead + L - 1] = edged[lead + 767] = ord("*")
    junk = torch.full_like(tile, ord("-"))
    variants = (tile, edged, junk, _off_boundary(edged, 4))
    pre, pre_bits, _ = tb.raw_prefilter
    prefilters = [tb.raw_prefilter]
    if tb.bloom_bits <= 20:
        prefilters.append((tb.bloom.clone(), tb.bloom_bits, 0))
    if pre_bits < tb.bloom_bits:
        prefilters.append((torch.full_like(pre, -1), pre_bits, 0))
    if tb.bloom_bits > 10:
        prefilters.append((fold_bits(tb.bloom, 0, 10), 10, 0))
    full = torch.full_like(tb.bloom, -1)
    tables = ((tb.bloom, prefilters), (full, [(fold_bits(full, 0, pre_bits), pre_bits, 0)]))
    flagged = 0
    for bl, pfs in tables:
        for t in variants:
            for tl in (L, 768):
                for n_scan in (0, 1, 15, 16, 17, 31, 33, tl // 2 + 13, tl - 5, tl):
                    args = (t, bl, tb.bloom_bits, W, lead, tl, n_scan)
                    wp, cp = front_end_raw_plain(*args)
                    for pf in pfs:
                        w, cnt = front_end_raw(*args, prefilter=pf)
                        assert torch.equal(w, wp) and torch.equal(cnt, cp), (tl, n_scan, pf[1:])
                    flagged += int(cp)
                expand_raw(t, w, tb.csr, tb.emeta.shape[0], W, lead, tl, tl)
                assert front_mod.flag_count(cnt) == int(cp)
    assert flagged > 0
    torch.cuda.synchronize()


# ------------------------------------------------------ host path on the card
@pytest.mark.gpu
def test_card_host_path_launches_nothing(cuda, monkeypatch):
    """The golden files on the default gate: the host path, with no launch
    and no table on the card."""
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    counts = [f.launches for f in WRAPPERS]
    eng = MerPCR(device=cuda)
    assert _search(eng, GOLDEN_STS, GOLDEN_FA) == GOLDEN_LINE + "\n"
    assert [f.launches for f in WRAPPERS] == counts
    assert eng._tables == {} and eng.last_scans == []


@pytest.mark.gpu
def test_card_driver_check_agrees_with_torch(cuda):
    """The engine finds the card through the CUDA driver, without torch:
    the driver sees the cards that torch sees."""
    from merpcr_tpu_torch.engine import cuda_device_count, resolve_device

    assert cuda_device_count() == torch.cuda.device_count() >= 1
    assert resolve_device(None) == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        resolve_device(f"cuda:{torch.cuda.device_count()}")


@pytest.mark.gpu
def test_card_golden_cli_on_the_default_gate_loads_no_torch(cuda):
    """``python -m merpcr_tpu_torch`` on the golden files and the default
    gate, in a fresh process on the card: the golden line, and no torch in
    ``sys.modules`` at exit (read through runpy, which ``-m`` runs)."""
    code = (
        "import json, runpy, sys\n"
        f"sys.argv = ['merpcr_tpu_torch', {GOLDEN_STS!r}, {GOLDEN_FA!r}]\n"
        "try:\n"
        "    runpy.run_module('merpcr_tpu_torch', run_name='__main__', alter_sys=True)\n"
        "except SystemExit as e:\n"
        "    assert e.code in (0, None), e.code\n"
        "print(json.dumps('torch' in sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("MERPCR_TPU_HOST_MAX", "MERPCR_TPU_PLATFORM")}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout == GOLDEN_LINE + "\nfalse\n"


@pytest.mark.gpu
@pytest.mark.parametrize("gate", ["default", "0"])
@pytest.mark.parametrize("run", [1, 2])
def test_card_traced_cli_exits_cleanly(cuda, tmp_path, gate, run):
    """A cold traced golden CLI (``MERPCR_TPU_TRACE``) on each side of the
    gate, twice: exit code 0, the golden line, one trace. The card check
    leaves the process's CUDA driver to torch; a driver initialised in the
    process before torch loaded its CUDA libraries made such runs abort at
    exit, in the profiler's teardown, now and then."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MERPCR_TPU_HOST_MAX", "MERPCR_TPU_PLATFORM")}
    if gate == "0":
        env["MERPCR_TPU_HOST_MAX"] = "0"
    env["MERPCR_TPU_TRACE"] = str(tmp_path / "trace")
    r = subprocess.run([sys.executable, "-m", "merpcr_tpu_torch", GOLDEN_STS, GOLDEN_FA],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout == GOLDEN_LINE + "\n" and len(os.listdir(tmp_path / "trace")) == 1


@pytest.mark.gpu
def test_card_forced_fallback_launches_the_kernels(cuda, monkeypatch):
    """With the host path's candidate cap lowered to 0 (a test hook), the
    golden record leaves the host path on the default gate: the kernels
    launch and print the golden line."""
    from merpcr_tpu_torch.ops import host_scan

    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    monkeypatch.setattr(host_scan, "MAX_CANDIDATES", 0)
    counts = [f.launches for f in PATH]
    eng = MerPCR()
    assert _search(eng, GOLDEN_STS, GOLDEN_FA) == GOLDEN_LINE + "\n"
    assert all(b > a for a, b in zip(counts, [f.launches for f in PATH]))
    assert [s.records for s in eng.last_scans] == [1] and eng.device.type == "cuda"


@pytest.mark.gpu
def test_card_warm_engine_keeps_small_searches_on_the_kernels(cuda, monkeypatch):
    """Once a search has put the table on the card, a small search on the
    same engine and the default gate launches the kernels."""
    eng = MerPCR(device=cuda)
    recs = eng.load_fasta_file(GOLDEN_FA)
    assert _search_records(eng, GOLDEN_STS, recs) == GOLDEN_LINE + "\n"  # at 0: uploads
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    counts = [f.launches for f in PATH]
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs)
    assert buf.getvalue() == GOLDEN_LINE + "\n"
    after = [f.launches for f in PATH]
    assert all(b > a for a, b in zip(counts, after)), (counts, after)
    assert len(eng.last_scans) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("flood", ["candidates", "window"])
def test_card_flood_falls_back_to_the_kernels(cuda, monkeypatch, tmp_path, flood):
    """A corpus past a host-path cap runs on the kernels on the default
    gate, with the CPU's bytes; the window flood's tiles pass the deferred
    scan's row buffer and are rerun count first, where the rows take
    margin_p2's second launch."""
    sts, fa, params = flood_corpus(tmp_path, flood)
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX")
    counts = {f: f.launches for f in WRAPPERS}
    eng = MerPCR(device=cuda, **params)
    on_card = _search(eng, sts, fa)
    launched = {f.__name__: f.launches - c0 for f, c0 in counts.items()}
    (scan,) = eng.last_scans
    assert on_card == _search(MerPCR(device="cpu", **params), sts, fa)
    front, exp = ("front_end", "expand") if scan.cfg.strict else ("front_end_loose", "expand_loose")
    reruns = len(scan.reruns)
    assert launched[exp + "_deferred"] == scan.tiles, launched
    assert launched[front] == scan.tiles + reruns and launched[exp] == reruns, launched
    if flood == "window":
        assert reruns == scan.tiles and launched["margin_p2"] == 2 * reruns
        assert on_card.count("\n") > 8192


@pytest.mark.gpu
def test_card_trace_holds_the_kernels(cuda, monkeypatch, tmp_path):
    """MERPCR_TPU_TRACE on a card search: one Chrome trace with a kernel
    event of each of the -N 0 path's four kernels, and the same bytes."""
    sts, fa = _corpus(tmp_path)
    eng = MerPCR(device=cuda)
    want = _search(eng, sts, fa)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("MERPCR_TPU_TRACE", str(trace_dir))
    assert _search(eng, sts, fa) == want and want.count("\n") > 0
    (name,) = os.listdir(trace_dir)
    with open(trace_dir / name) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    for k in ("front_end_kernel", "expand_kernel", "verify_p1_kernel", "margin_p2_kernel"):
        assert any(k in n for n in names), (k, sorted(set(names))[:20])


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["record", "assembly"])
def test_card_trace_counts_launches_and_waits(cuda, tmp_path, layout):
    """A traced warm card search with no rerun: four launches a tile (the
    front end and three deferred stages), one host read and one
    ``collect.wait`` span a plane, and the bytes of the untraced search."""
    sts, fa = _corpus(tmp_path) if layout == "record" else _assembly(tmp_path)
    eng = MerPCR(device=cuda)
    eng._tile_len_override = 1 << 15  # tens of tiles on one plane
    recs = eng.load_fasta_file(fa)
    want = _search_records(eng, sts, recs)
    eng.tracing = True
    buf = io.StringIO()
    with redirect_stdout(buf):
        eng.search(recs)
    assert buf.getvalue() == want and want.count("\n") > 0
    rec, scans = eng.last_trace, eng.last_scans
    c = rec.counters
    assert c["reruns"] == 0 and c["tiles"] == sum(p.tiles for p in scans) > len(scans)
    assert c["launches"] == 4 * c["tiles"], c
    stages = {k: v for k, v in c.items() if k.startswith("launches.")}
    assert sorted(stages.values()) == [c["tiles"]] * 4, stages
    assert c["host_reads"] == len(scans)
    assert sum(s.name == "collect.wait" for s in rec.spans) == len(scans)
    assert c["lines"] == want.count("\n")


@pytest.mark.gpu
def test_card_front_end_counters(cuda, tmp_path, monkeypatch):
    """-N 0, 1, 1, 2 on one traced card engine: the strict0, strict1 and
    loose front ends, one host read a search, ``flagged`` and
    ``positions`` the sums of the tiles' ``c_total`` and ``pos_total``,
    ``front_end.<mode>`` the tiles, and ``table.strict1`` in the first -N 1
    search alone; the bytes of an untraced engine's search."""
    sts, fa = _corpus(tmp_path)
    eng, plain = MerPCR(device=cuda), MerPCR(device=cuda)
    eng._tile_len_override = plain._tile_len_override = 1 << 15
    recs = eng.load_fasta_file(fa)
    assert eng.load_sts_file(sts) and plain.load_sts_file(sts)
    outs = []
    real = scan_mod.collect_stream

    def collect(p):
        got, reruns = real(p)
        outs.extend(got)
        return got, reruns

    monkeypatch.setattr(scan_mod, "collect_stream", collect)
    eng.tracing = True
    builds = []
    for n, mode in ((0, "strict0"), (1, "strict1"), (1, "strict1"), (2, "loose")):
        eng.mismatches = plain.mismatches = n
        want = io.StringIO()
        with redirect_stdout(want):
            plain.search(recs)
        outs.clear()
        buf = io.StringIO()
        with redirect_stdout(buf):
            eng.search(recs)
        assert buf.getvalue() == want.getvalue() and buf.getvalue().count("\n") > 0
        c, (scan,) = eng.last_trace.counters, eng.last_scans
        assert c["host_reads"] == 1 and c["reruns"] == 0, c
        assert c[f"front_end.{mode}"] == c["tiles"] == scan.tiles == len(outs) > 1, c
        assert c["flagged"] == sum(o.c_total for o in outs) > 0
        assert c["positions"] == sum(o.pos_total for o in outs) > 0
        builds.append(sum(s.name == "table.strict1" for s in eng.last_trace.spans))
    assert builds == [0, 1, 0, 0]


# ------------------------------------------------ the deferred tile scan
def _deferred_stages(cfg, tb, tile, t0, n_scan, n, device, kernel: bool, rows_cap: int):
    """The deferred expand, verify_p1 and margin_p2 of one tile: the
    wrappers (kernels on the card) or their plain versions under the same
    buffer contract, on the same card tensors. Returns (totals, entry,
    ppos, a_idx, rows)."""
    totals = torch.full((5,), -7, dtype=torch.int32, device=device)
    rows = torch.full((rows_cap, 6), -7, dtype=torch.int32, device=device)
    rm = record_rmeta(n, device)
    W, lead, L = cfg.wordsize, cfg.lead, cfg.tile_len
    if not cfg.packed:
        w, c = front_end_raw(tile, tb.bloom, tb.bloom_bits, W, lead, L, n_scan,
                             tb.raw_prefilter)
        args = (tile, w, tb.csr, tb.emeta.shape[0], W, lead, L, n_scan)
        ex, ex_plain = expand_raw, expand_raw_plain
    elif cfg.strict:
        w, c = front_end(tile, tb.qbloom_s, tb.gq, W, lead, L, n_scan)
        args = (tile, w, tb.ptab, tb.pf_bits, tb.t16, tb.t16_bits, tb.csr,
                tb.emeta.shape[0], W, lead, L, n_scan, cfg.stride, cfg.exact_group, None,
                tb.bloom_bits)
        ex, ex_plain = expand, expand_plain
    else:
        w, c = front_end_loose(tile, tb.qbloom, tb.q_bits, W, lead, L, n_scan, cfg.stride,
                               cfg.qbloom_bits, tb.loose_prefilter)
        args = (tile, w, tb.ptab, tb.pf_bits, tb.csr, tb.emeta.shape[0], W, lead, L,
                n_scan, cfg.stride, cfg.exact_group)
        ex, ex_plain = expand_loose, expand_loose_plain
    if kernel:
        e, p = ex(*args, totals=totals, c_total=c)
    else:
        e, p = expand_mod.deferred_plain(ex_plain(*args), c.cpu(), totals, L)
    p1, p2 = (tb.p1_codes, tb.p2_codes) if cfg.packed else (tb.p1_bytes, tb.p2_bytes)
    vf, vplain, mf, mplain = ((verify_p1, verify_p1_plain, margin_p2, margin_p2_plain)
                              if cfg.packed else
                              (verify_p1_raw, verify_p1_raw_plain, margin_p2_raw,
                               margin_p2_raw_plain))
    match = tb.match if cfg.iupac and not cfg.packed else None  # the RNA record's U
    vargs = (tb.emeta, p1, match, t0, rm, None, lead, cfg_n(cfg), 1)
    margs = (tb.emeta, p2, match, t0, rm, None, lead, 50, cfg_n(cfg), 1)
    if kernel:
        a = vf(tile, e, p, *vargs, totals=totals)
        mf(tile, a, e, p, *margs, totals=totals, rows=rows)
    else:
        a = verify_mod.deferred_plain(vplain, tile, e, p, totals, *vargs)
        margin_mod.deferred_plain(mplain, tile, a, totals, rows, e, p, *margs)
    return totals, e, p, a, rows


def cfg_n(cfg) -> int:
    """The tile's -N: 0 on the strict path, 2 on the loose and raw ones."""
    return 0 if cfg.strict else 2


@pytest.mark.gpu
@pytest.mark.parametrize("caps", [None, (6, 1)])
@pytest.mark.parametrize("mode", ["strict", "loose", "raw"])
def test_deferred_kernels_equal_plain(cuda, tmp_path, monkeypatch, mode, caps):
    """expand, verify_p1 and margin_p2 in their deferred mode (counts from
    device memory, fixed buffers) against their plain versions under the
    same contract, tile by tile: the five device totals, the anchors and
    the rows, with the default buffers and with buffers that the tiles
    pass (truncated pairs, the true pair_total, rows cut at the buffer),
    and on an empty tile (no scan position)."""
    if caps:
        monkeypatch.setattr(expand_mod, "_pair_cap_override", caps[0])
        monkeypatch.setattr(margin_mod, "ROW_CAP", caps[1])
    if mode == "raw":
        eng, cfg, tiles = _raw_tiles(tmp_path, cuda, iupac_mode=1, mismatches=2)
    else:
        eng, cfg, tiles = _tiles(tmp_path, cuda, mismatches=0 if mode == "strict" else 2)
    assert cfg.packed == (mode != "raw") and cfg.strict == (mode == "strict")
    tb = eng._table
    cap = margin_mod.ROW_CAP
    tile0, t00, _n_scan, n0 = tiles[0]
    passed = {"pairs": 0, "rows": 0, "hits": 0}
    for tile, t0, n_scan, n in [(tile0, t00, 0, n0)] + tiles[:6]:
        got = _deferred_stages(cfg, tb, tile, t0, n_scan, n, cuda, True, cap)
        want = _deferred_stages(cfg, tb, tile, t0, n_scan, n, cuda, False, cap)
        tot = got[0].tolist()
        assert tot == want[0].tolist(), (tot, want[0].tolist())
        if n_scan == 0:
            assert tot == [0, 0, 0, 0, 0]
        kept = min(tot[2], expand_mod.pair_cap(cfg.tile_len))
        assert torch.equal(got[1][:kept], want[1][:kept]) and torch.equal(got[2][:kept], want[2][:kept])
        assert torch.equal(got[3][: tot[3]], want[3][: tot[3]])
        rows = min(tot[4], cap)
        assert torch.equal(got[4][:rows], want[4][:rows])
        passed["pairs"] += tot[2] > kept
        passed["rows"] += tot[4] > cap
        passed["hits"] += tot[4]
    assert passed["hits"] > 0
    if caps:
        assert passed["pairs"] > 0 and passed["rows"] > 0, passed


@pytest.mark.gpu
@pytest.mark.parametrize("caps", [None, (6, 1)])
def test_deferred_scan_on_card_equals_cpu(cuda, tmp_path, monkeypatch, caps):
    """``dispatch_stream``/``collect_stream`` on the card against the
    count-first ``scan_stream`` on the CPU, tile by tile: one host read for
    the plane, plus the count-first path's reads of each tile rerun past a
    buffer, exactly the tiles past one."""
    if caps:
        monkeypatch.setattr(expand_mod, "_pair_cap_override", caps[0])
        monkeypatch.setattr(margin_mod, "ROW_CAP", caps[1])
    eng, cfg, tiles = _tiles(tmp_path, cuda)
    tb = eng._table
    n = tiles[0][3]
    total = n - eng.wordsize + 1
    plane = tiles[0][0]._base  # the plane the tiles are views of
    rt = eng._runtime_params()
    args = (cfg, tb, plane, total, n, record_rmeta(n, cuda), None, rt, len(tiles))
    st = kernels.scan_state(plane)
    reads = st.reads
    got, reruns = scan_mod.collect_stream(scan_mod.dispatch_stream(*args))
    want = scan_mod.scan_stream(cfg, replicate(tb, torch.device("cpu")), plane.cpu(), total,
                                n, record_rmeta(n, "cpu"), None, rt, len(tiles))
    past = [t for t, o in enumerate(want)
            if o.pair_total > expand_mod.pair_cap(cfg.tile_len) or o.hit_total > margin_mod.ROW_CAP]
    assert reruns == past and bool(past) == bool(caps)
    for g, w in zip(got, want):
        assert list(g[:5]) == list(w[:5])
        assert all(torch.equal(a.cpu(), b) for a, b in zip(g[5:], w[5:]))
    if not caps:
        assert st.reads - reads == 1
