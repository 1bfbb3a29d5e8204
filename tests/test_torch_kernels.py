"""The port's four CUDA kernels against their plain PyTorch versions, and
the rules around them.

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
import os
import subprocess
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from merpcr_tpu_torch import MerPCR
from merpcr_tpu_torch.ops import kernels
from merpcr_tpu_torch.ops.expand import expand, expand_plain
from merpcr_tpu_torch.ops.front_end import front_end, front_end_plain
from merpcr_tpu_torch.ops.margin_p2 import margin_p2, margin_p2_plain
from merpcr_tpu_torch.ops.verify_p1 import verify_p1, verify_p1_plain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_STS = os.path.join(ROOT, "tests", "data", "test.sts")
GOLDEN_FA = os.path.join(ROOT, "tests", "data", "test.fa")
GOLDEN_LINE = "L78833\t75823..76023\tAFM248yg9\t(D17S932)  Chr.17, 63.7 cM\t(-)"
ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")


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


def _search(engine, sts, fa) -> str:
    assert engine.load_sts_file(sts)
    recs = engine.load_fasta_file(fa)
    buf = io.StringIO()
    with redirect_stdout(buf):
        engine.search(recs)
    return buf.getvalue()


# ---------------------------------------------------------------- CPU rules
def test_cpu_tensors_take_the_plain_versions(tmp_path):
    counts = [f.launches for f in (front_end, expand, verify_p1, margin_p2)]
    out = _search(MerPCR(device="cpu"), GOLDEN_STS, GOLDEN_FA)
    assert out == GOLDEN_LINE + "\n"
    assert [f.launches for f in (front_end, expand, verify_p1, margin_p2)] == counts


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


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        MerPCR()
    from merpcr_tpu_torch import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([GOLDEN_STS, GOLDEN_FA])


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, merpcr_tpu_torch\n"
        "for m in pkgutil.walk_packages(merpcr_tpu_torch.__path__, 'merpcr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'merpcr_tpu')]\n"
        "print(len([m for m in sys.modules if m.startswith('merpcr_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 15  # every module was imported


# ---------------------------------------------------------------- on the card
def _tiles(tmp_path, device):
    """(engine on ``device``, cfg, per-tile argument tuples) of the corpus."""
    sts, fa = _corpus(tmp_path)
    eng = MerPCR(device=device)
    assert eng.load_sts_file(sts)
    rec = eng.load_fasta_file(fa)[0]
    from merpcr_tpu_torch.io.fasta import record_packed

    packed = record_packed(rec)
    n = len(rec.sequence)
    total = n - 10
    cfg = eng._base_config(1 << 15)
    L = cfg.tile_len
    n_tiles = -(-total // L)
    plane = torch.from_numpy(eng._plane(packed, cfg.lead + n_tiles * L + cfg.tail, cfg.lead)).to(device)
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
                tb.emeta.shape[0], W, lead, L, n_scan)
        e, p, pt, qt = expand(*args)
        ep, pp, ptp, qtp = expand_plain(*args)
        assert (pt, qt) == (ptp, qtp)
        assert torch.equal(e, ep) and torch.equal(p, pp)
        for nmm, x in ((0, 1), (0, 0), (0, 3)):
            vargs = (tile, e, p, tb.emeta, tb.p1_codes, t0, n, lead, nmm, x)
            a = verify_p1(*vargs)
            assert torch.equal(a, verify_p1_plain(*vargs))
            for margin in (0, 50, 64):
                margs = (tile, a, e, p, tb.emeta, tb.p2_codes, t0, n, lead,
                         margin, nmm, x)
                h = margin_p2(*margs)
                assert torch.equal(h, margin_p2_plain(*margs))
                seen_hits += h.shape[0]
    torch.cuda.synchronize()
    assert seen_hits > 0


@pytest.mark.gpu
def test_card_search_equals_cpu_search(cuda, tmp_path):
    sts, fa = _corpus(tmp_path)
    counts = [f.launches for f in (front_end, expand, verify_p1, margin_p2)]
    on_card = _search(MerPCR(device=cuda), sts, fa)
    assert on_card == _search(MerPCR(device="cpu"), sts, fa)
    assert on_card.count("\n") > 0
    launched = [f.launches - c0 for f, c0 in zip((front_end, expand, verify_p1, margin_p2), counts)]
    assert all(k > 0 for k in launched), launched
    assert _search(MerPCR(), GOLDEN_STS, GOLDEN_FA) == GOLDEN_LINE + "\n"
