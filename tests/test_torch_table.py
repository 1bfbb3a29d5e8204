"""The PyTorch port's table compiler equals the JAX package's, field by
field, and ``table_from_numpy`` carries the scanned fields unchanged."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

from merpcr_tpu.io.sts import STSLoader as JaxSTSLoader  # noqa: E402
from merpcr_tpu.ops.table import compile_table as jax_compile_table  # noqa: E402
from merpcr_tpu_torch.io.sts import STSLoader  # noqa: E402
from merpcr_tpu_torch.ops.table import compile_table, table_from_numpy  # noqa: E402

from .conftest import GOLDEN_STS  # noqa: E402

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_sts(path, seed: int, n: int, iupac: bool = False) -> str:
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTACGTACGTRYN" if iupac else b"ACGT", dtype=np.uint8)
    lines = []
    for i in range(n):
        p1 = rng.choice(alphabet, size=int(rng.integers(12, 28))).tobytes().decode()
        p2 = rng.choice(alphabet, size=int(rng.integers(12, 28))).tobytes().decode()
        size = f"{rng.integers(80, 200)}-{rng.integers(200, 500)}" if i % 7 == 0 else str(rng.integers(50, 450))
        lines.append(f"R{i}\t{p1}\t{p2}\t{size}\talias {i}\n")
    path.write_text("".join(lines))
    return str(path)


def _cases(tmp_path):
    return {
        "golden": GOLDEN_STS,
        "random": _random_sts(tmp_path / "r.sts", 1, 300),
        "ambiguous": _random_sts(tmp_path / "a.sts", 2, 60, iupac=True),
    }


@pytest.mark.parametrize("wordsize,iupac", [(11, False), (8, False), (11, True)])
@pytest.mark.parametrize("case", ["golden", "random", "ambiguous"])
def test_compile_table_matches_jax(tmp_path, case, wordsize, iupac):
    path = _cases(tmp_path)[case]
    res = STSLoader.load_file(path, wordsize, 240)
    jres = JaxSTSLoader.load_file(path, wordsize, 240)
    host, meta = compile_table(res, wordsize, iupac)
    jhost, jmeta = jax_compile_table(jres, wordsize, iupac, device=False)
    assert host._fields == jhost._fields
    for name in host._fields:
        a, b = getattr(host, name), getattr(jhost, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for f in dataclasses.fields(meta):
        a, b = getattr(meta, f.name), getattr(jmeta, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert [r.__dict__ for r in res.records] == [r.__dict__ for r in jres.records]


def test_table_from_numpy_keeps_bits(tmp_path):
    res = STSLoader.load_file(_cases(tmp_path)["random"], 11, 240)
    host, meta = compile_table(res, 11, False)
    t = table_from_numpy(host, meta, "cpu")
    for name in ("qbloom_s", "ptab", "t16"):
        got = getattr(t, name).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, getattr(host, name), err_msg=name)
    np.testing.assert_array_equal(t.bsc.numpy(), host.bsc)
    np.testing.assert_array_equal(t.emeta.numpy(), host.emeta)
    np.testing.assert_array_equal(t.p1_codes.numpy(), host.p1_codes)
    np.testing.assert_array_equal(t.p2_codes.numpy(), host.p2_codes)
    assert t.qbloom_s.dtype == torch.int32
    assert (1 << t.gq) == host.qbloom_s.size * 32
    assert t.pf_bits == 2 * (11 + 2) and t.t16_bits == meta.t16_bits > 0
