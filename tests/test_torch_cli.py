"""The port's CLI (``python -m merpcr_tpu_torch``) against the JAX
package's: legacy ``M=50`` syntax, ``-O``, ``--version``, ``-N 2``."""

from __future__ import annotations

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch

pytest.importorskip("jax")

from merpcr_tpu import cli as jax_cli  # noqa: E402
from merpcr_tpu_torch import MerPCR, __version__, cli  # noqa: E402

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, run_search  # noqa: E402


@pytest.fixture(autouse=True)
def _jax_device_path(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")


def _run(main, argv, **kw):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv, **kw)
    return rc, buf.getvalue()


@pytest.mark.parametrize(
    "flags",
    [["M=50"], ["M=0", "N=0", "W=11", "X=1"], ["-M", "100", "-Q", "0", "T=4"],
     ["M=64", "Z=300", "P=3"]],
)
def test_legacy_and_modern_flags_match_jax(flags):
    argv = [GOLDEN_STS, GOLDEN_FA, *flags]
    rc, out = _run(cli.main, argv, device="cpu")
    jrc, jout = _run(jax_cli.main, argv)
    assert (rc, out) == (jrc, jout) == (0, out)
    if flags != ["M=0", "N=0", "W=11", "X=1"]:
        assert out == GOLDEN_LINE + "\n"


@pytest.mark.parametrize("flags", [["-I", "1"], ["I=1", "M=100", "X=0"]])
def test_iupac_flag_matches_jax(flags):
    """-I 1 reaches the engine (the IUPAC verify, K11) through both flag
    syntaxes."""
    argv = [GOLDEN_STS, GOLDEN_FA, *flags]
    rc, out = _run(cli.main, argv, device="cpu")
    jrc, jout = _run(jax_cli.main, argv)
    assert (rc, out) == (jrc, jout) == (0, out)
    assert GOLDEN_LINE + "\n" in out


def test_output_file(tmp_path):
    out = tmp_path / "hits.txt"
    rc, stdout = _run(cli.main, [GOLDEN_STS, GOLDEN_FA, "-O", str(out)], device="cpu")
    assert rc == 0 and stdout == ""
    assert out.read_text() == GOLDEN_LINE + "\n"
    rc, stdout = _run(cli.main, [GOLDEN_STS, GOLDEN_FA, "O=stdout"], device="cpu")
    assert rc == 0 and stdout == GOLDEN_LINE + "\n"


def test_version(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(["--version"], device="cpu")
    assert e.value.code == 0
    assert capsys.readouterr().out.strip() == f"merPCR-TPU version {__version__}"


def test_failures_exit_1(tmp_path):
    bad = tmp_path / "bad.sts"
    bad.write_text("only\tthree\tfields\n")
    assert _run(cli.main, [str(bad), GOLDEN_FA], device="cpu")[0] == 1
    empty = tmp_path / "empty.fa"
    empty.write_text("")
    assert _run(cli.main, [GOLDEN_STS, str(empty)], device="cpu")[0] == 1
    # an error raised by the engine exits 1
    argv = [GOLDEN_STS, GOLDEN_FA, "--three-prime-match=-1"]
    assert _run(cli.main, argv, device="cpu")[0] == 1 == _run(jax_cli.main, argv)[0]
    # -W 12 was refused before every word size ran: it exits 0 now, with
    # the JAX package's bytes
    argv = [GOLDEN_STS, GOLDEN_FA, "-W", "12"]
    assert _run(cli.main, argv, device="cpu") == _run(jax_cli.main, argv)
    assert _run(cli.main, argv, device="cpu")[0] == 0


@pytest.mark.parametrize("flags", [["-N", "2"], ["N=2", "M=100"]])
def test_mismatch_flag_prints_the_api_bytes(flags):
    """-N 2 runs (the loose front end): the CLI prints what the API prints,
    and what the JAX package's CLI prints, through both flag syntaxes."""
    argv = [GOLDEN_STS, GOLDEN_FA, *flags]
    rc, out = _run(cli.main, argv, device="cpu")
    assert (rc, out) == _run(jax_cli.main, argv)
    eng = MerPCR(device="cpu", mismatches=2, margin=100 if "M=100" in flags else 50)
    assert eng.load_sts_file(GOLDEN_STS)
    assert rc == 0 and out == run_search(eng, eng.load_fasta_file(GOLDEN_FA))
    assert GOLDEN_LINE + "\n" in out


def test_module_entry_point_needs_a_card():
    """``python -m merpcr_tpu_torch`` runs on the card: without one it
    fails loudly instead of scanning on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # the default is the card, unless MERPCR_TPU_PLATFORM (tox.ini: cpu) says otherwise
    env = {k: v for k, v in os.environ.items() if k != "MERPCR_TPU_PLATFORM"}
    r = subprocess.run([sys.executable, "-m", "merpcr_tpu_torch", GOLDEN_STS, GOLDEN_FA],
                       cwd=root, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    assert "no CUDA device" in r.stderr
