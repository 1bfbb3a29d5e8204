"""The port's multi-process search (K15c, ``merpcr_tpu_torch.parallel
.distributed``) against the JAX package's.

* one process: ``initialize()`` with no arguments and no launcher
  environment is a no-op, this process is the output host, and
  ``enable_multihost()`` prints the plain bytes;
* the CLI: ``--multihost`` and ``MERPCR_TPU_MULTIHOST=1`` give the plain
  run's exit code and bytes;
* two real processes: two gloo ranks over loopback on the CPU, each
  scanning its shard of every plane (a record and a stream of scaffolds,
  with an empty record between them) and gathering the rows: rank 0's file
  equals the one-process port bytes and the JAX bytes
  (``MERPCR_TPU_HOST_MAX=0``), rank 1 creates no file, and both return
  the same hit count.

Everything compared is a byte or an integer: tolerance 0.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR  # noqa: E402
from merpcr_tpu_torch.cli import main  # noqa: E402
from merpcr_tpu_torch.parallel import distributed  # noqa: E402

from .conftest import run_search  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
P1 = "GGCTCAGAGTATTTGGGATGCA"
P2 = "CTCTTGGAATCCTATCTCACTG"
TILE = 2048
LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK")


@pytest.fixture(autouse=True)
def _one_process(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    monkeypatch.delenv("MERPCR_TPU_MULTIHOST", raising=False)
    for k in LAUNCHER_ENV:
        monkeypatch.delenv(k, raising=False)


def _corpus(tmp_path, seed: int):
    """STS + FASTA: a 30 kb record with four planted amplicons (after
    ``tests/test_multihost.py``), an empty record, then three scaffolds
    with one amplicon each (a stream run)."""
    rng = np.random.default_rng(seed)

    def genome(n, plants):
        g = bytearray(rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=n).tobytes())
        for pos in plants:
            g[pos : pos + len(P1)] = P1.encode()
            g[pos + 200 - len(P2) : pos + 200] = P2.encode()
        return g.decode()

    n = 30_000
    records = [("mh", genome(n, (500, 9000, 21000, n - 203))), ("empty", "")]
    records += [(f"scaf{i}", genome(3000 + 700 * i, (100 + 900 * i,))) for i in range(3)]
    sts = tmp_path / "m.sts"
    sts.write_text(f"S1\t{P1}\t{P2}\t200\nS2\t{P2}\t{P1}\t300\n")
    fa = tmp_path / "m.fa"
    fa.write_text("".join(
        f">{label} multihost corpus\n" + "".join(s[i : i + 70] + "\n" for i in range(0, len(s), 70))
        for label, s in records))
    return str(sts), str(fa)


def _search(eng, sts, fa) -> str:
    eng._tile_len_override = TILE
    assert eng.load_sts_file(sts)
    return run_search(eng, eng.load_fasta_file(fa))


def test_single_process_noop(tmp_path):
    sts, fa = _corpus(tmp_path, 5)
    want = _search(MerPCR(device="cpu"), sts, fa)
    assert want.count("\n") >= 7
    distributed.initialize()
    assert not distributed.dist.is_initialized()
    assert distributed.is_output_host() and distributed.world_size() == 1
    eng = MerPCR(device="cpu").enable_multihost()
    assert eng._multihost and eng.mesh == (eng.device,)
    assert _search(eng, sts, fa) == want
    assert [s.shards for s in eng.last_scans] == [1, 1]
    assert _search(JaxMerPCR(), sts, fa) == want


def test_cli_multihost_flag_and_env(tmp_path, capsys, monkeypatch):
    sts, fa = _corpus(tmp_path, 6)
    called = []
    real = MerPCR.enable_multihost

    def spy(self, *args):
        called.append(args)
        return real(self, *args)

    monkeypatch.setattr(MerPCR, "enable_multihost", spy)
    assert main([sts, fa], device="cpu") == 0
    plain = capsys.readouterr().out
    assert plain.count("\n") >= 7 and not called
    assert main([sts, fa, "--multihost"], device="cpu") == 0
    assert capsys.readouterr().out == plain and called == [()]
    monkeypatch.setenv("MERPCR_TPU_MULTIHOST", "1")
    assert main([sts, fa], device="cpu") == 0
    assert capsys.readouterr().out == plain and called == [(), ()]


_WORKER = textwrap.dedent(
    """
    import sys
    pid, port, sts, fa, out = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5]
    )
    sys.path.insert(0, sys.argv[6])
    from merpcr_tpu_torch import MerPCR
    from merpcr_tpu_torch.parallel import distributed
    eng = MerPCR(device="cpu").enable_multihost(
        coordinator_address=f"127.0.0.1:{port}", num_processes=2, process_id=pid
    )
    assert distributed.world_size() == 2 and distributed.rank() == pid
    assert eng.mesh == (eng.device,) * 2
    eng._tile_len_override = 2048
    assert eng.load_sts_file(sts)
    hits = eng.search(eng.load_fasta_file(fa), out)
    shards = sorted({s.shards for s in eng.last_scans})
    print(f"WORKER {pid} hits={hits} shards={shards}", flush=True)
    """
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_gloo(tmp_path):
    """Two gloo ranks over loopback, on the CPU."""
    sts, fa = _corpus(tmp_path, 7)
    want = _search(MerPCR(device="cpu"), sts, fa)
    assert want.count("\n") >= 7
    assert _search(JaxMerPCR(), sts, fa) == want
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    outs = [str(tmp_path / f"out{i}.txt") for i in (0, 1)]
    env = {k: v for k, v in os.environ.items() if k not in LAUNCHER_ENV}
    # a port taken between _free_port and the rendezvous, or a loaded box,
    # fails the first attempt: retry once on a fresh port
    for attempt in (0, 1):
        port = _free_port()
        for o in outs:
            if os.path.exists(o):
                os.unlink(o)
        procs = [
            subprocess.Popen([sys.executable, str(worker), str(i), str(port), sts, fa,
                              outs[i], ROOT],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env)
            for i in (0, 1)
        ]
        try:
            results = [p.communicate(timeout=120) for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
                p.communicate()
            if attempt == 0:
                continue
            raise
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            break
    for i, p in enumerate(procs):
        assert p.returncode == 0, (i, results[i][0][-2000:], results[i][1][-2000:])
    lines = [ln for out, _ in results for ln in out.splitlines() if ln.startswith("WORKER")]
    assert len(lines) == 2
    assert {ln.split(" ", 2)[2] for ln in lines} == {f"hits={want.count(chr(10))} shards=[2]"}
    with open(outs[0]) as fh:
        assert fh.read() == want
    assert not os.path.exists(outs[1])  # rank 1 opened os.devnull
