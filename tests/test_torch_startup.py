"""The port's start-up without PyTorch, as the JAX package starts without
jax: importing the package or its CLI, and a small run on the host fast
path, load no torch; the first device-path use loads it, also in the
middle of a search whose record falls back to the kernels; the card is
found through the CUDA driver (``engine.cuda_device_count``), and
``MERPCR_TPU_PLATFORM`` picks the device.

Fresh processes (``subprocess``) report the frameworks left in
``sys.modules`` at exit. ``MERPCR_TPU_HOST_MAX`` and ``MERPCR_TPU_PLATFORM``
are unset in them unless a test sets them. Every output is compared byte
for byte (tolerance 0), against the golden line or ``merpcr_tpu`` on its
device path (``MERPCR_TPU_HOST_MAX=0``).
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest
import torch

pytest.importorskip("jax")

from merpcr_tpu import MerPCR as JaxMerPCR  # noqa: E402
from merpcr_tpu_torch import MerPCR, cli, cuda_driver, engine  # noqa: E402
from merpcr_tpu_torch.models import FASTARecord  # noqa: E402
from merpcr_tpu_torch.ops import host_scan  # noqa: E402

from .conftest import GOLDEN_FA, GOLDEN_LINE, GOLDEN_STS, run_search  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "merpcr_tpu_torch")
FRAMEWORKS = ("torch", "jax", "jaxlib", "merpcr_tpu")

# appended to every child's code: the frameworks it loaded, as its last line
LOADED = f"""
import json as _json, sys as _sys
print(_json.dumps(sorted({{m.split(".")[0] for m in _sys.modules}} & {set(FRAMEWORKS)!r})))
"""

# ``python -m merpcr_tpu_torch`` through runpy (what ``-m`` runs), so that the
# process can report its modules after the CLI has exited
MODULE_CLI = f"""
import runpy, sys
sys.argv = ["merpcr_tpu_torch", {GOLDEN_STS!r}, {GOLDEN_FA!r}]
try:
    runpy.run_module("merpcr_tpu_torch", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code in (0, None), e.code
"""


def _child(code: str, **env_set) -> tuple:
    """(stdout before the last line, frameworks loaded) of ``code`` run in a
    fresh interpreter from the repository root, with ``env_set`` added to
    an environment without the gate and the platform override."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("MERPCR_TPU_HOST_MAX", "MERPCR_TPU_PLATFORM")}
    env.update(env_set, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code + LOADED], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-3000:]
    body, _, last = r.stdout.rstrip("\n").rpartition("\n")
    return (body + "\n" if body else ""), json.loads(last)


def _jax_device_path(monkeypatch, records) -> str:
    """``merpcr_tpu``'s bytes on its device path for the golden STS file."""
    monkeypatch.setenv("MERPCR_TPU_HOST_MAX", "0")
    eng = JaxMerPCR()
    assert eng.load_sts_file(GOLDEN_STS)
    from merpcr_tpu.models import FASTARecord as JaxRecord

    return run_search(eng, [JaxRecord(defline=r.defline, sequence=r.sequence)
                            for r in records])


@pytest.fixture(scope="module")
def golden_jax_device_path() -> str:
    old = os.environ.get("MERPCR_TPU_HOST_MAX")
    mp = pytest.MonkeyPatch()
    try:
        recs = MerPCR(device="cpu").load_fasta_file(GOLDEN_FA)
        out = _jax_device_path(mp, recs)
    finally:
        mp.undo()
    assert os.environ.get("MERPCR_TPU_HOST_MAX") == old
    assert out == GOLDEN_LINE + "\n"
    return out


# ------------------------------------------------------ no torch at import
@pytest.mark.parametrize("module", ["merpcr_tpu_torch", "merpcr_tpu_torch.cli"])
def test_import_loads_no_framework(module):
    out, loaded = _child(f"import {module}\n")
    assert (out, loaded) == ("", [])


# ------------------------------------------- golden runs on the host path
@pytest.mark.parametrize("package, framework", [("merpcr_tpu_torch", "torch"),
                                                ("merpcr_tpu", "jax")])
def test_golden_api_on_the_host_path_loads_no_framework(package, framework):
    """The port's golden API run (``device="cpu"``) on the default gate
    prints the golden line without loading torch; the JAX package's same
    run, the behaviour being ported, prints the same bytes without jax."""
    kw = 'device="cpu"' if package == "merpcr_tpu_torch" else ""
    code = f"""
from {package} import MerPCR
eng = MerPCR({kw})
assert eng.load_sts_file({GOLDEN_STS!r})
eng.search(eng.load_fasta_file({GOLDEN_FA!r}))
"""
    if package == "merpcr_tpu_torch":
        code += "assert eng._tables == {} and eng.last_scans == []\n"
    out, loaded = _child(code)
    assert out == GOLDEN_LINE + "\n"
    assert framework not in loaded and "torch" not in loaded and "jax" not in loaded
    assert loaded == ([] if package == "merpcr_tpu_torch" else ["merpcr_tpu"])


def test_golden_cli_main_loads_no_torch():
    out, loaded = _child(f"""
import sys
from merpcr_tpu_torch import cli
assert cli.main([{GOLDEN_STS!r}, {GOLDEN_FA!r}], device="cpu") == 0
""")
    assert (out, loaded) == (GOLDEN_LINE + "\n", [])


def test_module_entry_point_on_the_cpu_platform_loads_no_torch():
    out, loaded = _child(MODULE_CLI, MERPCR_TPU_PLATFORM="cpu")
    assert (out, loaded) == (GOLDEN_LINE + "\n", [])


# ------------------------------------------ torch at the first device use
def test_device_path_imports_torch_with_the_jax_bytes(golden_jax_device_path):
    """``MERPCR_TPU_PLATFORM=cpu python -m merpcr_tpu_torch`` at
    ``MERPCR_TPU_HOST_MAX=0``: the plain kernel versions run, so torch is
    loaded, and the bytes are the JAX package's device path's."""
    out, loaded = _child(MODULE_CLI, MERPCR_TPU_PLATFORM="cpu", MERPCR_TPU_HOST_MAX="0")
    assert out == golden_jax_device_path and loaded == ["torch"]


def test_forced_fallback_imports_torch_mid_search(golden_jax_device_path):
    """With the host path's candidate cap lowered to 0 (a test hook), the
    golden record leaves the host path: torch is loaded at that record,
    not before, and the bytes are the device path's."""
    out, loaded = _child(f"""
import sys
from merpcr_tpu_torch import MerPCR
from merpcr_tpu_torch.ops import host_scan
host_scan.MAX_CANDIDATES = 0
eng = MerPCR(device="cpu")
assert eng.load_sts_file({GOLDEN_STS!r})
recs = eng.load_fasta_file({GOLDEN_FA!r})
assert "torch" not in sys.modules
eng.search(recs)
assert "torch" in sys.modules
assert [(s.records, s.cfg.strict) for s in eng.last_scans] == [(1, True)], eng.last_scans
""")
    assert out == golden_jax_device_path and loaded == ["torch"]


def _candidates(eng, rec, monkeypatch) -> int:
    """The host path's candidate count of ``rec``: the least
    ``MAX_CANDIDATES`` that keeps it on the host path."""
    from merpcr_tpu_torch.io.fasta import record_seq_bytes

    def on_host(cap: int) -> bool:
        monkeypatch.setattr(host_scan, "MAX_CANDIDATES", cap)
        return host_scan.host_scan_record(eng._table_host, eng._meta, record_seq_bytes(rec),
                                          eng.margin, eng.mismatches,
                                          eng.three_prime_match) is not None

    lo, hi = 0, 1 << 22
    assert on_host(hi)
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if on_host(mid) else (mid + 1, hi)
    monkeypatch.undo()
    return lo


def test_second_record_falls_back_in_fasta_order(tmp_path, monkeypatch):
    """Three records cut from the golden one: a slice holding the golden
    amplicon, two such slices end to end, another slice. With the candidate
    cap at the slices' count, only the middle record leaves the host path
    (one plane, torch loaded at it); the lines come in FASTA order, equal
    to the JAX package's device path on the same corpus."""
    seq = MerPCR(device="cpu").load_fasta_file(GOLDEN_FA)[0].sequence
    first, last = seq[75_000:77_000], seq[74_000:78_000]
    recs = [FASTARecord(defline=">first slice", sequence=first),
            FASTARecord(defline=">pair of slices", sequence=first + last),
            FASTARecord(defline=">last slice", sequence=last)]
    fa = tmp_path / "three.fa"
    fa.write_text("".join(f"{r.defline}\n{r.sequence}\n" for r in recs))
    eng = MerPCR(device="cpu")
    assert eng.load_sts_file(GOLDEN_STS)
    caps = [_candidates(eng, r, monkeypatch) for r in recs]
    cap = max(caps[0], caps[2])
    assert caps[1] > cap > 0, caps
    out, loaded = _child(f"""
import sys
from merpcr_tpu_torch import MerPCR
from merpcr_tpu_torch.ops import host_scan
host_scan.MAX_CANDIDATES = {cap}
eng = MerPCR(device="cpu")
assert eng.load_sts_file({GOLDEN_STS!r})
recs = eng.load_fasta_file({str(fa)!r})
assert "torch" not in sys.modules
eng.search(recs)
assert [s.records for s in eng.last_scans] == [1], eng.last_scans
""")
    assert loaded == ["torch"]
    want = _jax_device_path(monkeypatch, recs)
    assert out == want
    assert [ln.split("\t")[0] for ln in out.splitlines()] == ["first", "pair", "pair", "last"]


# ---------------------------------------------------- the card check
class FakeDriver:
    """Stands for ``libcuda.so.1``: ``cuInit`` returns ``init_rc``,
    ``cuDeviceGetCount`` writes ``count`` and returns ``count_rc``."""

    def __init__(self, init_rc: int = 0, count: int = 1, count_rc: int = 0):
        self.init_rc, self.count, self.count_rc = init_rc, count, count_rc

    def cuInit(self, flags):
        assert flags == 0
        return self.init_rc

    def cuDeviceGetCount(self, ref):
        ref._obj.value = self.count
        return self.count_rc


def _driver(monkeypatch, driver) -> None:
    """The card check over ``driver`` (None: no driver library): the check's
    own code (``cuda_driver.report``, which the engine runs in a child
    process) run here, over the fake library."""
    def load():
        if driver is None:
            raise OSError("libcuda.so.1: cannot open shared object file")
        return driver

    monkeypatch.setattr(cuda_driver, "load", load)
    monkeypatch.setattr(engine, "_driver_report", cuda_driver.report)


@pytest.mark.parametrize("driver", [None, FakeDriver(init_rc=100), FakeDriver(count_rc=3),
                                    FakeDriver(count=0)],
                         ids=["no_library", "cuinit_error", "count_error", "no_device"])
def test_card_check_without_a_card_raises(monkeypatch, driver):
    monkeypatch.delenv("MERPCR_TPU_PLATFORM", raising=False)
    _driver(monkeypatch, driver)
    for ask in (None, "cuda", "cuda:0", torch.device("cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            engine.resolve_device(ask)
    with pytest.raises(RuntimeError, match="CUDA"):
        MerPCR()
    assert engine.resolve_device("cpu") == "cpu"


def test_card_check_admits_the_indices_the_driver_sees(monkeypatch):
    monkeypatch.delenv("MERPCR_TPU_PLATFORM", raising=False)
    _driver(monkeypatch, FakeDriver(count=2))
    assert engine.cuda_device_count() == 2
    assert engine.resolve_device(None) == "cuda"
    assert engine.resolve_device("cuda:1") == "cuda:1"
    assert engine.resolve_device(1) == "cuda:1"
    dev = torch.device("cuda", 1)
    assert engine.resolve_device(dev) is dev  # a torch.device is taken as it is
    checked = engine.resolve_device("cuda:1")
    _driver(monkeypatch, None)
    assert engine.resolve_device(checked) == "cuda:1"  # checked once: not asked again
    _driver(monkeypatch, FakeDriver(count=2))
    for ask in ("cuda:2", 2, torch.device("cuda", 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            engine.resolve_device(ask)
    for ask in ("mps", "cuda:x", "tpu:0"):
        with pytest.raises(ValueError, match="unsupported device"):
            engine.resolve_device(ask)


def test_real_card_check_agrees_with_torch():
    """The check in its child process (``cuda_driver.py`` run as a script,
    without the package) against torch on this machine."""
    r = subprocess.run([sys.executable, "-S", cuda_driver.__file__], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0 and r.stderr == "", r.stderr
    line = r.stdout.strip()
    try:
        count = engine.cuda_device_count()
    except RuntimeError as e:
        assert "no CUDA device is available" in str(e)
        assert line.startswith("error: ") and line[len("error: "):] in str(e)
        count = 0
    else:
        assert line == str(count)
    assert count == (torch.cuda.device_count() if torch.cuda.is_available() else 0)


# ------------------------------------------------ MERPCR_TPU_PLATFORM
def test_platform_cpu_gives_a_cpu_engine(monkeypatch, capsys):
    monkeypatch.setenv("MERPCR_TPU_PLATFORM", "cpu")
    _driver(monkeypatch, None)  # the driver is never asked
    assert MerPCR().device == torch.device("cpu")
    monkeypatch.delenv("MERPCR_TPU_HOST_MAX", raising=False)
    assert cli.main([GOLDEN_STS, GOLDEN_FA]) == 0
    assert capsys.readouterr().out == GOLDEN_LINE + "\n"


@pytest.mark.parametrize("platform", ["cuda", "gpu"])
def test_platform_card_needs_a_card(monkeypatch, platform):
    monkeypatch.setenv("MERPCR_TPU_PLATFORM", platform)
    _driver(monkeypatch, FakeDriver(count=0))
    with pytest.raises(RuntimeError, match="CUDA"):
        MerPCR()
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main([GOLDEN_STS, GOLDEN_FA])
    _driver(monkeypatch, FakeDriver(count=1))
    assert engine.resolve_device() == "cuda"


@pytest.mark.parametrize("platform", ["tpu", "CPU", "cpu,cuda"])
def test_platform_other_values_are_refused(monkeypatch, platform):
    monkeypatch.setenv("MERPCR_TPU_PLATFORM", platform)
    with pytest.raises(ValueError, match="'cpu', 'cuda', 'gpu'"):
        MerPCR()
    with pytest.raises(ValueError, match="MERPCR_TPU_PLATFORM"):
        cli.main([GOLDEN_STS, GOLDEN_FA])


def test_explicit_device_beats_the_platform(monkeypatch):
    monkeypatch.setenv("MERPCR_TPU_PLATFORM", "cuda")
    _driver(monkeypatch, None)
    assert MerPCR(device="cpu").device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        MerPCR()


# ------------------------------------------------ no torch at module level
HOST_MODULES = ("__init__", "__main__", "cli", "cuda_driver", "engine", "io/__init__",
                "io/fasta", "io/sts", "models/__init__", "native/__init__", "ops/__init__",
                "ops/encoding", "ops/host_scan", "ops/table", "trace")


def _module_name(rel: str) -> str:
    parts = rel.split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(["merpcr_tpu_torch", *parts])


def _top_level_imports(tree: ast.Module, name: str, is_pkg: bool):
    """Every module imported by a statement that runs when the module is
    imported (its body, and ``if``/``try`` blocks there, apart from ``if
    TYPE_CHECKING:``), as absolute names."""
    package = name if is_pkg else name.rpartition(".")[0]
    todo = list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, ast.If):
            if not (isinstance(node.test, ast.Name) and node.test.id == "TYPE_CHECKING"):
                todo += node.body + node.orelse
        elif isinstance(node, ast.Try):
            todo += node.body + node.orelse + node.finalbody
            for h in node.handlers:
                todo += h.body
        elif isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                anchor = package.split(".")[: len(package.split(".")) - node.level + 1]
                base = ".".join(anchor + ([base] if base else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


@pytest.mark.parametrize("rel", HOST_MODULES)
def test_host_side_module_imports_no_torch_at_module_level(rel):
    """The modules a host-path run loads import, when they are imported,
    only the standard library, NumPy and each other: never torch, nor a
    module of the device side (``ops.scan``, ``ops.units``, ``parallel``,
    the kernel wrappers)."""
    allowed = {_module_name(m) for m in HOST_MODULES}
    with open(os.path.join(PKG, rel + ".py")) as fh:
        tree = ast.parse(fh.read())
    name = _module_name(rel)
    for mod in _top_level_imports(tree, name, rel.endswith("__init__")):
        assert mod.split(".")[0] not in ("torch", "triton", "jax", "merpcr_tpu"), (rel, mod)
        if mod.startswith("merpcr_tpu_torch"):
            as_module = os.path.exists(os.path.join(REPO, *mod.split(".")) + ".py") or \
                os.path.isdir(os.path.join(REPO, *mod.split(".")))
            assert not as_module or mod in allowed, (rel, mod)
