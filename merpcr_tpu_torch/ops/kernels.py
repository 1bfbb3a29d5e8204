"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for Hopper (``sm_90a``) into a shared
library with a plain C interface, loaded through ``ctypes``: pointers and
the CUDA stream travel as ``c_void_p``, and every C entry returns
``cudaGetLastError()`` so a refused launch raises here instead of passing
silently. Libraries land in the package's ``_build/`` directory under a
name that carries a digest of the sources and flags, so a changed source
rebuilds and an unchanged one is built once per checkout. Building happens
on first use, never at import: machines without ``nvcc`` (the CPU test
machines) import this module freely. A failed build raises; nothing falls
back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
SOURCES = ("front_end", "expand", "verify_p1", "margin_p2")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_LOCK = threading.Lock()
_FUNCS: dict = {}


def nvcc() -> str:
    """Path of the CUDA compiler: $CUDA_HOME/bin, /usr/local/cuda/bin, PATH."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def lib_path(name: str) -> str:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as fh:
                h.update(fn.encode() + fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build(names=SOURCES) -> dict:
    """Compile every library of ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns {name: compiler
    output} for the sources compiled by this call (``-Xptxas -v`` prints
    each kernel's registers and shared memory). Raises RuntimeError if any
    compile fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    try:
        for name in names:
            out = lib_path(name)
            if os.path.exists(out):
                continue
            tmp = f"{out}.{os.getpid()}.tmp"
            cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{name}.cu")]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            jobs[name] = (proc, tmp, out)
        logs, failed = {}, []
        for name, (proc, tmp, out) in jobs.items():
            logs[name], _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(name)
            else:
                # rename into place: a concurrent process never loads a
                # half-written library
                os.replace(tmp, out)
    finally:
        for proc, tmp, _out in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    if failed:
        raise RuntimeError(
            "CUDA kernel build failed:\n"
            + "\n".join(f"[{n}]\n{logs[n]}" for n in failed)
        )
    return logs


def function(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of library ``name``, typed, returning int.

    The first call builds every kernel library that is missing (one
    parallel nvcc round), then loads ``name``."""
    key = (name, symbol)
    with _LOCK:
        fn = _FUNCS.get(key)
        if fn is None:
            build()
            lib = ctypes.CDLL(lib_path(name))
            lib.mp_error_string.restype = ctypes.c_char_p
            lib.mp_error_string.argtypes = [ctypes.c_int]
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
            fn.error_string = lib.mp_error_string
            _FUNCS[key] = fn
    return fn


def call(fn, *args) -> None:
    """Run a C entry; raise if it reports a CUDA error."""
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(
            f"CUDA error {rc} in {fn.__name__}: {fn.error_string(rc).decode()}"
        )


def stream(t: torch.Tensor) -> int:
    """Raw handle of the current CUDA stream of ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(t: torch.Tensor):
    """Context that makes ``t``'s CUDA device current. A ctypes launch runs
    in the current device's context, whatever stream it is given: without
    this a tile on ``cuda:1`` would be launched against ``cuda:0``."""
    return torch.cuda.device(t.device)


class ScanState:
    """The single-pass scans' state on one device (``csrc/compact.cuh``
    ``ScanState``), kept across calls: ``ticket`` int32[3] (the tile
    ticket, and a sum collected in any order, which every launch puts back
    to 0; then the latest front end's flag count, which ``expand``
    clears), ``status`` int64[capacity] (one tagged word per tile;
    a launch's tag is its sequence number, so stale words never match and
    no call has to clear them), and ``host`` int32[4] of pinned host memory
    that a kernel writes its totals into, so the wrapper's one host read is
    a stream synchronise and no copy: words 0-1 the call's own totals
    (``expand``, ``verify_p1``, ``margin_p2``), word 2 the front
    end's c_total, which ``expand`` writes with its totals in one
    16-byte store (a pinned allocation is page-aligned).
    ``ticket`` and ``status`` are zeroed once, when they are made or
    grown. ``reads`` counts the host's waits on the card: each ``read``,
    and each ``wait`` of the deferred tile scan's collect."""

    SEQ_MAX = (1 << 31) - 1  # a tag has 31 bits (compact.cuh)

    def __init__(self, device: torch.device):
        self.device = device
        self.ticket = torch.zeros(3, dtype=torch.int32, device=device)
        self.status = torch.zeros(1024, dtype=torch.int64, device=device)
        self.host = torch.empty(4, dtype=torch.int32).pin_memory()
        if self.host.data_ptr() % 16:  # expand stores its totals as one int4
            raise RuntimeError("pinned totals are not 16-byte aligned")
        self.seq = 0
        self.reads = 0

    def tag(self, n_tiles: int) -> int:
        """A fresh sequence number for a launch over ``n_tiles`` tiles (the
        status buffer grows to hold them)."""
        if n_tiles > self.status.numel() or self.seq == self.SEQ_MAX:
            size = max(self.status.numel(), 1 << max(n_tiles - 1, 1).bit_length())
            self.status = torch.zeros(size, dtype=torch.int64, device=self.device)
            self.seq = 0
        self.seq += 1
        return self.seq

    def read(self, count: int) -> list:
        """The first ``count`` host words, once the stream's kernels are
        done: the call's one host read."""
        torch.cuda.current_stream(self.device).synchronize()
        self.reads += 1
        return self.host[:count].tolist()

    def wait(self, event) -> None:
        """Wait for ``event``, which follows the deferred scan's copy of
        a plane's totals and rows: the plane's one host read."""
        event.synchronize()
        self.reads += 1


_STATES: dict = {}


def count_launch(wrapper, deferred: bool) -> None:
    """Count one launch of ``wrapper``'s kernel: in ``wrapper.launches``
    for its count-first mode, in ``wrapper.launches_deferred`` for the
    deferred mode of the tile scan (``ops.scan.dispatch_stream``)."""
    if deferred:
        wrapper.launches_deferred += 1
    else:
        wrapper.launches += 1


def scan_state(t: torch.Tensor) -> ScanState:
    """The scan state of ``t``'s CUDA device."""
    with _LOCK:
        st = _STATES.get(t.device)
        if st is None:
            st = _STATES[t.device] = ScanState(t.device)
    return st


P = ctypes.c_void_p
I = ctypes.c_int  # noqa: E741 - C type aliases read like the signatures
LL = ctypes.c_longlong

