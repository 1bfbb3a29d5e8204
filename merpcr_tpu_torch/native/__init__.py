"""Native (C++) host codec with transparent NumPy fallback.

The GPU does the scanning; the host still has to stream gigabytes of FASTA
through a byte filter and nibble packer. Those two loops are implemented in
C++ (fasta_codec.cpp), compiled on first use into a shared library and
called through ctypes. Everything works identically — just slower — when a
compiler is unavailable.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fasta_codec.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB: "ctypes.CDLL | None | bool" = None  # None = not tried, False = failed


def _build_lib() -> str | None:
    """Compile fasta_codec.cpp to a shared library (cached in the package's
    build directory when writable, else in a temp dir)."""
    for target_dir in (_BUILD_DIR, tempfile.gettempdir()):
        so_path = os.path.join(target_dir, "libmp_fasta_codec.so")
        if os.path.exists(so_path) and os.path.getmtime(so_path) >= os.path.getmtime(_SRC):
            return so_path
        try:
            os.makedirs(target_dir, exist_ok=True)
            # build under a private name, then rename: concurrent processes
            # never load a half-written library
            tmp = f"{so_path}.{os.getpid()}.tmp"
            cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
            r = subprocess.run(cmd, capture_output=True, timeout=120)
            if r.returncode == 0:
                os.replace(tmp, so_path)
                return so_path
            logger.debug("native codec build failed: %s", r.stderr.decode()[:500])
        except Exception as e:  # pragma: no cover
            logger.debug("native codec build error: %s", e)
    return None


def get_lib():
    global _LIB
    if _LIB is None:
        path = _build_lib()
        if path is None:
            _LIB = False
        else:
            try:
                lib = ctypes.CDLL(path)
                lib.mp_fasta_filter.restype = ctypes.c_int64
                lib.mp_fasta_filter.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p,
                ]
                lib.mp_nibble_pack.restype = ctypes.c_int32
                lib.mp_nibble_pack.argtypes = [
                    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p,
                ]
                _LIB = lib
            except Exception as e:  # pragma: no cover
                logger.debug("native codec load error: %s", e)
                _LIB = False
    return _LIB or None


def fasta_filter(raw: np.ndarray, keep: np.ndarray) -> np.ndarray:
    """Keep bytes where keep[b]; preserves order/case (reference fasta.py:60)."""
    lib = get_lib()
    if lib is not None and raw.size:
        dst = np.empty_like(raw)
        keep8 = keep.astype(np.uint8)
        n = lib.mp_fasta_filter(
            raw.ctypes.data, raw.size, keep8.ctypes.data, dst.ctypes.data
        )
        return dst[:n]
    return raw[keep[raw]]


def nibble_pack(seq: np.ndarray, lut: np.ndarray):
    """(packed | None): NIB codes packed 2/byte; None if out-of-alphabet."""
    n = len(seq)
    src = seq
    if n % 2:
        # pad with 'A' (code 0), matching the NumPy path's zero nibble pad
        src = np.concatenate([seq, np.full(1, ord("A"), dtype=np.uint8)])
        n += 1
    lib = get_lib()
    if lib is not None and n:
        dst = np.empty(n // 2, dtype=np.uint8)
        rc = lib.mp_nibble_pack(src.ctypes.data, n, lut.ctypes.data,
                                dst.ctypes.data)
        return None if rc != 0 else dst
    nib = lut[src]
    if nib.size and nib.max() == 255:
        return None
    return (nib[0::2] | (nib[1::2] << 4)).astype(np.uint8)
