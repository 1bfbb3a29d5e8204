"""The CUDA cards the CUDA driver sees, through its API with ctypes
(``libcuda.so.1``: ``cuInit``, ``cuDeviceGetCount``), without torch: the
engine's card check (``engine.cuda_device_count``).

Run as a script (``python -S cuda_driver.py``), it prints the count, or
``error: <why>``. The engine runs it so, in a child process: a driver
initialised in the engine's own process before torch loads its CUDA
libraries made runs that then started ``torch.profiler`` abort at exit
(heap corruption in teardown, on an H100), where a driver that torch
initialises itself does not; the child leaves the engine's process to
torch. The driver honours ``CUDA_VISIBLE_DEVICES``, which the child
inherits, as ``torch.cuda`` does. This file imports only the standard
library, so the child starts in milliseconds.
"""

import ctypes


class DriverError(Exception):
    """A driver call failed."""


def load():
    """The driver library with the signatures ``device_count`` calls
    (raises OSError where there is no driver)."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuInit.argtypes = [ctypes.c_uint]
    lib.cuInit.restype = ctypes.c_int
    lib.cuDeviceGetCount.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.cuDeviceGetCount.restype = ctypes.c_int
    return lib


def device_count(lib) -> int:
    """``cuInit(0)``, then ``cuDeviceGetCount`` on a loaded driver."""
    rc = lib.cuInit(0)
    if rc != 0:
        raise DriverError(f"cuInit returned CUDA error {rc}")
    n = ctypes.c_int(0)
    rc = lib.cuDeviceGetCount(ctypes.byref(n))
    if rc != 0:
        raise DriverError(f"cuDeviceGetCount returned CUDA error {rc}")
    return n.value


def report() -> str:
    """The script's line: the count, or ``error: <why>``."""
    try:
        return str(device_count(load()))
    except OSError as e:
        return f"error: no CUDA driver: {e}"
    except DriverError as e:
        return f"error: {e}"


if __name__ == "__main__":
    print(report())
