"""merpcr_tpu_torch — the merPCR-TPU e-PCR engine on PyTorch and CUDA.

A port of the JAX package ``merpcr_tpu`` to an NVIDIA Hopper GPU: the same
``MerPCR`` API, CLI flags and output bytes, with the device work written as
hand-made CUDA kernels (``csrc/``) that each keep a plain PyTorch version
beside them. It imports neither JAX nor ``merpcr_tpu``.

Public API mirrors the reference's ``src/merpcr/__init__.py:7-14``:
``MerPCR``, ``STSRecord``, ``FASTARecord``, ``STSHit``.
"""

__version__ = "1.4.0"

from .engine import MerPCR  # noqa: E402
from .models import FASTARecord, STSHit, STSRecord  # noqa: E402

__all__ = ["MerPCR", "STSRecord", "FASTARecord", "STSHit", "__version__"]
