"""Stateless utility functions (API parity with reference core/utils.py).

The reference duplicates these helpers between ``engine.py`` and
``utils.py`` (SURVEY.md §2.1 component 14); here there is ONE implementation,
backed by the byte LUTs in ``merpcr_tpu_torch.ops.encoding``.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..ops.encoding import (
    AMBIG,
    IUPAC_MAPPING,
    encode_bytes,
    hash_value_bytes,
    reverse_complement_bytes,
)

__all__ = ["AMBIG", "reverse_complement", "hash_value", "init_iupac_tables"]


def reverse_complement(sequence: str) -> str:
    """Reverse complement, case-preserving, unknown -> 'N'
    (reference utils.py:43-45)."""
    return reverse_complement_bytes(encode_bytes(sequence)).tobytes().decode("latin-1")


def hash_value(primer: str, wordsize: int) -> Tuple[int, int]:
    """(offset, hash) of the first ambiguity-free W-mer
    (reference utils.py:48-82)."""
    return hash_value_bytes(encode_bytes(primer), wordsize)


def init_iupac_tables(iupac_mode: bool = False) -> Dict:
    """Reference utils.py:85-113."""
    if not iupac_mode:
        return {}
    return dict(IUPAC_MAPPING)
