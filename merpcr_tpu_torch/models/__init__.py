"""Data models.

Parity with the reference's dataclasses (``src/merpcr/core/models.py``):
``STSRecord`` (models.py:18-29), ``FASTARecord`` (models.py:33-49),
``STSHit`` (models.py:53-58), ``SeqType`` (models.py:10-14).

Unlike the reference, the search pipeline itself never touches these
per-record objects on the hot path — the STS set is compiled into
struct-of-arrays device tables (see ``merpcr_tpu_torch.ops.table``) and hits are
produced as flat int32 arrays. These dataclasses are the host-side /
user-facing representation only.
"""

from dataclasses import dataclass, field
from enum import Enum
from typing import List


class SeqType(Enum):
    """Sequence type enumeration (reference models.py:10-14; unused there too,
    kept for API parity)."""

    AMINO_ACID = 1
    NUCLEOTIDE = 2


@dataclass
class STSRecord:
    """One searchable STS record (reference models.py:18-29).

    The loader creates up to two records per STS file line: a forward
    record ('+': primer1/primer2 as written) and a reverse record
    ('-': primer1=primer2-as-written, primer2=revcomp(original primer1)),
    mirroring reference engine.py:253-281.
    """

    id: str
    primer1: str
    primer2: str
    pcr_size: int
    alias: str = ""
    offset: int = 0  # Line number in the original STS file
    hash_offset: int = 0  # Offset of the hash W-mer within primer1
    direct: str = "+"  # '+' forward record, '-' reverse record
    ambig_primer: int = 0  # vestigial; kept for parity (models.py:29)


@dataclass
class FASTARecord:
    """One FASTA sequence record (reference models.py:33-49)."""

    defline: str
    sequence: str
    label: str = ""

    def __post_init__(self):
        # Label = first whitespace-delimited word of the defline, sans '>'
        # (reference models.py:40-49). The reference raises IndexError on an
        # empty defline; we degrade to "" instead.
        if not self.label:
            defline = self.defline.strip()
            if ">" in defline:
                defline = defline[1:]
            words = defline.split()
            self.label = words[0] if words else ""


@dataclass
class STSHit:
    """A single STS hit, 0-based inclusive coordinates (reference models.py:53-58)."""

    pos1: int
    pos2: int
    sts: STSRecord


@dataclass
class ThreadData:
    """Kept for API parity with reference models.py:62-69. The engine
    scans device tiles, not host threads, so this is not used on
    the search path."""

    thread_id: int
    sequence: str
    offset: int
    length: int
    hits: List[STSHit] = field(default_factory=list)
