"""Host-side I/O: FASTA and STS loaders."""

from .fasta import FASTALoader
from .sts import STSLoader, STSLoadResult

__all__ = ["FASTALoader", "STSLoader", "STSLoadResult"]
