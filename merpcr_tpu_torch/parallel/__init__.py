"""Several devices and processes: the mesh-sharded tile scan with its
gather (K15; the counterpart of ``merpcr_tpu.parallel``)."""

from .distributed import global_mesh, initialize, is_output_host
from .sharded import make_mesh, sharded_scan_record

__all__ = [
    "make_mesh",
    "sharded_scan_record",
    "initialize",
    "global_mesh",
    "is_output_host",
]
