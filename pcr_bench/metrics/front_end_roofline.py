"""Share of the memory roofline of the front ends in the traced searches:
the least time of their bytes, each scanned tile's bases read once
(``roofline.tile_bytes`` with no hit) at ``roofline.HBM_BYTES_PER_S``, over
the device time of the operations whose name starts with ``front_end``
(``front_end_ms``'s), in %. The count is the work, not the kernel: the
strict front end's share where a cell scans strict, the loose one's where
it scans loose."""

from pcr_bench import roofline


def read(run):
    t = run.trace
    if t is None or not run.tiles:
        return None
    s = sum(v for k, v in t.device_ops.items() if k.startswith("front_end"))
    if not s:
        return None
    least = sum(roofline.tile_bytes(packed, n_scan, 0) for packed, n_scan, _h in run.tiles)
    return 100.0 * least / roofline.HBM_BYTES_PER_S / s
