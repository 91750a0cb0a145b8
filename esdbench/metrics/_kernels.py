"""A kernel's share of its memory roofline in the profiled slice."""
import sys

from esdbench.peaks import HBM_BYTES_PER_S


def roofline(sl, name, call_bytes):
    """``call_bytes``: the bytes of each call the slice issued; None
    when the profile holds no such kernel or another number of them."""
    times = [(e - s) * 1e-6 for k, s, e in sl.kernels if name in k]
    if not times:
        return None
    if len(times) != len(call_bytes):
        print(f"[esdbench] {name}: {len(times)} kernels profiled for "
              f"{len(call_bytes)} calls; no roofline", file=sys.stderr)
        return None
    return 100.0 * sum(call_bytes) / HBM_BYTES_PER_S / sum(times)
