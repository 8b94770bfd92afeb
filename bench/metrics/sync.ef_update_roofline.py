"""The EF pass's share of its roofline, %: the least time the profiled
steps' EF work needs at the HBM's peak (``bench.yardstick.ef_bytes``:
16 B an element of an exchanged bucket, 12 B of any other) over the device
time of the ``ef_update`` kernels in those steps."""
from bench.yardstick.peaks import HBM_BYTES_PER_S


def read(view):
    us = view.group_us().get("ef_update")
    if not us:
        return None
    bound_s = sum(s["ef_bytes"] for s in view.steps) / HBM_BYTES_PER_S
    return 100.0 * bound_s / (us / 1e6)
