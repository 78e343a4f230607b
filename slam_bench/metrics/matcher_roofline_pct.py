"""`matcher_roofline_pct`: the gated top-2 Hamming matcher's share of its
roofline in the profiled sub-window: the sum of each launch's least time
(`roofline.matcher_bound_ms`, from that launch's own keypoint and candidate
counts) over the sum of the device times of the matcher's kernels, in
percent. Nothing to read where the sub-window has no launch or no kernel
time."""

from slam_bench.roofline import matcher_bound_ms
from slam_bench.trace import MATCHER_KERNEL


def read(rec: dict):
    kernel_s = sum(b - a for name, a, b in rec["device_ops"]
                   if MATCHER_KERNEL.search(name))
    if not rec["matcher"] or kernel_s <= 0:
        return None
    bound_ms = sum(matcher_bound_ms(*launch) for launch in rec["matcher"])
    return 100.0 * bound_ms / (kernel_s * 1e3)
