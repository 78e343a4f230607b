"""`device_idle_pct`: the share of the profiled sub-window's wall time in
which no operation ran on the card: 1 minus the union of the device
operations' intervals over the sub-window, in percent."""

from slam_bench.trace import union_s


def read(rec: dict):
    if not rec["device_ops"] or rec["window_s"] <= 0:
        return None
    busy = union_s((a, b) for _, a, b in rec["device_ops"])
    return 100.0 * (1.0 - busy / rec["window_s"])
