"""`tracker_own_ms`: the self time of the tracker and the system per frame,
all on the program's clock: the root span `track.call` (the whole
`System.track_rgbd`) less the top-level spans inside it that other metrics
read, those `tracker_self_ms` takes off, over the window's frames. The
subtraction of `tracker_self_ms`, which starts from the harness's wall time
instead; the two differ by the harness's pose readback. Nothing to read
where the program has no `track.call` span."""

from slam_bench.metrics.tracker_self_ms import TOP_LEVEL


def read(rec: dict):
    call = rec["spans"].get("track.call")
    if not rec["frames"] or not call:
        return None
    inside = sum(s["total_ms"] for name, s in rec["spans"].items()
                 if name in TOP_LEVEL or name.startswith("kf."))
    return (call["total_ms"] - inside) / rec["frames"]
