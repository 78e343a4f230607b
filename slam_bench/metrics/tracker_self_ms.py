"""`tracker_self_ms`: the self time of the tracker and the system per frame:
the harness's wall time of each call in the window (up to the pose on the
host) less the program's top-level spans inside the calls, the enqueue
(`track.dispatch`), the sequential keyframe stages (`kf.*`) and loop
closing's two spans (`loop.resolve_gba`, `loop.process`; the `loop.*`
stages nested in `loop.process` are not taken off again), over the window's
frames. What remains is resolving the deferred frame, the keyframe
decision, relocalization and the host readbacks."""

TOP_LEVEL = ("track.dispatch", "loop.resolve_gba", "loop.process")


def read(rec: dict):
    if not rec["frames"]:
        return None
    inside = sum(s["total_ms"] for name, s in rec["spans"].items()
                 if name in TOP_LEVEL or name.startswith("kf."))
    return (sum(rec["call_ms"]) - inside) / rec["frames"]
