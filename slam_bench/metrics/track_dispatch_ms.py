"""`track_dispatch_ms`: the host's time to enqueue one frame's front-end and
tracking (`extract_and_track`), from the program's `track.dispatch` span:
its total over the window divided by its count."""


def read(rec: dict):
    s = rec["spans"].get("track.dispatch")
    if not s or not s["count"]:
        return None
    return s["total_ms"] / s["count"]
