"""`detect_syncs_per_frame`: the times the host waited for the device in the
detector's spans per frame: the `syncs` of `detect.launch` and
`detect.resolve` (a resolve counts one where the frame before's network was
not done yet) summed, over the count of `track.call` spans in the window.
Nothing to read where the program has no `detect.launch` span, no
`track.call`, or counts no syncs."""


def read(rec: dict):
    spans = rec["spans"]
    calls = spans.get("track.call", {}).get("count")
    own = [spans[name] for name in ("detect.launch", "detect.resolve")
           if name in spans]
    if (not calls or "detect.launch" not in spans
            or any("syncs" not in s for s in own)):
        return None
    return sum(s["syncs"] for s in own) / calls
