"""`detect_ms`: the host time the per-frame detector takes inside a frame:
the `detect.launch` spans (the frame's resize, network, decode and
candidates enqueued on the detector's stream) and the `detect.resolve`
spans (the frame before's greedy NMS on the host) summed, over the count of
`track.call` spans in the window. Nothing to read where the program has no
`detect.launch` span (no detector runs per frame) or no `track.call`."""


def read(rec: dict):
    spans = rec["spans"]
    calls = spans.get("track.call", {}).get("count")
    if not calls or "detect.launch" not in spans:
        return None
    return sum(spans[name]["total_ms"] for name in
               ("detect.launch", "detect.resolve") if name in spans) / calls
