"""`detect_per_frame`: the detector's launches per frame: the count of
`detect.launch` spans over the count of `track.call` spans in the window.
An engagement flag: 1.0 where every frame is detected, as upstream's
default build does. Nothing to read where the program has no
`detect.launch` span or no `track.call`."""


def read(rec: dict):
    spans = rec["spans"]
    calls = spans.get("track.call", {}).get("count")
    if not calls or "detect.launch" not in spans:
        return None
    return spans["detect.launch"]["count"] / calls
