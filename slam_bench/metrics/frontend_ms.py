"""`frontend_ms`: the front-end's host time per dispatched frame: the
program's `frame.*` spans (ingest, ORB with depth sampling and
backprojection, normals, planes, lines, cylinders) summed, over the count of
`track.dispatch`. A frame extracted outside a dispatch (initialization,
relocalization) adds its `frame.*` time too. Nothing to read where the
program has no such spans."""


def read(rec: dict):
    spans = rec["spans"]
    n = spans.get("track.dispatch", {}).get("count")
    front = [s["total_ms"] for name, s in spans.items()
             if name.startswith("frame.")]
    if not n or not front:
        return None
    return sum(front) / n
