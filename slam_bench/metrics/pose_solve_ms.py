"""`pose_solve_ms`: the host time of the tracking step's two
`pose_optimize` solves per dispatched frame: the program's
`track.pose_opt` total over the count of `track.dispatch`. Nothing to read
where the program has no such span."""


def read(rec: dict):
    spans = rec["spans"]
    n = spans.get("track.dispatch", {}).get("count")
    solve = spans.get("track.pose_opt")
    if not n or not solve:
        return None
    return solve["total_ms"] / n
