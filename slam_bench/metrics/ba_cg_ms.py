"""`ba_cg_ms`: the conjugate-gradient solves of bundle adjustment per
keyframe inserted in the window: the program's `ba.cg` total (one span per
Gauss-Newton step, inside `kf.local_ba`) over the keyframes. Nothing to read
in a window with no keyframe, or where the program has no such span."""


def read(rec: dict):
    cg = rec["spans"].get("ba.cg")
    if not rec["keyframes"] or not cg:
        return None
    return cg["total_ms"] / rec["keyframes"]
