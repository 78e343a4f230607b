"""`local_mapping_ms`: the keyframe half of a call per keyframe inserted in
the window: the program's `kf.*` spans (insertion, map culling,
triangulation, fusion, local BA, keyframe culling, readback) summed, over
the keyframes. Nothing to read in a window with no keyframe."""


def read(rec: dict):
    if not rec["keyframes"]:
        return None
    total = sum(s["total_ms"] for name, s in rec["spans"].items()
                if name.startswith("kf."))
    return total / rec["keyframes"]
