"""`loop_detect_ms`: loop closing's work per keyframe inserted in the
window: the program's two top-level spans `loop.resolve_gba` and
`loop.process` summed (the `loop.*` stages inside `loop.process` are part
of it), over the keyframes. Nothing to read in a window with no
keyframe."""


def read(rec: dict):
    if not rec["keyframes"]:
        return None
    total = sum(rec["spans"].get(name, {}).get("total_ms", 0.0)
                for name in ("loop.resolve_gba", "loop.process"))
    return total / rec["keyframes"]
