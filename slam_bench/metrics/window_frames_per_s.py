"""`window_frames_per_s`: frames completed in the traced run's window over
the window's seconds (it closes when the last call started in it returns),
read with the stage profiler on. The same quantity as the untraced run's
`frames_per_s` on standard error."""


def read(rec: dict):
    if not rec["frames"] or not rec["frames_window_s"]:
        return None
    return rec["frames"] / rec["frames_window_s"]
