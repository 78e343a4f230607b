"""`window_frame_ms_p95`: the 95th percentile (linear) over every frame of
the traced run's window of the time from the `track_rgbd` call until that
frame's pose is on the host, read with the stage profiler on."""

import numpy as np


def read(rec: dict):
    if not rec["call_ms"]:
        return None
    return float(np.percentile(rec["call_ms"], 95))
