#!/usr/bin/env python
"""What the tracked pose's projection onto SO(3) costs the port's
pipelined tracking loop (`chip_smoke.py` phase 3's loop).

`slam/track_step.py` projects the rotation of each tracked pose onto SO(3)
(`se3.orthonormalize_rotation`, six Newton steps on a 3x3 matrix). This
script times `_smoke.pipelined` over the smoke fixture's frames at 640x480
(tum_freiburg3, the frames enqueued back to back and one synchronise at
the end) with the projection and without it, alternating the two in one
process as projected, plain, plain, projected for each round. Without it
means the rotation is passed through unchanged: the pose is still rebuilt
by `se3.make_T`.

    python scripts/bench_pose_projection_torch.py [--frames 16] [--rounds 2]
        [--device cpu]

Runs on cuda, and raises without a GPU unless --device cpu is passed.
Prints the card's name and power limit, then one JSON line: frames/s of
each timed window by variant, and their medians."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import types

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@contextlib.contextmanager
def without_projection():
    """track_step's `se3` for the block, with `orthonormalize_rotation`
    passing its matrix through."""
    from dr_slam_torch.slam import track_step

    se3 = track_step.se3
    track_step.se3 = types.SimpleNamespace(
        **{**vars(se3), "orthonormalize_rotation": lambda M: M})
    try:
        yield
    finally:
        track_step.se3 = se3


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=16,
                    help="frames per timed window")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from dr_slam_torch import resolve_device
    from dr_slam_torch._smoke import (card_line, load_fixture, pipelined,
                                      register_shipped_codebooks)
    from dr_slam_torch.config import tum_freiburg3

    dev = resolve_device(args.device)
    register_shipped_codebooks()
    cfg = tum_freiburg3()
    fx = load_fixture(dev)

    def window() -> float:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = pipelined(fx, args.frames, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        assert bool(torch.isfinite(out.T_cw).all())
        return args.frames / (time.perf_counter() - t0)

    pipelined(fx, 2, cfg)               # warm both variants' first calls
    with without_projection():
        pipelined(fx, 2, cfg)
    fps = {"projected": [], "plain": []}
    for _ in range(args.rounds):
        fps["projected"].append(window())
        with without_projection():
            fps["plain"].append(window())
            fps["plain"].append(window())
        fps["projected"].append(window())
    line = {"frames_per_window": args.frames, "fps": fps,
            "median_fps": {k: float(np.median(v)) for k, v in fps.items()}}
    print(card_line() if dev.type == "cuda" else "cpu")
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
