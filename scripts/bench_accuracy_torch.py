#!/usr/bin/env python
"""Closed-loop accuracy protocol of the PyTorch port: the twin of
scripts/bench_accuracy.py, ATE before and after loop closure.

The protocol (`dr_slam_torch._smoke.accuracy_run`): the loop configuration
at 320x240, a circular path of 200 frames and then its first 70 again,
rendered by the port's `io/synthetic`; a codebook trained on the sequence
and registered; `System.track_rgbd` with loop closing on over every frame,
with progressive drift injected right after frame 120; the raw and the
loop-corrected trajectories scored with the evo-equivalent ATE (Umeyama,
fixed scale).

    python scripts/bench_accuracy_torch.py [--device cpu]

Runs on cuda, and raises without a GPU unless --device cpu is passed.
Prints one JSON line, with the JAX script's keys and rounding:
  {"ate_rmse_m": corrected, "ate_rmse_raw_m": raw, "loops_closed": N,
   "frames": N}"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def summary_line(summary: dict) -> dict:
    """`accuracy_run`'s summary as scripts/bench_accuracy.py prints it."""
    return {"ate_rmse_m": round(float(summary["ate_rmse_m"]), 4),
            "ate_rmse_raw_m": round(float(summary["ate_rmse_raw_m"]), 4),
            "loops_closed": int(summary["loops_closed"]),
            "frames": int(summary["frames"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from dr_slam_torch import resolve_device
    from dr_slam_torch._smoke import accuracy_run

    run = accuracy_run(resolve_device(args.device), record=False)
    line = summary_line(run.summary)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
