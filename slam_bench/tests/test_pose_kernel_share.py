"""The reader of `pose_kernel_share` on the CPU: on a recorded summary it
counts only the kernel spans inside the tracking step's `track.pose_opt`,
and it is left out (None, never 0) where there is nothing to read.

    python -m pytest slam_bench/tests -q"""

from __future__ import annotations

import json
import os

from slam_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _span(count: int, parents: dict | None = None) -> dict:
    out = {"count": count, "total_ms": 0.1 * count, "mean_ms": 0.1,
           "p50_ms": 0.1, "p95_ms": 0.1, "self_ms": 0.1 * count, "syncs": 0,
           "parent": max(parents, key=parents.get) if parents else None}
    if parents is not None:
        out["parents"] = parents
    return out


def _records(kernel_parents: dict | None) -> dict:
    """Two tracked frames (four solves of the step); the kernel's spans
    under the parents given, none where None."""
    spans = {"track.dispatch": _span(2, {"track.call": 2}),
             "track.pose_opt": _span(4, {"track.dispatch": 4})}
    if kernel_parents is not None:
        spans["pose_opt.kernel"] = _span(sum(kernel_parents.values()),
                                         kernel_parents)
    return {"spans": spans, "call_ms": [100.0, 100.0], "frames": 2,
            "frames_window_s": 0.2, "keyframes": 0, "matcher": [],
            "device_ops": [], "window_s": 0.2}


def test_pose_kernel_share_counts_the_tracking_steps_solves():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    m = next(m for m in spec["per_layer"] if m["name"] == "pose_kernel_share")
    assert (m["source"], m["moves"], m["workloads"], m["layer"]) == (
        "program_span", "setup_s", ["tum3_slam.corridor"], "per frame")
    read = run.reader("pose_kernel_share")
    assert read(_records({"track.pose_opt": 4})) == 1.0
    # relocalization's and loop refinement's launches are not the step's
    assert read(_records({"track.pose_opt": 4, "track.resolve": 3})) == 1.0
    assert read(_records({"track.pose_opt": 1})) == 0.25
    assert read(_records({"track.resolve": 2})) == 0.0


def test_pose_kernel_share_with_nothing_to_read():
    read = run.reader("pose_kernel_share")
    # a program whose solves have no kernel span (the plain body)
    assert read(_records(None)) is None
    # a profiler that does not count records by parent
    rec = _records({"track.pose_opt": 4})
    del rec["spans"]["pose_opt.kernel"]["parents"]
    assert read(rec) is None
    # no solve in the window, or no spans at all
    rec = _records({"track.pose_opt": 4})
    del rec["spans"]["track.pose_opt"]
    assert read(rec) is None
    rec = _records({"track.pose_opt": 4})
    rec["spans"]["track.pose_opt"]["count"] = 0
    assert read(rec) is None
    assert read(dict(_records(None), spans={})) is None
