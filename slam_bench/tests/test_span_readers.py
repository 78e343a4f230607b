"""The readers of the per-layer metrics that read the program's spans inside
a frame and inside local bundle adjustment, on the CPU: each on a recorded
summary, and each left out (None, never 0) where there is nothing to read,
as from a program whose profiler has no such span or no sync count.

    python -m pytest slam_bench/tests -q"""

from __future__ import annotations

import json
import os

import pytest

from slam_bench import run

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _span(total_ms: float, count: int = 1, syncs: int = 0) -> dict:
    return {"count": count, "total_ms": total_ms,
            "mean_ms": total_ms / count, "p50_ms": total_ms / count,
            "p95_ms": total_ms / count, "self_ms": total_ms, "syncs": syncs,
            "parent": None}


def _records() -> dict:
    """Two calls, one of which resolves a keyframe with its local BA."""
    spans = {
        "track.call": _span(5090.0, 2), "track.dispatch": _span(900.0, 2),
        "frame.ingest": _span(10.0, 2, syncs=4), "frame.orb": _span(60.0, 2),
        "frame.normals": _span(8.0, 2), "frame.planes": _span(40.0, 2),
        "frame.lines": _span(30.0, 2),
        "track.pose_opt": _span(600.0, 4, syncs=0),
        "track.resolve": _span(4050.0, 2), "resolve.readback": _span(1.0, 2),
        "kf.add": _span(30.0), "kf.local_ba": _span(4000.0),
        "ba.cg": _span(3500.0, 4), "kf.readback": _span(5.0, syncs=1),
        "loop.resolve_gba": _span(1.0), "loop.process": _span(20.0)}
    return {"spans": spans, "call_ms": [1000.0, 4092.0], "frames": 2,
            "frames_window_s": 6.5, "keyframes": 1, "matcher": [],
            "device_ops": [], "window_s": 5.0}


WANT = {
    "frontend_ms": (10.0 + 60.0 + 8.0 + 40.0 + 30.0) / 2,
    "pose_solve_ms": 600.0 / 2,
    "ba_cg_ms": 3500.0,
    "host_syncs_per_frame": 5 / 2,
    "tracker_own_ms": (5090.0 - 900.0 - 4035.0 - 21.0) / 2,
}


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_on_a_recorded_summary(name):
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    m = next(m for m in spec["per_layer"] if m["name"] == name)
    assert (m["source"], m["moves"], m["workloads"]) == (
        "program_span", "setup_s", ["tum3_slam.corridor"])
    assert run.reader(name)(_records()) == pytest.approx(WANT[name],
                                                         rel=1e-9)


@pytest.mark.parametrize("name", sorted(WANT))
def test_span_reader_with_nothing_to_read(name):
    rec = _records()
    # a profiler without the spans inside a frame and inside local BA, and
    # without sync counts: the metric is left out
    old = {n: {k: s[k] for k in ("count", "total_ms", "mean_ms", "p50_ms",
                                 "p95_ms")}
           for n, s in rec["spans"].items()
           if n.startswith(("kf.", "loop.")) or n in ("track.dispatch",
                                                       "resolve.readback")}
    assert run.reader(name)(dict(rec, spans=old)) is None
    assert run.reader(name)(dict(rec, spans={}, frames=0, keyframes=0,
                                 call_ms=[])) is None


def test_tracker_readings_differ_by_the_harness_readback():
    rec = _records()
    self_ms = run.reader("tracker_self_ms")(rec)
    own_ms = run.reader("tracker_own_ms")(rec)
    assert self_ms - own_ms == pytest.approx((5092.0 - 5090.0) / 2)


def test_cg_per_keyframe_needs_a_keyframe():
    assert run.reader("ba_cg_ms")(dict(_records(), keyframes=0)) is None
    assert run.reader("host_syncs_per_frame")(
        dict(_records(), spans={"track.call": _span(1.0)})) == 0.0
