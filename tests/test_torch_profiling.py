"""The port's stage profiler (dr_slam_torch/utils/profiling.py): off by
default, on with `enable()` or DRSLAM_PROFILE_STAGES; count / total / mean
/ p50 / p95 / self ms, host syncs and parent per span, every span on the
clock of `torch.profiler`'s events; off, it records, allocates and
synchronises nothing. And a twin of tests/test_aux.py's run: the port's
`System` on the CPU over 8 corridor frames with the profiler on writes
`stage_profile.json` at shutdown, with every span the frames pass through
at its count per frame."""

import contextlib
import json
import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_torch.utils.profiling import (PROFILER, SYNC_WARNING,
                                           StageProfiler, stage_span)

from torch_parity import small_cfg, to_port

torch.set_num_threads(2)


class _Clock:
    """A stand-in for a profiler's clock that moves only when told."""

    def __init__(self):
        self.ns = 0

    def __call__(self):
        return self.ns

    def advance(self, ms: float):
        self.ns += int(ms * 1e6)


def _on_a_clock() -> tuple:
    p, clock = StageProfiler(), _Clock()
    p._now_ns = clock
    return p, clock


def test_profiler_summary_and_switches():
    p, clock = _on_a_clock()
    assert not p.enabled
    with p.span("off"):
        clock.advance(1.0)
    assert p.summary() == {} and p.records == []
    p.enable()
    for ms in (1.0, 2.0, 3.0, 10.0):
        with p.span("a"):
            clock.advance(ms)
    s = p.summary()
    assert s["a"] == {"count": 4, "total_ms": 16.0, "mean_ms": 4.0,
                      "p50_ms": 3.0, "p95_ms": 10.0, "self_ms": 16.0,
                      "syncs": 0, "parent": None, "parents": {}}
    p.reset()
    assert p.summary() == {}
    p.disable()
    with p.span("c"):
        pass
    assert p.summary() == {}


def test_nesting_parent_and_self_time():
    p, clock = _on_a_clock()
    p.enable()
    for _ in range(2):
        with p.span("track.call", frame=7):
            clock.advance(0.5)
            with p.span("track.resolve"):
                clock.advance(1.0)
            with p.span("track.dispatch"):
                with p.span("frame.orb"):
                    clock.advance(2.0)
                clock.advance(0.25)
                with p.span("track.pose_opt"):
                    clock.advance(3.0)
            clock.advance(0.25)
    s = p.summary()
    assert s["track.call"]["total_ms"] == 14.0
    assert s["track.call"]["self_ms"] == 1.5
    assert s["track.dispatch"]["total_ms"] == 10.5
    assert s["track.dispatch"]["self_ms"] == 0.5
    assert s["frame.orb"]["self_ms"] == s["frame.orb"]["total_ms"] == 4.0
    assert [s[n]["parent"] for n in ("track.call", "track.resolve",
                                     "track.dispatch", "frame.orb",
                                     "track.pose_opt")] == [
        None, "track.call", "track.call", "track.dispatch", "track.dispatch"]
    # one record per span, in order of entry, each carrying the root's frame
    assert [r.name for r in p.records[:5]] == [
        "track.call", "track.resolve", "track.dispatch", "frame.orb",
        "track.pose_opt"]
    assert [r.parent for r in p.records[:5]] == [-1, 0, 0, 2, 2]
    assert {r.frame for r in p.records} == {7}
    assert p.records[3].start_ns - p.records[0].start_ns == int(1.5e6)


def test_parents_count_a_span_under_each_enclosing_span():
    """A span opened under several parents: `parent` is the most common,
    `parents` counts each (the root records left out), so a reader can take
    the records under one parent alone."""
    p, clock = _on_a_clock()
    p.enable()
    for outer in ("track.pose_opt", "track.pose_opt", "track.reloc", None):
        with contextlib.ExitStack() as stack:
            if outer:
                stack.enter_context(p.span(outer))
            with p.span("pose_opt.kernel"):
                clock.advance(1.0)
    s = p.summary()
    assert s["pose_opt.kernel"]["count"] == 4
    assert s["pose_opt.kernel"]["parent"] == "track.pose_opt"
    assert s["pose_opt.kernel"]["parents"] == {"track.pose_opt": 2,
                                               "track.reloc": 1}
    assert s["track.reloc"]["parents"] == {}


def test_sync_counter_attributes_each_sync_to_the_innermost_span(
        monkeypatch):
    """The hook is fed directly (the CPU has no syncs): torch.cuda's sync
    warning, as the debug mode raises it, and the explicit count."""
    modes = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", modes.append)
    p = StageProfiler()

    def sync():
        warnings.warn(SYNC_WARNING + " (Triggered internally at Copy.cu)")

    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("default")
        p.enable()
        assert modes == ["warn"]
        sync()                       # outside every span: not counted
        with p.span("track.call"):
            sync()
            with p.span("track.dispatch"):
                with p.span("frame.ingest"):
                    for _ in range(3):   # one line, each time counted
                        sync()
                warnings.warn("something else")
            p.count_sync()
        p.disable()
    assert modes == ["warn", 0]
    assert [str(w.message) for w in shown] == ["something else"]
    s = p.summary()
    assert {n: s[n]["syncs"] for n in s} == {
        "track.call": 2, "track.dispatch": 0, "frame.ingest": 3}
    assert sum(r.syncs for r in p.records) == 5


def test_spans_of_another_thread_are_not_recorded():
    """The profiler times the thread that enabled it: a span the live
    viewer's worker opens while the tracker's spans are open records
    nothing, counts no sync, and leaves the tracker's nesting whole."""
    p, clock = _on_a_clock()
    p.enable()

    def viewer():
        with p.span("frame.orb"):
            clock.advance(5.0)
            p.count_sync()
        with p.span("frame.lines"):
            pass

    with p.span("track.call", frame=3):
        with p.span("track.dispatch"):
            worker = threading.Thread(target=viewer)
            worker.start()
            worker.join()
            with p.span("frame.orb"):
                clock.advance(2.0)
                p.count_sync()
        with p.span("track.resolve"):
            clock.advance(1.0)
    assert [(r.name, r.parent) for r in p.records] == [
        ("track.call", -1), ("track.dispatch", 0), ("frame.orb", 1),
        ("track.resolve", 0)]
    s = p.summary()
    assert s["frame.orb"]["count"] == 1 and s["frame.orb"]["syncs"] == 1
    assert s["frame.orb"]["total_ms"] == 2.0
    assert s["track.dispatch"]["self_ms"] == 5.0
    assert s["track.call"]["total_ms"] == 8.0
    assert "frame.lines" not in s


def test_disabled_profiler_records_allocates_and_synchronises_nothing(
        monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the span path touched the device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("set_sync_debug_mode", "get_sync_debug_mode", "synchronize",
                 "Event"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    p = StageProfiler()
    assert not PROFILER.enabled
    n = len(PROFILER.records)
    with stage_span("track.call", frame=3):
        with stage_span("track.dispatch"):
            PROFILER.count_sync()
        with p.span("kf.local_ba"):
            p.count_sync()
    assert len(PROFILER.records) == n and p.records == []
    assert p.summary() == {}


def test_spans_sit_on_the_profiler_clock():
    """Under torch.profiler, each span's interval is its record_function
    event's within 1 ms."""
    from torch.profiler import ProfilerActivity, profile

    PROFILER.reset()
    PROFILER.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            # the profiler's first block pays its set-up inside the event
            with stage_span("warm"):
                pass
            PROFILER.reset()
            with stage_span("track.call", frame=0):
                with stage_span("track.dispatch"):
                    time.sleep(0.004)
                    with stage_span("frame.orb"):
                        time.sleep(0.002)
                time.sleep(0.002)
        recs = list(PROFILER.records)
    finally:
        PROFILER.disable()
        PROFILER.reset()
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.is_user_annotation()}
    assert len(recs) == 3
    for r in recs:
        e = events[r.name]
        assert abs(e.start_ns() - r.start_ns) < 1e6, r.name
        assert abs(e.end_ns() - r.end_ns) < 1e6, r.name


def test_environment_switches_it_on():
    code = ("from dr_slam_torch.utils.profiling import PROFILER; "
            "print(PROFILER.enabled)")
    base = {k: v for k, v in os.environ.items()
            if k != "DRSLAM_PROFILE_STAGES"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for env, want in (({"DRSLAM_PROFILE_STAGES": "1"}, "True"), ({}, "False")):
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, check=True, env={**base, **env},
                             cwd=root)
        assert out.stdout.strip() == want


def test_stage_span_feeds_the_profiler():
    PROFILER.reset()
    PROFILER.enable()
    try:
        with stage_span("kf.add"):
            pass
        with stage_span("track.dispatch"):
            pass
        assert set(PROFILER.summary()) == {"kf.add", "track.dispatch"}
    finally:
        PROFILER.disable()
        PROFILER.reset()


def test_system_writes_stage_profile(tmp_path, monkeypatch):
    from dr_slam_torch.optimize.global_ba import bundle_adjust
    from dr_slam_torch.slam import tracking
    from dr_slam_torch.slam.system import System

    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(8), K4=cfg.camera.K4, height=240,
        width=320)
    PROFILER.reset()
    PROFILER.enable()
    try:
        sysm = System(to_port(cfg), enable_loop_closing=False, device="cpu")
        for i in range(8):
            gray, depth = (np.asarray(x) for x in seq.render(i))
            sysm.track_rgbd(gray, depth, i / 30.0)
        # the 8 frames insert no keyframe past the first: its local BA as
        # the pass at a keyframe runs it, cut to 2 Gauss-Newton steps of 2
        # CG iterations
        monkeypatch.setattr(tracking, "bundle_adjust", lambda p, K4, **kw:
                            bundle_adjust(p, K4, n_gn_iters=2, n_cg_iters=2))
        with stage_span("kf.local_ba"):
            tracking.map_ba(sysm.tracker.map_state, sysm.cfg,
                            center_kf=torch.tensor(0))
        sysm.shutdown(save_dir=str(tmp_path))
        recs = list(PROFILER.records)
    finally:
        PROFILER.disable()
        PROFILER.reset()
    summ = json.loads((tmp_path / "stage_profile.json").read_text())
    assert [r.frame for r in recs if r.name == "track.call"] == list(range(8))
    # every call after the first resolves the frame before it; shutdown's
    # flushes resolve outside any call
    in_call = [r for r in recs if r.name == "track.resolve"
               and r.parent >= 0 and recs[r.parent].name == "track.call"]
    assert [r.frame for r in in_call] == list(range(1, 8))
    assert summ["kf.add"]["count"] == 1
    # frame 0 initializes; each later frame is dispatched (the front-end
    # and the step's two passes inside the dispatch) and resolved (the last
    # at shutdown's flush)
    per = {"track.call": 8, "track.dispatch": 7, "resolve.readback": 7,
           "frame.ingest": 8, "frame.orb": 8, "frame.normals": 8,
           "frame.planes": 8, "frame.lines": 8, "track.manhattan": 7,
           "track.match": 14, "track.assoc": 14, "track.pose_opt": 14,
           "track.stats": 7, "kf.local_ba": 1, "ba.problem": 1,
           "ba.linearize": 2, "ba.cg": 2}
    for name, count in per.items():
        assert summ[name]["count"] == count, name
    parents = {"track.dispatch": "track.call", "track.resolve": "track.call",
               "resolve.readback": "track.resolve",
               "frame.orb": "track.dispatch", "frame.ingest": "track.dispatch",
               "track.pose_opt": "track.dispatch",
               "track.match": "track.dispatch",
               "kf.add": "track.call", "ba.problem": "kf.local_ba",
               "ba.cg": "kf.local_ba", "track.call": None}
    for name, parent in parents.items():
        assert summ[name]["parent"] == parent, name
    assert "track.device" not in summ and "frame.cylinders" not in summ
    for st in summ.values():
        assert st["mean_ms"] >= 0 and st["p95_ms"] >= st["p50_ms"] - 1e-6
        assert -1e-3 <= st["self_ms"] <= st["total_ms"] + 1e-3
        assert st["syncs"] == 0   # no sync is counted on the CPU
