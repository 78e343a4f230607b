"""The port's stage profiler (dr_slam_torch/utils/profiling.py): off by
default, on with `enable()` or DRSLAM_PROFILE_STAGES, count / total / mean
/ p50 / p95 ms per span; and a twin of tests/test_aux.py's run: the port's
`System` on the CPU over 8 corridor frames with the profiler on writes
`stage_profile.json` at shutdown, with the keyframe, dispatch and readback
spans in it."""

import json
import os
import subprocess
import sys

import numpy as np
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_torch.utils.profiling import PROFILER, StageProfiler, stage_span

from torch_parity import small_cfg, to_port

torch.set_num_threads(2)


def test_profiler_summary_and_switches():
    p = StageProfiler()
    assert not p.enabled
    with p.span("off"):
        pass
    p.record("off", 1.0)
    assert p.summary() == {}
    p.enable()
    for ms in (1.0, 2.0, 3.0, 10.0):
        p.record("a", ms)
    with p.span("b", sync=torch.zeros(2)):
        pass
    s = p.summary()
    assert s["a"] == {"count": 4, "total_ms": 16.0, "mean_ms": 4.0,
                      "p50_ms": 3.0, "p95_ms": 10.0}
    assert s["b"]["count"] == 1 and s["b"]["total_ms"] >= 0
    p.reset()
    assert p.summary() == {}
    p.disable()
    with p.span("c"):
        pass
    assert p.summary() == {}


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
        with stage_span("kf.add", [], torch.device("cpu")):
            pass
        with stage_span("track.dispatch"):
            pass
        assert set(PROFILER.summary()) == {"kf.add", "track.dispatch"}
    finally:
        PROFILER.disable()
        PROFILER.reset()


def test_system_writes_stage_profile(tmp_path):
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
        sysm.shutdown(save_dir=str(tmp_path))
    finally:
        PROFILER.disable()
        PROFILER.reset()
    summ = json.loads((tmp_path / "stage_profile.json").read_text())
    assert "kf.add" in summ and summ["kf.add"]["count"] >= 1
    # frame 0 initializes; each later frame is dispatched, and resolved
    # (the last at shutdown's flush)
    for name in ("track.dispatch", "track.device", "resolve.readback"):
        assert summ[name]["count"] == 7, name
    for st in summ.values():
        assert st["mean_ms"] >= 0 and st["p95_ms"] >= st["p50_ms"] - 1e-6
