"""Runs of both cells on the CPU through `run.run_cell`, with the look for a
card skipped: at the tests' small configuration (320x240, 512 keypoints)
each traffic mix tracks without a LOST frame on several seeds; at the
cells' own size (the preset, 640x480), with the timed path broken
underneath (a step that hands back its state unchanged, an answer or a
keyframe altered where it is produced), `correct` comes out false. The
limits of the broken runs are the sound run's readings of the same seed
with a quarter more room, since a CPU run's window holds a frame or two.
The program on bfloat16 operands (the control) fails the cell's own
`orth_err` limit.

    python -m pytest slam_bench/tests -q -n 2   (about 3 minutes)"""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

from slam_bench import control, run
from slam_bench.tests import cells

SECONDS = 1.0     # a frame or two on a CPU


def small_cfg():
    from dr_slam_torch.config import (CameraConfig, LineConfig, MapConfig,
                                      ORBConfig, SlamConfig)
    return SlamConfig(
        camera=CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                            width=320, height=240, bf=20.0),
        orb=ORBConfig(n_features=400, n_levels=4, max_keypoints=512),
        line=LineConfig(max_lines=32),
        map=MapConfig(max_points=4096, max_lines=512, max_planes=32,
                      max_keyframes=32, vocab_words=512))


def run_cpu(cell_name: str, seed: int, small: bool, limits=None,
            trace_on=False):
    torch.set_num_threads(4)
    cell = cells.load(cell_name)
    if limits is not None:
        cell["limits"] = limits
    keep = {}
    out = run.run_cell(cell, seed, SECONDS, trace_on, device="cpu",
                       cfg=small_cfg() if small else None, keep=keep)
    return out, keep


@functools.lru_cache(maxsize=None)
def sound(cell_name: str, seed: int, small: bool = True):
    return run_cpu(cell_name, seed, small)


def test_result_line_shape():
    out, _ = sound("tum3_slam.corridor", 2**31 + 101)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    # the CPU has no device memory to read: the set-up time alone
    assert set(out["metrics"]) == {"setup_s"}
    assert set(out["checks"]) == {"step_mm", "step_mean_mm",
                                  "turn_mean_mdeg", "kf_step_mm", "orth_err"}


@pytest.mark.parametrize("cell,seed", [
    ("tum3_slam.corridor", 2**31 + 101), ("tum3_slam.corridor", 7),
    ("tum3_loc.revisit", 2**31 + 102), ("tum3_loc.revisit", 8)])
def test_mixes_track_without_loss(cell, seed):
    out, keep = sound(cell, seed)
    assert out["attempted"] >= 1 and out["failed"] == 0
    r = keep["readings"]
    assert r["step_mm"] < 30.0 and r["drift_mm"] < 50.0
    assert r["orth_err"] < 1e-4
    if cell.startswith("tum3_loc"):
        assert r["map_diff"] == 0


def test_traced_run_reports_its_layers():
    out, _ = run_cpu("tum3_loc.revisit", 2**31 + 103, True, trace_on=True)
    # the CPU has no device trace: only the stage profiler's metrics
    assert set(out["metrics"]) == {"track_dispatch_ms", "tracker_self_ms",
                                   "window_frames_per_s",
                                   "window_frame_ms_p95"}
    assert "busy_s" in out["device"] and "breakdown" in out
    # localization inserts no keyframe: the sub-window follows the window
    assert out["subwindow"]["after_pass"] is False
    assert out["subwindow"]["passes"] == 0
    assert list(out)[-1] == "checks"


def test_traced_subwindow_follows_a_keyframe_pass():
    out, _ = run_cpu("tum3_slam.corridor", 2**31 + 104, True, trace_on=True)
    sub = out["subwindow"]
    assert sub["after_pass"] is True and sub["passes"] == 0
    assert len(sub["call_ms"]) == run.SUBWINDOW_CALLS
    assert out["metrics"]["tracker_self_ms"]["value"] > 0
    assert list(out)[-1] == "checks"


def _limits_of(cell: str, seed: int) -> dict:
    out, _ = sound(cell, seed, small=False)
    lim = {k: 1.25 * c["value"] for k, c in out["checks"].items()}
    if "map_diff" in lim:
        lim["map_diff"] = 0
    return lim


def _stale(monkeypatch):
    """track_rgbd hands back its first result for every frame: the pose it
    returns is left unchanged by each step."""
    from dr_slam_torch.slam.system import System
    real = System.track_rgbd
    first = {}

    def stale(self, *a, **k):
        res = real(self, *a, **k)
        return first.setdefault(id(self), res)

    monkeypatch.setattr(System, "track_rgbd", stale)


def _moved(monkeypatch):
    """One frame's pose altered by 5 cm where the system produces it."""
    from dr_slam_torch.slam.system import System
    real = System.track_rgbd
    calls = {"n": 0}

    def moved(self, *a, **k):
        res = real(self, *a, **k)
        calls["n"] += 1
        if calls["n"] == 13:   # the window's first frame
            T = torch.as_tensor(np.asarray(
                res.T_cw.detach().cpu() if isinstance(res.T_cw, torch.Tensor)
                else res.T_cw), dtype=torch.float64).clone()
            T[0, 3] += 0.05
            res.T_cw = T
        return res

    monkeypatch.setattr(System, "track_rgbd", moved)


def _kf_moved(monkeypatch):
    """Local mapping's keyframe pose altered by 5 cm where it is
    produced."""
    from dr_slam_torch.slam import tracking
    real = tracking.map_ba

    def moved(state, cfg, center_kf):
        st = real(state, cfg, center_kf=center_kf)
        pose = st.kf_pose.clone()
        pose[center_kf, 0, 3] += 0.05
        return st._replace(kf_pose=pose)

    monkeypatch.setattr(tracking, "map_ba", moved)


@pytest.mark.parametrize("cell,fault,caught_by", [
    ("tum3_slam.corridor", _stale, "step_mean_mm"),
    ("tum3_slam.corridor", _moved, "step_mm"),
    ("tum3_slam.corridor", _kf_moved, "kf_step_mm"),
    ("tum3_loc.revisit", _stale, "step_mean_mm")])
def test_faults_make_the_run_incorrect(monkeypatch, cell, fault, caught_by):
    seed = 2**31 + 101 if cell.startswith("tum3_slam") else 2**31 + 102
    limits = _limits_of(cell, seed)
    fault(monkeypatch)
    out, _ = run_cpu(cell, seed, False, limits=limits)
    assert out["correct"] is False
    c = out["checks"][caught_by]
    assert c["value"] > c["limit"]


def test_bf16_operands_fail_the_check():
    """The program with its matrix products and convolutions on bfloat16
    operands (`control.Bf16Operands`) at the cell's own size: its poses
    fail the cell's own `orth_err` limit through `reference.judge`, where
    the sound run of the same seed keeps within it."""
    cell, seed = "tum3_slam.corridor", 2**31 + 101
    out, _ = sound(cell, seed, small=False)
    c = out["checks"]["orth_err"]
    assert c["value"] <= c["limit"]
    with control.Bf16Operands():
        low, _ = run_cpu(cell, seed, False)
    assert low["correct"] is False
    c = low["checks"]["orth_err"]
    assert c["value"] > c["limit"]
