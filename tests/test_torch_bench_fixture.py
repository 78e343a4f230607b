"""Phase 14 of chip_smoke.py on the CPU at 640x480 (`tum_freiburg3()`),
cut: bench_torch.py's odometry map and device-loop leg against the JAX runs
in dr_slam_torch/data/bench_runs.npz (scripts/make_torch_bench_fixture.py;
JAX's renders, the port's two rules on the JAX side). No JAX runs here.

- The odometry leg's map of the mapping fixture's frames 0-11, loaded back
  from its file: live keyframes exact, keyframe poses within 3e-3, points
  within 2% of the JAX map's (observed equal: 985).
- The tracking leg over the fixture's first 24 frames (JAX's renders as
  uint8 gray and uint16 depth; 14 warm, 10 timed): states, keyframe flags,
  reference keyframes exact, T_cw within 3e-3, inliers and matches within
  2% of the JAX run's.
- The device-loop leg over the first 34 frames of the port's renders (25
  warm, 9 through its staged copies): states, keyframe flags, reference keyframes
  and their sequences exact, T_cw within 3e-3, matches within 2%, and
  inliers within 2% on every frame but frames 27, 30 and 33
  (`_smoke.BENCH_PYRAMID_FRAMES`), where the JAX package's jitted pyramid
  alone moves them 3.4-5.2% and a witness holds them
  (tests/test_torch_bench.py), one readback per step."""

import os
import sys

import numpy as np
import pytest
import torch

from dr_slam_torch import _smoke
from dr_slam_torch.config import tum_freiburg3

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench_torch  # noqa: E402

T_TOL = _smoke.TRACKER_T_TOL
COUNT_TOL = _smoke.TRACKER_COUNT_TOL
N, WARM = 34, 25


@pytest.fixture(scope="module")
def data():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield _smoke.load_bench_fixture()
    torch.set_num_threads(old)


def test_odometry_map_against_jax(data):
    cfg = tum_freiburg3()
    m = _smoke.load_mapping_fixture()
    df = cfg.camera.depth_factor
    frames = [(m["gray"][i].astype(np.float32),
               m["depth"][i].astype(np.float32) / df)
              for i in range(bench_torch.ODOMETRY_FRAMES)]
    rec = bench_torch.bench_odometry(1, cfg, "cpu", frames, windows=1).record
    got = rec["loaded_map"]
    valid = data["odo_kf_valid"]
    np.testing.assert_array_equal(got.kf_valid.numpy(), valid)
    np.testing.assert_allclose(got.kf_pose.numpy()[valid],
                               data["odo_kf_pose"][valid], rtol=0,
                               atol=T_TOL)
    assert _smoke.count_gaps(int(got.pt_valid.sum()),
                             int(data["odo_n_pts"])) <= COUNT_TOL


def test_tracking_leg_on_fixture_frames(data):
    cfg = tum_freiburg3()
    frames = _smoke.bench_fixture_frames(data, cfg.camera.depth_factor)
    got = bench_torch.bench_tracking(24, cfg, "cpu", frames[:24]).record
    for k in ("state", "is_keyframe", "ref_kf"):
        np.testing.assert_array_equal(got[k], data[f"trk_{k}"][:24],
                                      err_msg=k)
    assert got["kf_frames"].tolist() == [0, 10, 22]
    np.testing.assert_allclose(got["T_cw"], data["trk_T_cw"][:24], rtol=0,
                               atol=T_TOL)
    for k in ("n_inliers", "n_matches"):
        rel = _smoke.count_gaps(got[k], data[f"trk_{k}"][:24])
        assert rel.max() <= COUNT_TOL, k


def test_device_loop_leg_against_jax(data):
    rec = bench_torch.bench_interactive_device(N, WARM, tum_freiburg3(),
                                               "cpu").record
    got, want = rec["records"], data["dl_records"][:N]
    for k, name in _smoke.DEVICE_LOOP_EXACT.items():
        np.testing.assert_array_equal(got[:, k], want[:, k], err_msg=name)
    assert np.nonzero(got[:, 19])[0].tolist() == [0, 10, 22]
    np.testing.assert_allclose(got[:, :16], want[:, :16], rtol=0, atol=T_TOL)
    held = _smoke.bench_inliers_held(N)
    assert not held[list(_smoke.BENCH_PYRAMID_FRAMES)].any()
    assert _smoke.count_gaps(got[:, 17][held], want[:, 17][held]).max() \
        <= COUNT_TOL
    assert _smoke.count_gaps(got[:, 18], want[:, 18]).max() <= COUNT_TOL
    assert rec["readbacks"].tolist() == [1] * N
