"""bench_torch.py, the port's twin of bench.py, on the CPU at
tests/test_tracking_e2e.py's small configuration (320x240), fed the JAX
package's renders of the corridor.

- The tracking leg (`System.track_rgbd`, 24 frames: 14 warm, 10 timed)
  against the JAX `System` over the same frames, run by
  scripts/make_torch_bench_fixture.py's `jax_tracking_run` with the port's
  two rules (the decision lagged by one frame, rotations projected onto
  SO(3)): states, keyframe flags, reference keyframes and keyframes' frames
  exact, T_cw within 3e-3, inliers and matches within 2% (a near-tie in
  the front-end moves frame 1 by one match, tests/test_torch_device_loop.py).
- The device-loop leg (24 frames, 12 warm, 12 through its staged copies)
  against the JAX `DeviceLoopTracker` by the same rule, and against plain
  `track()` calls of the port's tracker on the same numpy frames: equal.
- The odometry leg: the map it loads back equals the `System`'s own map bit
  for bit and the JAX `System`'s by the same rule (keyframes exact, their
  poses within 3e-3, points within 2%), and its pipelined window equals
  `_smoke.pipelined` from the same start on the same staged frames.
- The front-end leg's valid keypoints within 2% of JAX's `extract_orb`.
- `main`: its line has bench.py's keys but `mfu_estimate`'s, plus the
  device loop's readbacks per frame; a leg that raises ends it with no
  line; without a card it raises; the script imports nothing of JAX.
- At 640x480, the witness for the device loop's inliers on
  `_smoke.BENCH_PYRAMID_FRAMES` in dr_slam_torch/data/bench_runs.npz."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from dr_slam_torch import _smoke

from torch_parity import (load_script, numpy_frames, projected_tracked_pose,
                          shipped_codebooks, small_cfg, to_port)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_torch  # noqa: E402

N = 24
T_TOL = _smoke.TRACKER_T_TOL
# bench.py's main: the keys of its line (bench.py:320-367) but mfu_estimate's
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "interactive_fps",
              "interactive_fps_host_readback", "ate_rmse_m",
              "ate_rmse_raw_m", "loops_closed"}


@pytest.fixture(scope="module")
def threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def setup(threads):
    from dr_slam_tpu.io import synthetic

    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(N),
                                      K4=cfg.camera.K4, height=240, width=320)
    return dict(cfg=cfg, tcfg=to_port(cfg), frames=numpy_frames(seq, N),
                poses=seq.poses_cw, fixture=load_script(
                    "make_torch_bench_fixture"))


def _counts_within(got, want, what):
    rel = _smoke.count_gaps(got, want)
    assert (rel <= _smoke.TRACKER_COUNT_TOL).all(), (what, rel, got, want)


def test_tracking_leg_against_jax(setup):
    with projected_tracked_pose():
        want = setup["fixture"].jax_tracking_run(setup["cfg"], setup["frames"])
    leg = bench_torch.bench_tracking(N, setup["tcfg"], "cpu", setup["frames"])
    got = leg.record
    assert got["warm"] == 14 and leg.fps > 0
    for k in ("state", "is_keyframe", "ref_kf", "kf_frames"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["kf_frames"].tolist() == [0, 10, 20]
    assert (got["state"] == 2).all()
    np.testing.assert_allclose(got["T_cw"], want["T_cw"], rtol=0, atol=T_TOL)
    for k in ("n_inliers", "n_matches"):
        _counts_within(got[k], want[k], k)
    assert got["n_kfs"] == int(want["n_kfs"])
    _counts_within(got["n_pts"], int(want["n_pts"]), "n_pts")
    ate = _smoke.trajectory_ate(got["T_cw"], setup["poses"])
    want_ate = _smoke.trajectory_ate(want["T_cw"], setup["poses"])
    assert ate < 0.05 and ate <= 2 * want_ate + 0.005, (ate, want_ate)


@pytest.fixture(scope="module")
def device_leg(setup):
    return bench_torch.bench_interactive_device(N, 12, setup["tcfg"], "cpu",
                                                setup["frames"])


def test_device_loop_leg_against_jax(setup, device_leg):
    fx = setup["fixture"]
    quantised = [fx.quantize(g, d, setup["cfg"].camera.depth_factor)
                 for g, d in setup["frames"]]
    with projected_tracked_pose(), shipped_codebooks():
        want = fx.jax_device_loop_run(setup["cfg"], quantised)
    got = device_leg.record
    assert got["records"].shape == want["records"].shape
    for k, name in _smoke.DEVICE_LOOP_EXACT.items():
        np.testing.assert_array_equal(got["records"][:, k],
                                      want["records"][:, k], err_msg=name)
    np.testing.assert_allclose(got["records"][:, :16],
                               want["records"][:, :16], rtol=0, atol=T_TOL)
    for k in (17, 18):
        _counts_within(got["records"][:, k], want["records"][:, k], k)
    assert got["n_keyframes"] == int(want["n_keyframes"]) == 3
    assert got["readbacks"].tolist() == [1] * N
    assert got["warm"] == 12 and device_leg.fps > 0


def test_device_loop_staged_copies_equal_plain_track(setup, device_leg):
    from dr_slam_torch.slam.device_loop import DeviceLoopTracker

    fx = setup["fixture"]
    with _smoke.shipped_codebooks():
        tr = DeviceLoopTracker(setup["tcfg"], device="cpu")
        for i, (g, d) in enumerate(setup["frames"]):
            tr.track(*fx.quantize(g, d, setup["cfg"].camera.depth_factor),
                     i / 30.0)
    np.testing.assert_array_equal(device_leg.record["records"],
                                  tr.flush()["records"])
    assert device_leg.record["readbacks"].tolist() == tr.readbacks


def test_odometry_leg_round_trip_and_pipelined(setup):
    tcfg = setup["tcfg"]
    leg = bench_torch.bench_odometry(3, tcfg, "cpu", setup["frames"][:16],
                                     windows=1)
    rec = leg.record
    for f in rec["system_map"]._fields:
        a, b = getattr(rec["system_map"], f), getattr(rec["loaded_map"], f)
        assert a.dtype == b.dtype, f
        assert torch.equal(a, b), f
    # the map against the JAX System's, lagged and projected, saved unflushed
    with projected_tracked_pose():
        want = setup["fixture"].jax_odometry_map(
            setup["cfg"], setup["frames"][:bench_torch.MAP_FRAMES])
    got = rec["loaded_map"]
    np.testing.assert_array_equal(got.kf_valid.numpy(), want["kf_valid"])
    assert int(got.kf_valid.sum()) == 2
    np.testing.assert_allclose(got.kf_pose.numpy()[want["kf_valid"]],
                               want["kf_pose"][want["kf_valid"]], rtol=0,
                               atol=T_TOL)
    _counts_within(int(got.pt_valid.sum()), int(want["n_pts"]), "points")
    assert len(rec["staged"]) == 4
    assert rec["staged"][0][0].dtype == torch.uint8
    assert rec["staged"][0][1].dtype == torch.uint16
    st, T, R = rec["start"]
    fxt = _smoke.Fixture({}, st, rec["staged"], T, torch.eye(4), R,
                         torch.tensor(1))
    want = _smoke.pipelined(fxt, 3, tcfg)
    for f in ("T_cw", "R_cm", "n_inliers", "n_matches", "mp_idx"):
        assert torch.equal(getattr(rec["out"], f), getattr(want, f)), f
    for f in rec["out"].new_map_state._fields:
        assert torch.equal(getattr(rec["out"].new_map_state, f),
                           getattr(want.new_map_state, f)), f
    assert len(rec["window_fps"]) == 1 and leg.fps == rec["window_fps"][0]
    assert int(rec["out"].n_inliers) > 50


def test_frontend_leg_against_jax(setup):
    grays = [g for g, _ in setup["frames"][:4]]
    want = setup["fixture"].jax_frontend_counts(grays)
    leg = bench_torch.bench_frontend(4, setup["tcfg"], "cpu", grays)
    assert leg.record["n_valid"].min() > 100
    _counts_within(leg.record["n_valid"], want, "n_valid")


def _fake_legs(monkeypatch, raising=None):
    def leg(fps, record=None):
        def run(*a, **kw):
            return bench_torch.LegRun(fps, record or {})
        return run

    legs = {
        "bench_odometry": leg(1.7, {"window_fps": [1.6, 1.7, 1.65],
                                    "launches": [480] * 3}),
        "bench_interactive_device": leg(1.3, {
            "readbacks": np.ones(120), "warm": 25, "seconds": 73.0,
            "records": np.zeros((120, 40)), "launches": np.full(120, 2)}),
        "bench_tracking": leg(1.1, {
            "state": np.full(60, 2), "warm": 23, "seconds": 33.6,
            "kf_frames": np.asarray([0, 10]), "launches": np.full(60, 2)}),
        "bench_accuracy": lambda *a, **kw: {
            "ate_rmse_m": 0.0299, "ate_rmse_raw_m": 0.188,
            "loops_closed": 1, "frames": 270},
    }
    if raising is not None:
        def fail(*a, **kw):
            raise RuntimeError(f"{raising} failed")
        legs[raising] = fail
    for name, fn in legs.items():
        monkeypatch.setattr(bench_torch, name, fn)


def test_main_line_has_bench_keys(monkeypatch, capsys):
    _fake_legs(monkeypatch)
    out = bench_torch.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == BENCH_KEYS | {"interactive_readbacks_per_frame"}
    assert line["metric"] == "tracking_fps_pipelined_640x480"
    assert line["unit"] == "frames/sec"
    assert line["value"] == 1.7 and line["vs_baseline"] == round(1.7 / 30, 3)
    assert line["interactive_readbacks_per_frame"] == 1.0


@pytest.mark.parametrize("leg", ["bench_odometry", "bench_interactive_device",
                                 "bench_tracking", "bench_accuracy"])
def test_a_leg_that_raises_ends_main(monkeypatch, capsys, leg):
    _fake_legs(monkeypatch, raising=leg)
    with pytest.raises(RuntimeError, match=f"{leg} failed"):
        bench_torch.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


def test_main_without_a_card_raises(monkeypatch):
    _fake_legs(monkeypatch)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main([])


def test_imports_nothing_of_jax():
    src = open(os.path.join(ROOT, "bench_torch.py")).read()
    for word in ("import jax", "from jax", "dr_slam_tpu"):
        assert word not in src, word
    code = ("import sys; import bench_torch; bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'dr_slam_tpu')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=ROOT)
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True)


def test_device_loop_pyramid_witness():
    """The witness that holds the device loop's inliers on
    `_smoke.BENCH_PYRAMID_FRAMES` (frames 27, 30, 33 of bench_runs.npz's
    run at 640x480, where the port's own run sits 3.4-5.2% from JAX's): the
    JAX `DeviceLoopTracker` over the fixture's frames 0-33 gives the
    fixture's records; its carry before frame 27 goes into the port, which
    with the JAX package's jitted pyramid in place of its own gives JAX's
    records on frames 27-33, every integer and count equal and T_cw within
    1e-5 (observed 6.6e-7). So those gaps are the pyramid's float32
    rounding, and nothing after it."""
    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker
    from dr_slam_torch.ops import image as timage
    from dr_slam_torch.slam.device_loop import DeviceLoopTracker

    from torch_parity import carry_arrays, carry_to_port, jax_pyramid

    data = _smoke.load_bench_fixture()
    first = min(_smoke.BENCH_PYRAMID_FRAMES)
    last = max(_smoke.BENCH_PYRAMID_FRAMES)
    frames = list(zip(data["frames_gray"][:last + 1],
                      data["frames_depth"][:last + 1]))
    cfg = tum_freiburg3()

    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with shipped_codebooks(), projected_tracked_pose():
            jt = JTracker(cfg)
            for i, (g, d) in enumerate(frames):
                if i == first:
                    carried = carry_arrays(jt.carry)
                jt.track(g, d, i / 30.0)
            want = jt.flush()["records"]
            np.testing.assert_allclose(want, data["dl_records"][:last + 1],
                                       rtol=0, atol=1e-6)
            own = timage.build_pyramid
            timage.build_pyramid = jax_pyramid
            try:
                pt = DeviceLoopTracker(to_port(cfg), device="cpu")
                pt.carry = carry_to_port(carried)
                pt._initialized = True
                for i in range(first, last + 1):
                    pt.track(*frames[i], i / 30.0)
                got = pt.flush()["records"]
            finally:
                timage.build_pyramid = own
    finally:
        torch.set_num_threads(old)
    want = want[first:]
    np.testing.assert_array_equal(got[:, 16:], want[:, 16:])
    np.testing.assert_allclose(got[:, :16], want[:, :16], rtol=0, atol=1e-5)


def test_tracking_leg_pyramid_witness():
    """The witness for the `System` leg's inliers on
    `_smoke.BENCH_PYRAMID_FRAMES` (its records 28, 31, 34: each call
    returns the frame before's, and there the port's own run sits 3.4-4.8%
    from JAX's): with the JAX package's jitted pyramid in place of its own,
    the port's leg over the fixture's first 35 frames holds against the
    fixture's run on every record, those included: states, keyframe flags
    and reference keyframes exact, T_cw within 3e-3, inliers and matches
    within 2%."""
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.ops import image as timage

    from torch_parity import jax_pyramid

    data = _smoke.load_bench_fixture()
    n = max(_smoke.BENCH_PYRAMID_FRAMES) + 2
    cfg = tum_freiburg3()
    frames = _smoke.bench_fixture_frames(data, cfg.camera.depth_factor)[:n]

    old, own = torch.get_num_threads(), timage.build_pyramid
    torch.set_num_threads(2)
    timage.build_pyramid = jax_pyramid
    try:
        got = bench_torch.bench_tracking(n, cfg, "cpu", frames).record
    finally:
        timage.build_pyramid = own
        torch.set_num_threads(old)
    assert not _smoke.bench_inliers_held(n, lag=1)[-1]
    for k in ("state", "is_keyframe", "ref_kf"):
        np.testing.assert_array_equal(got[k], data[f"trk_{k}"][:n],
                                      err_msg=k)
    np.testing.assert_allclose(got["T_cw"], data["trk_T_cw"][:n], rtol=0,
                               atol=T_TOL)
    for k in ("n_inliers", "n_matches"):
        _counts_within(got[k], data[f"trk_{k}"][:n], k)
