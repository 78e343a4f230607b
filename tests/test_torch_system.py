"""The slice as a whole: the port's `System` against the JAX `System` over
the 25-frame corridor of tests/test_tracking_e2e.py, with loop closing on
(its detection runs at every keyframe and, on a 3-keyframe map, returns
before detection in both) and the ground-truth rotation fed for the
rotation-residual diagnostics. After each frame the JAX test waits for the
pending bundles, so the deferred decision lags by exactly one frame in both.

Per-frame states, keyframe flags and counts are exact, `map_summary` is
equal, the metrics log has the same events in the same numbers, the three
saved trajectory files agree within 2e-3 in every number (the poses do,
observed 6e-4, tests/test_torch_tracking.py), and a map saved by either
package loads into the other. The evaluation metrics (ATE, RPE) are equal,
and the drift injection of the loop evaluation moves the corridor's map the
same way within 1e-5. Without a card, `System(cfg)` raises, and so does
asking for a part that is not ported."""

import json

import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_torch.slam.system import System as TSystem

from torch_parity import small_cfg, to_port, wait_pending

torch.set_num_threads(2)

N = 25
TOL = 2e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from dr_slam_tpu.slam.system import System

    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(N, step=0.03), K4=cfg.camera.K4,
        height=240, width=320)
    out = tmp_path_factory.mktemp("system")
    js = System(cfg, enable_loop_closing=True,
                metrics_path=str(out / "jax_metrics.jsonl"))
    ts = TSystem(to_port(cfg), enable_loop_closing=True,
                 metrics_path=str(out / "port_metrics.jsonl"), device="cpu")
    T0_inv = np.linalg.inv(seq.poses_cw[0])
    jres, tres = [], []
    for i in range(N):
        gray, depth = (np.asarray(x, np.float32) for x in seq.render(i))
        gt_R = (seq.poses_cw[i] @ T0_inv)[:3, :3]
        jres.append(js.track_rgbd(gray, depth, i / 30.0, gt_R=gt_R))
        wait_pending(js)
        tres.append(ts.track_rgbd(gray, depth, i / 30.0, gt_R=gt_R))
    summaries = (js.map_summary(), ts.map_summary())
    for name, s in (("jax", js), ("port", ts)):
        s.save_trajectory_tum(str(out / f"{name}_traj.txt"))
        s.save_keyframe_trajectory_tum(str(out / f"{name}_kf.txt"))
        s.save_trajectory_manhattan(str(out / f"{name}_man.txt"))
        s.save_map(str(out / f"{name}_map.npz"))
        s.shutdown()
    return dict(cfg=cfg, jres=jres, tres=tres, summaries=summaries,
                js=js, ts=ts, out=out)


def test_states_and_counts_exact(runs):
    for i, (j, t) in enumerate(zip(runs["jres"], runs["tres"])):
        got = (t.state.name, t.is_keyframe, t.n_inliers, t.n_matches,
               t.manhattan_ok)
        want = (j.state.name, j.is_keyframe, j.n_inliers, j.n_matches,
                j.manhattan_ok)
        assert got == want, (i, got, want)
        assert abs(t.rot_residual_deg - j.rot_residual_deg) < 0.2, i
    assert all(r.state.name == "OK" for r in runs["tres"])


def test_map_summary_equal(runs):
    js, ts = runs["summaries"]
    assert js == ts
    assert ts["n_keyframes"] == 3


def test_saved_trajectories_agree(runs):
    out = runs["out"]
    for kind in ("traj", "kf", "man"):
        a = np.loadtxt(out / f"jax_{kind}.txt")
        b = np.loadtxt(out / f"port_{kind}.txt")
        assert a.shape == b.shape and len(a) in (N, 3), kind
        np.testing.assert_array_equal(b[:, 0], a[:, 0])
        np.testing.assert_allclose(b, a, rtol=0, atol=TOL, err_msg=kind)


def test_savers_write_the_same_text(tmp_path):
    """Both packages' savers, fed the same poses, write the same files, and
    read them back to the same poses."""
    from dr_slam_tpu.io import trajectory as jtraj
    from dr_slam_torch.io import trajectory as ttraj

    rng = np.random.RandomState(4)
    poses = synthetic.loop_trajectory(40)
    poses[:, :3, 3] += rng.normal(0, 0.3, (40, 3)).astype(np.float32)
    ts = np.arange(40) / 30.0
    R_mw = poses[7, :3, :3].T
    for name, mod in (("jax", jtraj), ("port", ttraj)):
        mod.save_trajectory_tum(str(tmp_path / f"{name}_t.txt"), ts, poses)
        mod.save_keyframe_trajectory_tum(str(tmp_path / f"{name}_k.txt"), ts,
                                         poses, valid=np.arange(40) % 3 == 0)
        mod.save_trajectory_manhattan(str(tmp_path / f"{name}_m.txt"), ts,
                                      poses, R_mw=R_mw)
    for kind in "tkm":
        a = (tmp_path / f"jax_{kind}.txt").read_text()
        b = (tmp_path / f"port_{kind}.txt").read_text()
        assert a == b, kind
    ja = jtraj.load_trajectory_tum(str(tmp_path / "jax_t.txt"))
    tb = ttraj.load_trajectory_tum(str(tmp_path / "port_t.txt"))
    np.testing.assert_array_equal(tb[0], ja[0])
    np.testing.assert_allclose(tb[1], ja[1], rtol=0, atol=1e-6)


def test_metrics_events_equal(runs):
    def kinds(path):
        with open(path) as f:
            evs = [json.loads(line)["event"] for line in f]
        return {k: evs.count(k) for k in set(evs)}
    out = runs["out"]
    j = kinds(out / "jax_metrics.jsonl")
    t = kinds(out / "port_metrics.jsonl")
    assert j == t
    assert t["frame"] == N and t["rot_residual"] == N


def test_saved_maps_load_both_ways(runs):
    from dr_slam_tpu.io.map_io import load_map as jload
    from dr_slam_torch.io.map_io import load_map as tload

    cfg, out = runs["cfg"], runs["out"]
    from_port = jload(str(out / "port_map.npz"), cfg)
    from_jax = tload(str(out / "jax_map.npz"), to_port(cfg), "cpu")
    for a, b in ((from_port, runs["ts"].tracker.map_state),
                 (runs["js"].tracker.map_state, from_jax)):
        for f in a._fields:
            x = np.asarray(getattr(a, f))
            y = getattr(b, f).numpy()
            if x.dtype == np.uint32:
                x = x.view(np.int32)
            np.testing.assert_array_equal(y, x, err_msg=f)
    # a loaded map starts LOST in both
    s = TSystem(to_port(cfg), device="cpu")
    s.load_map(str(out / "jax_map.npz"))
    assert s.track_state.name == "LOST"
    assert s.tracker._n_kfs_host == 3


def test_evaluation_metrics_match():
    """ATE after Umeyama alignment (with and without scale) and RPE: the
    same numpy arithmetic in both packages, so equal to the last bit."""
    from dr_slam_tpu.io import metrics as jm
    from dr_slam_torch.io import metrics as tm

    rng = np.random.RandomState(9)
    gt = synthetic.loop_trajectory(40).astype(np.float64)
    gt_wc = np.linalg.inv(gt)
    est_wc = gt_wc.copy()
    est_wc[:, :3, 3] = (1.1 * est_wc[:, :3, 3]
                        + rng.normal(0, 0.02, (40, 3)))
    for scale in (False, True):
        for a, b in zip(tm.umeyama_alignment(est_wc[:, :3, 3],
                                             gt_wc[:, :3, 3], scale),
                        jm.umeyama_alignment(est_wc[:, :3, 3],
                                             gt_wc[:, :3, 3], scale)):
            np.testing.assert_array_equal(a, b)
        assert (tm.ate_rmse(est_wc[:, :3, 3], gt_wc[:, :3, 3],
                            with_scale=scale)
                == jm.ate_rmse(est_wc[:, :3, 3], gt_wc[:, :3, 3],
                               with_scale=scale))
    for delta in (1, 5):
        assert tm.rpe(est_wc, gt_wc, delta) == jm.rpe(est_wc, gt_wc, delta)


def test_drift_injection_matches(runs):
    """`inject_progressive_drift` on a Tracker of each package holding the
    corridor's map: every moved field within 1e-5 (float32 arithmetic of
    the same host code; the port writes it back to the device)."""
    from dr_slam_tpu.io import drift as jdrift
    from dr_slam_tpu.io.map_io import load_map as jload
    from dr_slam_tpu.slam.tracking import Tracker as JTracker
    from dr_slam_torch.io import drift as tdrift
    from dr_slam_torch.io.map_io import load_map as tload
    from dr_slam_torch.slam.tracking import Tracker as TTracker

    cfg, path = runs["cfg"], str(runs["out"] / "jax_map.npz")
    jt = JTracker(cfg)
    jt.map_state = jload(path, cfg)
    tt = TTracker(to_port(cfg), device="cpu")
    tt.map_state = tload(path, to_port(cfg), "cpu")
    poses = np.asarray(jt.map_state.kf_pose)
    for tr in (jt, tt):
        tr.kf_pose_host = {int(k): poses[k].copy() for k in
                           np.where(np.asarray(jt.map_state.kf_valid))[0]}
    np.testing.assert_array_equal(tdrift.drift_T(0.4), jdrift.drift_T(0.4))
    jdrift.inject_progressive_drift(jt)
    tdrift.inject_progressive_drift(tt)
    for f in ("kf_pose", "pt_pos", "pl_coef", "pl_cloud", "ln_ep", "ln_dir"):
        np.testing.assert_allclose(getattr(tt.map_state, f).numpy(),
                                   np.asarray(getattr(jt.map_state, f)),
                                   rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_allclose(tt.T_cw.numpy(), np.asarray(jt.T_cw), rtol=0,
                               atol=1e-5)
    assert tt.kf_pose_host.keys() == jt.kf_pose_host.keys()
    for k in jt.kf_pose_host:
        np.testing.assert_allclose(tt.kf_pose_host[k], jt.kf_pose_host[k],
                                   rtol=0, atol=1e-5)
    moved = np.abs(tt.map_state.kf_pose.numpy() - poses).max()
    assert moved > 1e-2


def test_system_needs_a_card_or_cpu():
    cfg = to_port(small_cfg())
    if torch.cuda.is_available():
        assert TSystem(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TSystem(cfg)
    for kw in ({"use_viewer": True}, {"live_viewer": True},
               {"detector": object()}):
        with pytest.raises(NotImplementedError, match="queue 1 item 12"):
            TSystem(cfg, device="cpu", **kw)
