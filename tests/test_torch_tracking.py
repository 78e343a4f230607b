"""The slice as a whole: the port's `Tracker` against the JAX `System`'s
tracker over the 25-frame corridor of tests/test_tracking_e2e.py, from an
empty map, in synchronous and in the default deferred mode. Both trackers
use the shipped 512-word vocabulary (the JAX one through `System`, which
registers it; the port's `Tracker` through `torch_parity.shipped_codebooks`:
unregistered it takes the seeded random codebook). After each frame the JAX
test waits for the pending bundles, so the deferred decision lags by exactly
one frame in both.

Per-frame states, keyframe flags, inlier and match counts, the keyframe
frames and the final map's integer tables must match exactly. Poses agree
within 2e-3 (observed 6e-4) and the map's float fields within the bounds
below: each keyframe's local bundle adjustment is float32 conjugate
gradients whose sums run in another order (tests/test_torch_ba.py), and
tracking carries its result forward. After the last frame a black frame
makes both trackers LOST with the same pose, and on the next frame both
relocalize into the same keyframe, at poses within 2e-3."""

import jax
import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_torch.slam.tracking import Tracker

from torch_parity import (assert_states_match, shipped_codebooks, small_cfg,
                          to_port)

torch.set_num_threads(2)

N = 25
T_TOL = 2e-3
# the map's float fields: poses and landmarks move with the BA, and what a
# keyframe inserts after it is placed with the moved pose (observed 3.1e-4
# on keyframe poses, 2.4e-3 on points, 7.3e-3 on plane coefficients, 1.1e-4
# on plane clouds, 8.9e-3 on line endpoints, 8.2e-4 on observed 2D lines,
# 5.3e-4 on scale bands); the rest agrees within 1e-4 (observed <= 4.3e-5)
MAP_TOL = {"kf_pose": 2e-3, "pt_pos": 1e-2, "pl_coef": 3e-2, "pl_cloud": 1e-3,
           "ln_ep": 3e-2, "kf_ln_obs": 3e-3, "pt_dist_min": 2e-3,
           "pt_dist_max": 2e-3}


def _host(T):
    return T.numpy() if isinstance(T, torch.Tensor) else np.asarray(T)


@pytest.fixture(scope="module", params=["sync", "deferred"])
def runs(request):
    from dr_slam_tpu.slam.system import System

    cfg = small_cfg(deferred=request.param == "deferred")
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(N, step=0.03), K4=cfg.camera.K4,
        height=240, width=320)
    frames = [tuple(np.asarray(x, np.float32) for x in seq.render(i))
              for i in range(N)]
    with shipped_codebooks():
        jt = System(cfg, enable_loop_closing=False).tracker
        pt = Tracker(to_port(cfg), device="cpu")
        jres, pres = [], []
        for i, (gray, depth) in enumerate(frames):
            jres.append(jt.process_frame(gray, depth, i / 30.0))
            for entry in jt._pending:
                jax.block_until_ready(entry[2].bundle)
            pres.append(pt.process_frame(gray, depth, i / 30.0))
        jt.flush()
        pt.flush()
        final = (jt.map_state, pt.map_state, jt.corrected_trajectory(),
                 pt.corrected_trajectory(), list(jt.kf_log), list(pt.kf_log))
        # a black frame: no features, both trackers go LOST
        black = np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1])
        jb = jt.process_frame(*black, N / 30.0)
        pb = pt.process_frame(*black, N / 30.0)
        jt.flush()
        pt.flush()
        yield dict(jres=jres, pres=pres, final=final, black=(jb, pb),
                   lost=(jt, pt), next_frame=frames[-1])


def test_states_counts_and_keyframes_exact(runs):
    for i, (j, t) in enumerate(zip(runs["jres"], runs["pres"])):
        got = (t.state.name, t.is_keyframe, t.n_inliers, t.n_matches,
               t.manhattan_ok)
        want = (j.state.name, j.is_keyframe, j.n_inliers, j.n_matches,
                j.manhattan_ok)
        assert got == want, (i, got, want)
    assert all(r.state.name == "OK" for r in runs["pres"])
    jlog, plog = runs["final"][4], runs["final"][5]
    kfs = [round(ts * 30) for ts, _ in plog]
    assert kfs == [round(ts * 30) for ts, _ in jlog]
    assert kfs == [0, 10, 20]


def test_poses_within_bound(runs):
    for i, (j, t) in enumerate(zip(runs["jres"], runs["pres"])):
        np.testing.assert_allclose(_host(t.T_cw), np.asarray(j.T_cw),
                                   rtol=0, atol=T_TOL, err_msg=f"frame {i}")
    _, _, jc, pc, jlog, plog = runs["final"]
    assert len(pc) == len(jc) == N
    for (tj, Tj), (tp, Tp) in zip(jc, pc):
        assert tj == tp
        np.testing.assert_allclose(Tp, np.asarray(Tj), rtol=0, atol=T_TOL)
    for (_, Tj), (_, Tp) in zip(jlog, plog):
        np.testing.assert_allclose(Tp, Tj, rtol=0, atol=T_TOL)


def test_final_map_matches(runs):
    jst, tst = runs["final"][:2]
    assert int(tst.n_kfs) == int(jst.n_kfs) == 3
    assert int(tst.n_pts) == int(jst.n_pts)
    assert int(tst.n_pts) > 400
    np.testing.assert_array_equal(tst.kf_mp.numpy(), np.asarray(jst.kf_mp))
    assert_states_match(jst, tst, 1e-4,
                        [f for f in jst._fields if f not in MAP_TOL])
    for f, tol in MAP_TOL.items():
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=0,
                                   atol=tol, err_msg=f)


def test_black_frame_is_lost_in_both(runs):
    jt, pt = runs["lost"]
    assert jt.state.name == pt.state.name == "LOST"
    np.testing.assert_allclose(_host(pt.T_cw), np.asarray(jt.T_cw), rtol=0,
                               atol=T_TOL)
    jb, pb = runs["black"]
    assert (pb.state.name, pb.n_inliers) == (jb.state.name, jb.n_inliers)


def test_next_frame_relocalizes_in_both(runs):
    """After the black frame both trackers relocalize on the next frame:
    OK, into the same reference keyframe, at the same pose."""
    jt, pt = runs["lost"]
    frame = runs["next_frame"]
    jr = jt.process_frame(*frame, (N + 1) / 30.0)
    pr = pt.process_frame(*frame, (N + 1) / 30.0)
    assert jr.state.name == pr.state.name == "OK"
    assert pt.ref_kf == jt.ref_kf
    assert (pr.n_inliers, pr.n_matches) == (jr.n_inliers, jr.n_matches)
    np.testing.assert_allclose(_host(pr.T_cw), np.asarray(jr.T_cw), rtol=0,
                               atol=T_TOL)
