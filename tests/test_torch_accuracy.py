"""The port's closed-loop accuracy protocol (`dr_slam_torch._smoke.
accuracy_run`, run by scripts/bench_accuracy_torch.py) on the CPU against
the JAX run stored in dr_slam_torch/data/accuracy_loop.npz (made by
scripts/make_torch_accuracy_fixture.py: scripts/bench_accuracy.py's
protocol with the JAX deferred decision lagging by exactly one frame and
each tracked rotation projected onto SO(3), the port's two rules). The JAX
protocol does not run here.

The port runs the first N_FRAMES = 125 frames once, in one test, so the
drift injection after frame 120 goes through `System` and four frames are
tracked after it: about 180 s at 4 threads on an otherwise idle 8-core
host. The whole protocol's 270 frames, on the port's own renders, run on
the card (`chip_smoke.py` phase 12).

The port's run is fed JAX's renders of the protocol's poses (3 s, where
the port renders its 125 frames in about 15 s): the port's own renders are
the same bits, held here on two frames and by tests/test_torch_synthetic.py.

Held over every frame of the run: states, keyframe flags, reference
keyframes, keyframes' frames and LOST frames (none) exact; T_cw within
3e-3 per entry and the inlier counts within 2% (phases 4-5's bounds: the
port's float32 solves sum in another order than XLA's);
rotations within 1e-5 of SO(3); no loop closed yet. The poses, the
trained codebook and the codebook in effect (the shipped vocab512.npz,
which `System.__init__` registers over the trained one in both packages)
are exact. The summary line from the fixture's trajectories is the JAX
run's line, rounding included."""

import json

import numpy as np
import pytest
import torch

from dr_slam_torch import _smoke

from torch_parity import JaxRenders as _JaxRenders

N_FRAMES = 125


def _orth_err(T):
    R = np.asarray(T, np.float64)[..., :3, :3]
    return np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max(axis=(-2, -1))


def _centres(Ts):
    return np.asarray([np.linalg.inv(np.asarray(T, np.float64))[:3, 3]
                       for T in Ts])


@pytest.fixture(scope="module")
def data():
    return _smoke.load_accuracy_fixture()


def test_poses_equal_fixture(data):
    poses = _smoke.accuracy_sequence("cpu").poses_cw
    assert poses.shape == (270, 4, 4) and poses.dtype == np.float32
    np.testing.assert_array_equal(poses.astype(np.float64), data["poses"])


@pytest.mark.parametrize("frame", [0, 120])
def test_port_renders_agree_with_jax(frame):
    seq = _JaxRenders("cpu")
    g, d = (x.numpy() for x in seq.port.render(frame))
    gj, dj = (x.numpy() for x in seq.render(frame))
    np.testing.assert_array_equal(g.view(np.int32), gj.view(np.int32))
    np.testing.assert_array_equal(d.view(np.int32), dj.view(np.int32))


def test_protocol_matches_jax_through_the_drift_injection(data):
    old = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(_smoke, "accuracy_sequence", _JaxRenders)
            run = _smoke.accuracy_run("cpu", frames=N_FRAMES)
    finally:
        torch.set_num_threads(old)
    rec, n = run.records, N_FRAMES

    np.testing.assert_array_equal(run.trained_words, data["vocab_trained"],
                                  err_msg="trained codebook")
    assert run.codebook == "shipped"
    np.testing.assert_array_equal(run.codebook_signs, data["codebook_signs"],
                                  err_msg="codebook in effect")
    assert not np.array_equal(data["vocab_trained"], data["vocab_in_effect"])

    for k in ("state", "is_keyframe", "ref_kf"):
        np.testing.assert_array_equal(rec[k], data[k][:n], err_msg=k)
    assert run.kf_frames == [int(f) for f in data["kf_frames"] if f < n]
    assert rec["state"].tolist() == [2] * n            # OK, none LOST
    dT = np.abs(rec["T_cw"] - data["T_cw"][:n]).max()
    assert dT < _smoke.TRACKER_T_TOL, ("T_cw", dT)
    ni, nj = rec["n_inliers"], data["n_inliers"][:n]
    assert np.all(np.abs(ni - nj) <= _smoke.TRACKER_COUNT_TOL * nj), \
        ("n_inliers", np.abs(ni - nj).max())
    assert _orth_err(rec["T_cw"]).max() < 1e-5, "rotations off SO(3)"
    # the live pose rides the injected twist (0.38 m)
    drift = _smoke.ACCURACY_DRIFT_FRAME
    c = _centres(rec["T_cw"][drift:drift + 2])
    assert np.linalg.norm(c[1] - c[0]) > 0.3, "drift not injected"
    assert run.summary["frames"] == n and run.loops == []
    assert run.kf_frames[-1] > drift


def test_summary_line_from_fixture_trajectories(data):
    from torch_parity import load_script

    line = load_script("bench_accuracy_torch").summary_line
    summary = _smoke.accuracy_summary(data["poses"], data["traj_raw"],
                                      data["traj_corrected"],
                                      len(data["loop_frame"]))
    assert line(summary) == json.loads(str(data["summary"]))
    assert summary["loops_closed"] >= 1
    assert summary["ate_rmse_m"] < summary["ate_rmse_raw_m"] - 0.02


def test_bench_script_needs_a_card_or_cpu():
    from torch_parity import load_script

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_script("bench_accuracy_torch").main([])
