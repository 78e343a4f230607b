"""The office world of tests/test_transfer_validation.py:28-100, run by the
JAX `System` and the port's on the same numpy frames (JAX's renders), the
JAX decision lagged by exactly one frame and each tracked rotation
projected onto SO(3) (the port's two rules, tests/torch_parity.py): the box
room with wall-seated clutter, other intrinsics (fx 262, fy 258, cx 157,
cy 118) and quadratic depth noise, 40 frames, three black frames that put
the tracker LOST, then frame 20 again until it relocalizes
(`_smoke.office_run`).

Held over every call: states (LOST included), keyframes inserted, the
reference keyframe and every slot's insertion sequence exact; T_cw within
3e-3 per entry; inliers and live points within 2%
(`_smoke.behaviour_gaps`). And the JAX tests' own acceptance on the port's
run: no frame of the 40 LOST and ATE under 0.08 m, LOST after the
blackout, and the relocalization OK on the first or second try within
0.10 m of the truth. The same scenario runs on the card in `chip_smoke.py`
phase 13b (and on the CPU in tests/test_torch_behaviours_fixture.py) on
dr_slam_torch/data/behaviours.npz's frames, JAX's renders rounded as a TUM
camera gives them; this test holds those frames to JAX's renders here.

On those frames the card's count of frame 1's inliers, the first tracked
frame's, lies over 2% from JAX's (phase 13b holds it from the port on the
CPU). `test_first_tracked_frame_from_jax_state` is the witness: from JAX's
state after frame 0, the port's step of frame 1 gives JAX's pose within
3e-3 and JAX's counts within 2%."""

import numpy as np
import torch

from dr_slam_torch import _smoke

from torch_parity import (jax_office_sequence, jax_system_lagged_by_one,
                          load_script, projected_tracked_pose, small_cfg,
                          state_to_port, tensor, to_port)


def test_office_relocalization_matches_jax():
    from dr_slam_tpu.slam.system import System
    from dr_slam_torch.slam.system import System as TSystem

    cfg = _smoke.office_cfg(small_cfg())
    assert to_port(cfg) == _smoke.office_cfg()
    seq = jax_office_sequence()
    frames = {}

    def render(i):
        if i not in frames:
            frames[i] = tuple(np.asarray(x, np.float32) for x in seq.render(i))
        return frames[i]

    black = (np.zeros((240, 320), np.float32),) * 2
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with projected_tracked_pose(), jax_system_lagged_by_one():
            j = _smoke.office_run(System(cfg, enable_loop_closing=False),
                                  render, black)
            p = _smoke.office_run(
                TSystem(to_port(cfg), enable_loop_closing=False,
                        device="cpu"), render, black)
    finally:
        torch.set_num_threads(old)

    gaps, fails = _smoke.behaviour_gaps(j, p)
    assert not fails, (fails, gaps)
    assert int(p["reloc_call"]) == int(j["reloc_call"])
    acc = _smoke.office_acceptance(p, seq.poses_cw)
    assert acc["lost"] == 0 and acc["ate"] < _smoke.OFFICE_ATE_MAX, acc
    assert acc["blackout_lost"], acc
    assert acc["reloc_try"] in (0, 1), acc
    assert acc["reloc_err"] < _smoke.OFFICE_RELOC_MAX, acc
    # the fixture's frames, which phase 13b feeds the card, are these renders
    fx = _smoke.load_behaviours_fixture()
    want = load_script("make_torch_behaviours_fixture").office_frames(cfg,
                                                                      seq)
    for k, v in want.items():
        np.testing.assert_array_equal(fx[k], v, err_msg=k)


def test_first_tracked_frame_from_jax_state():
    """Frame 1 of the fixture's office frames through each package's
    `extract_and_track` from the JAX `System`'s state after frame 0."""
    from dr_slam_torch.slam import track_step as tts
    from dr_slam_tpu.slam import track_step as jts
    from dr_slam_tpu.slam.system import System

    cfg = _smoke.office_cfg(small_cfg())
    render, _ = _smoke.office_fixture_frames(
        _smoke.load_behaviours_fixture())
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with projected_tracked_pose(), jax_system_lagged_by_one():
            tr = System(cfg, enable_loop_closing=False).tracker
            tr.process_frame(*render(0), 0.0)
            _, jo = jts.extract_and_track(*render(1), tr.map_state, tr.T_cw,
                                          tr.velocity, tr.R_cm, tr.ref_kf,
                                          cfg)
            _, po = tts.extract_and_track(
                *render(1), state_to_port(tr.map_state), tensor(tr.T_cw),
                tensor(tr.velocity), tensor(tr.R_cm),
                torch.as_tensor(tr.ref_kf), to_port(cfg), device="cpu")
    finally:
        torch.set_num_threads(old)
    dT = np.abs(po.T_cw.numpy() - np.asarray(jo.T_cw)).max()
    assert dT < _smoke.TRACKER_T_TOL, dT
    for k in ("n_inliers", "n_matches"):
        want = int(np.asarray(getattr(jo, k)))
        got = int(getattr(po, k))
        assert abs(got - want) <= _smoke.TRACKER_COUNT_TOL * want, (k, got,
                                                                    want)
