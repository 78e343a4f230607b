"""The port's main path as a whole: `extract_and_track`
(dr_slam_torch/slam/track_step.py) against the JAX package's, on the small
corridor of tests/test_tracking_e2e.py (320x240, 512 keypoints, 4096 map
points, 512 vocabulary words).

The JAX `System` tracks the first frames and builds the map; its state goes
into the port through `.npz` (the port's `load_map`) and directly
(`from_jax_state`), and both `extract_and_track` implementations then run
the next frames, each fed its own previous outputs. Match indices, counts,
plane and line associations, the visibility mask and the point statistics
must match exactly. Poses agree within 1e-5 and the float entries of the
per-frame bundle within 1e-4: the same float32 formulas with sums taken in
another order, through two 4 x 10 Gauss-Newton solves that contract."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.io import map_io as jio
from dr_slam_tpu.io import synthetic
from dr_slam_tpu.slam.track_step import extract_and_track as jax_track
from dr_slam_torch.io import map_io as tio
from dr_slam_torch.slam.track_step import extract_and_track as port_track

from torch_parity import small_cfg, to_port

torch.set_num_threads(2)

N_MAP = 6      # frames the JAX System tracks to build the map
N_CMP = 3      # frames both packages then track


@pytest.fixture(scope="module")
def tracked(tmp_path_factory):
    from dr_slam_tpu.slam.system import System

    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(N_MAP + N_CMP, step=0.03),
        K4=cfg.camera.K4, height=240, width=320)
    sysm = System(cfg, enable_loop_closing=False)
    for i in range(N_MAP):
        gray, depth = seq.render(i)
        sysm.track_rgbd(gray, depth, i / 30.0)
    sysm.tracker.flush()
    tr = sysm.tracker
    path = str(tmp_path_factory.mktemp("map") / "corridor.npz")
    jio.save_map(path, tr.map_state)
    start = dict(T=np.asarray(tr.T_cw, np.float32),
                 V=np.asarray(tr.velocity, np.float32),
                 R=np.asarray(tr.R_cm, np.float32), ref=int(tr.ref_kf))
    frames = [tuple(np.array(x, np.float32) for x in seq.render(i))
              for i in range(N_MAP, N_MAP + N_CMP)]

    # JAX: each frame fed the previous frame's outputs
    st, T, V, R = tr.map_state, *(jnp.asarray(start[k]) for k in "TVR")
    ref = jnp.asarray(start["ref"])
    jax_out = []
    for gray, depth in frames:
        _, out = jax_track(jnp.asarray(gray), jnp.asarray(depth), st, T, V, R,
                           ref, cfg)
        jax_out.append(out)
        st, T, V, R = out.new_map_state, out.T_cw, out.velocity, out.R_cm

    # the port, from the .npz the JAX package wrote
    tcfg = to_port(cfg)
    st = tio.load_map(path, tcfg, device="cpu")
    direct = tio.from_jax_state(
        {k: np.asarray(v) for k, v in tr.map_state._asdict().items()}, "cpu")
    T, V, R = (torch.from_numpy(start[k]) for k in "TVR")
    port_out = []
    for gray, depth in frames:
        _, out = port_track(gray, depth, st, T, V, R, start["ref"], tcfg,
                            device="cpu")
        port_out.append(out)
        st, T, V, R = out.new_map_state, out.T_cw, out.velocity, out.R_cm
    return sysm, st, direct, tio.load_map(path, tcfg, device="cpu"), \
        jax_out, port_out


def test_map_reaches_the_port_unchanged(tracked):
    sysm, _, direct, loaded, _, _ = tracked
    assert sysm.map_summary()["n_points"] > 200
    for f in loaded._fields:
        assert torch.equal(getattr(loaded, f), getattr(direct, f)), f


@pytest.mark.parametrize("frame", range(N_CMP))
def test_extract_and_track_matches_jax(tracked, frame):
    _, _, _, _, jax_out, port_out = tracked
    j, t = jax_out[frame], port_out[frame]
    assert int(t.n_matches) > 100
    for f in ("mp_idx", "n_matches", "n_inliers", "man_ok", "plane_match",
              "plane_par", "plane_ver", "line_match", "visible"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    for f in ("pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(t.new_map_state, f).numpy(),
                                      np.asarray(getattr(j.new_map_state, f)),
                                      err_msg=f)
    np.testing.assert_allclose(t.T_cw.numpy(), np.asarray(j.T_cw), atol=1e-5)
    np.testing.assert_allclose(t.velocity.numpy(), np.asarray(j.velocity),
                               atol=1e-5)
    np.testing.assert_allclose(t.R_cm.numpy(), np.asarray(j.R_cm), atol=1e-5)
    np.testing.assert_allclose(t.bundle.numpy(), np.asarray(j.bundle),
                               atol=1e-4)


def test_track_step_moves_the_pose(tracked):
    """The compared frames are real tracking: the camera advances along
    the corridor from frame to frame."""
    _, _, _, _, _, port_out = tracked
    c = [np.linalg.inv(o.T_cw.numpy())[:3, 3] for o in port_out]
    assert all(np.linalg.norm(b - a) > 0.01 for a, b in zip(c, c[1:]))
