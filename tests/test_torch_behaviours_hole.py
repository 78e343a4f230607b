"""The depth hole of tests/test_long_run.py:77, run by the JAX `System` and
the port's on the same numpy frames, the JAX decision lagged by exactly
one frame and each tracked rotation projected onto SO(3) (the port's two
rules, tests/torch_parity.py): a world-anchored hole in the far wall's
depth and 30 frames of lateral motion, so only epipolar triangulation can
put landmarks into it.

Held: states, keyframes inserted per call, the reference keyframe and every
slot's insertion sequence exact; T_cw within 3e-3 per entry; inliers and
live points within 2% (`_smoke.behaviour_gaps`). And the JAX test's own
acceptance on the port's run: no frame LOST and at least 5 landmarks
inside the hole."""

import dataclasses

import numpy as np
import torch

from dr_slam_torch import _smoke

from torch_parity import numpy_frames, run_both_systems, small_cfg

HOLE = dict(x0=1.4, x1=2.6, y0=1.0, y1=2.0)


def _hole_frames(cfg, n):
    from dr_slam_tpu.io import synthetic

    fx, fy, cx, cy = cfg.camera.K4
    poses = []
    for i in range(n):
        T_wc = np.eye(4)
        T_wc[:3, 3] = [1.0 + 0.05 * i, 1.5, 1.0]   # strafe along +x
        poses.append(np.linalg.inv(T_wc))
    poses = np.asarray(poses, np.float32)
    seq = synthetic.SyntheticSequence(poses, K4=cfg.camera.K4, height=240,
                                      width=320)
    frames = []
    for i, (g, d) in enumerate(numpy_frames(seq, n)):
        h, w = d.shape
        uu, vv = np.meshgrid(np.arange(w), np.arange(h))
        T_wc = np.linalg.inv(poses[i])
        pc = np.stack([(uu - cx) / fx * d, (vv - cy) / fy * d, d], -1)
        pw = pc @ T_wc[:3, :3].T + T_wc[:3, 3]
        hole = ((pw[..., 2] > 5.9) & (pw[..., 0] > HOLE["x0"])
                & (pw[..., 0] < HOLE["x1"]) & (pw[..., 1] > HOLE["y0"])
                & (pw[..., 1] < HOLE["y1"]))
        frames.append((g, np.where(hole, 0.0, d).astype(np.float32)))
    return poses, frames


def test_depth_hole_triangulation():
    cfg0 = small_cfg()
    cfg = cfg0.replace(tracking=dataclasses.replace(cfg0.tracking,
                                                    min_frames=4))
    poses, frames = _hole_frames(cfg, 30)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        j, p, _, ps = run_both_systems(cfg, frames)
    finally:
        torch.set_num_threads(old)
    gaps, fails = _smoke.behaviour_gaps(j, p)
    assert not fails, (fails, gaps)
    assert (p["state"] == 2).all()
    st = ps.tracker.map_state
    pos = st.pt_pos.numpy()[st.pt_valid.numpy()]
    Ti = np.linalg.inv(poses[0])   # SLAM world = camera-0 frame -> room
    room = pos @ Ti[:3, :3].T + Ti[:3, 3]
    inhole = ((room[:, 2] > 5.8)
              & (room[:, 0] > HOLE["x0"] + 0.1)
              & (room[:, 0] < HOLE["x1"] - 0.1)
              & (room[:, 1] > HOLE["y0"] + 0.1)
              & (room[:, 1] < HOLE["y1"] - 0.1))
    assert inhole.sum() >= 5, inhole.sum()
