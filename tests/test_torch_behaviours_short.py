"""Two reference behaviours of the JAX package's end-to-end tests, each run
by the JAX `System` and the port's on the same numpy frames, the JAX
decision lagged by exactly one frame and each tracked rotation projected
onto SO(3) (the port's two rules, tests/torch_parity.py):

- translation-only tracking with the Manhattan-predicted rotation, 12
  corridor frames (tests/test_tracking_e2e.py:100);
- the reference-keyframe rescue: a 5 m velocity injected before frame 13,
  so the motion model projects the map outside the image
  (tests/test_tracking_e2e.py:127).

The third, the depth hole, is tests/test_torch_behaviours_hole.py (one
file would take more than 90 s on one worker).

Held in each: states, keyframes inserted per call, the reference keyframe
and every slot's insertion sequence exact; T_cw within 3e-3 per entry;
inliers and live points within 2% (`_smoke.behaviour_gaps`, the bounds of
the port's other System runs). And the JAX test's own acceptance on the
port's run: no frame LOST and ATE under 0.05 m (translation-only); the
rescued frame OK within 0.05 m of the truth."""

import dataclasses

import numpy as np
import pytest
import torch

from dr_slam_torch import _smoke
from dr_slam_torch.io.metrics import ate_rmse

from torch_parity import numpy_frames, run_both_systems, small_cfg


@pytest.fixture(autouse=True)
def _threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def _hold(j, p):
    gaps, fails = _smoke.behaviour_gaps(j, p)
    assert not fails, (fails, gaps)
    return gaps


def _corridor(cfg, n):
    from dr_slam_tpu.io import synthetic

    return synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(n, step=0.03), K4=cfg.camera.K4,
        height=240, width=320)


def test_translation_only_tracking():
    cfg0 = small_cfg()
    cfg = cfg0.replace(tracking=dataclasses.replace(
        cfg0.tracking, translation_only_with_manhattan=True))
    seq = _corridor(cfg, 12)
    j, p, _, _ = run_both_systems(cfg, numpy_frames(seq, 12))
    _hold(j, p)
    assert (p["state"] == 2).all()
    ate = ate_rmse(_smoke.centres(p["T_cw"]), _smoke.centres(seq.poses_cw))
    assert ate < 0.05, ate


def test_reference_keyframe_rescue():
    n = 14
    cfg = small_cfg()
    assert cfg.tracking.use_ref_kf_anchor
    seq = _corridor(cfg, n)
    bad = np.eye(4, dtype=np.float32)
    bad[:3, 3] = 5.0

    def collapse(i, js, ps):
        if i == n - 1:
            import jax.numpy as jnp

            js.tracker.velocity = jnp.asarray(bad)
            ps.tracker.velocity = torch.from_numpy(bad)

    j, p, _, _ = run_both_systems(cfg, numpy_frames(seq, n), before=collapse,
                                  flush_last=True)
    _hold(j, p)
    assert p["state"][-1] == 2                 # OK after the flush too
    T_gt = seq.poses_cw[n - 1] @ np.linalg.inv(seq.poses_cw[0])
    err = np.linalg.norm(p["T_cw"][-1][:3, 3] - T_gt[:3, 3])
    assert err < 0.05, err
