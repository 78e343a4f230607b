"""Recovery and the frozen map: the port's `DeviceLoopTracker` against the
JAX one in the teleport and localization-only scenarios of
tests/test_device_loop.py, on the CPU.

Teleport: the 36-frame corridor, four blank frames (no depth, no
texture), then frames 6-11 again. Both go LOST on the first blank frame,
attempt `_reloc_attempt` on every later bad frame (the blank ones fail)
and relocalize into the map on the first frame back; states, keyframe
flags and reference keyframes are exact, and the relocalized poses land on
the mapping-phase estimates. Localization-only: a tracker on the map after
frames 0-15 (the same map as a 16-frame run: the corridor does not depend
on its length) tracks frames 4-11 with the map frozen; states are exact and
the port's map is bit-identical before and after. Poses within 4e-3, the
bound of tests/test_torch_device_loop.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.io.metrics import ate_rmse
from dr_slam_torch.slam.device_loop import DeviceLoopTracker

from torch_parity import shipped_codebooks, small_cfg, to_port

torch.set_num_threads(2)

N = 36
N_BLANK = 4
BACK = 6
N_MAP = 16          # frames of the localization-only map
T_TOL = 4e-3
EXACT = {16: "state", 19: "is_kf", 20: "ref_kf", 21: "ref_seq"}


@pytest.fixture(scope="module")
def runs():
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker

    cfg = small_cfg()
    poses = synthetic.corridor_trajectory(N)
    seq = synthetic.SyntheticSequence(poses, K4=cfg.camera.K4, height=240,
                                      width=320)
    frames = [tuple(np.asarray(x) for x in seq.render(i)) for i in range(N)]
    blank = np.zeros((240, 320), np.float32)
    order = (list(range(N)) + [-1] * N_BLANK
             + list(range(BACK, BACK + 6)))
    with shipped_codebooks():
        jt = JTracker(cfg)
        pt = DeviceLoopTracker(to_port(cfg), device="cpu")
        snap = None
        for n, i in enumerate(order):
            g, d = frames[i] if i >= 0 else (blank, blank)
            jt.track(g, d, n / 30.0)
            pt.track(g, d, n / 30.0)
            if n == N_MAP - 1:
                # the JAX step donates its carry: copy the map out now
                snap = ([np.asarray(x) for x in
                         jax.tree_util.tree_leaves(jt.map_state)],
                        pt.map_state)
        yield dict(cfg=cfg, poses=poses, frames=frames, jax=jt, port=pt,
                   snap=snap)


def test_teleport_states_exact(runs):
    jf, pf = runs["jax"].flush(), runs["port"].flush()
    assert pf["states"] == jf["states"]
    for k, name in EXACT.items():
        np.testing.assert_array_equal(pf["records"][:, k], jf["records"][:, k],
                                      err_msg=name)
    states = pf["states"]
    assert states[:N] == ["OK"] * N
    assert "LOST" in states[N:N + N_BLANK + 1], states[N:]
    assert states[-1] == "OK", states[N:]


def test_teleport_relocalizes_into_the_map(runs):
    """Relocalization is attempted on every bad frame after a lost one;
    the first frame back is accepted, and from it on the estimate lands
    on the mapping-phase estimate of the same physical pose."""
    pt = runs["port"]
    pf, jf = pt.flush(), runs["jax"].flush()
    states = pf["states"]
    lost_before = [False] + [s == "LOST" for s in states[:-1]]
    assert pt.relocs[:N + 1] == [False] * (N + 1)
    assert pt.relocs[N + 1:N + N_BLANK + 1] == lost_before[N + 1:N + N_BLANK + 1]
    assert all(pt.relocs[N + 1:N + N_BLANK + 1])
    back = N + N_BLANK
    assert pt.relocs[back] and states[back] == "OK"
    # readbacks: one per tracked frame, one more per relocalization attempt
    assert pt.readbacks == [1 + int(r) for r in pt.relocs]
    np.testing.assert_allclose(pf["records"][back:, :16],
                               jf["records"][back:, :16], rtol=0, atol=T_TOL)
    est_map = np.linalg.inv(pf["trajectory"][BACK + 5][1])[:3, 3]
    est_last = np.linalg.inv(pf["trajectory"][-1][1])[:3, 3]
    assert np.linalg.norm(est_last - est_map) < 0.10, (est_last, est_map)


def test_localization_only_freezes_the_map(runs):
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker
    from dr_slam_tpu.slam.state import MapState as JMapState

    cfg = runs["cfg"]
    jleaves, pst0 = runs["snap"]
    before = {k: v.clone() for k, v in pst0._asdict().items()}
    jloc = JTracker(cfg, map_state=JMapState(*[jnp.asarray(x)
                                               for x in jleaves]),
                    localization_only=True)
    ploc = DeviceLoopTracker(to_port(cfg), map_state=pst0,
                             localization_only=True, device="cpu")
    for i in range(4, 12):
        g, d = runs["frames"][i]
        jloc.track(g, d, i / 30.0)
        ploc.track(g, d, i / 30.0)
    jf, pf = jloc.flush(), ploc.flush()
    assert pf["states"] == jf["states"] == ["OK"] * 8
    for k, name in EXACT.items():
        np.testing.assert_array_equal(pf["records"][:, k], jf["records"][:, k],
                                      err_msg=name)
    np.testing.assert_allclose(pf["records"][:, :16], jf["records"][:, :16],
                               rtol=0, atol=T_TOL)
    for k, v in ploc.map_state._asdict().items():
        assert torch.equal(v, before[k]), k
    # no init gate on a frozen map: one readback per frame
    assert ploc.readbacks == [1] * 8
    gt = np.asarray([np.linalg.inv(p)[:3, 3] for p in runs["poses"][4:12]])
    est = np.asarray([np.linalg.inv(T)[:3, 3] for _, T in pf["trajectory"]])
    assert ate_rmse(est, gt) < 0.05
