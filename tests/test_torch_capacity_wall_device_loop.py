"""The capacity wall in the device-resident loop: the port's
`DeviceLoopTracker` against the JAX one over tests/test_long_run.py's
scenario (12 keyframe slots, a keyframe forced every 4 frames), on the same
numpy frames, the shipped codebooks registered and each tracked rotation
projected onto SO(3) in both.

The port reads the wall on the host (`slam/device_loop.py`: `at_wall`, one
extra readback on a wall step); JAX evicts under `lax.cond` and tests
`sum(kf_valid)` after it on every frame. Over the 70 frames the two loops
part at step 48, the fifth forced eviction, for the reason
tests/test_torch_capacity_wall.py pins in the `Tracker`: float order in the
local bundle adjustment (scripts/parity_wall_torch.py prints both runs).

Held here: the port's loop from JAX's carry before step 48
(`torch_parity.carry_to_port`) over steps 48-51, two wall steps among them.
States, keyframe flags, reference keyframe slots and their insertion
sequences exact, every slot's insertion sequence exact after each step,
T_cw within 3e-3; the live keyframe count before each step equal to JAX's,
and two readbacks exactly on the steps where JAX's `sum(kf_valid)` test
sends a wanted keyframe into the wall."""

import numpy as np
import torch

from dr_slam_torch import _smoke
from dr_slam_torch._smoke import DEVICE_LOOP_EXACT
from dr_slam_torch.slam.device_loop import DeviceLoopTracker

from torch_parity import (carry_arrays, carry_to_port, jax_wall_sequence,
                          numpy_frames, projected_tracked_pose,
                          shipped_codebooks, small_cfg, to_port)

CARRY = 48          # JAX's carry before this step goes into the port
LAST = 51           # through the next wall step
T_TOL = _smoke.TRACKER_T_TOL


def _run():
    """JAX's loop over steps 0..LAST, and the port's from JAX's carry
    before step CARRY."""
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker

    cfg = _smoke.wall_cfg(small_cfg())
    frames = numpy_frames(jax_wall_sequence(cfg, LAST + 1), LAST + 1)
    with shipped_codebooks(), projected_tracked_pose():
        jt = JTracker(cfg)
        jn, jseq, carried = [], [], None
        for i, (g, d) in enumerate(frames):
            if i == CARRY:
                carried = carry_arrays(jt.carry)
            jn.append(int(np.asarray(jt.carry.map_state.kf_valid).sum()))
            jt.track(g, d, i / 30.0)
            jseq.append(np.asarray(jt.carry.map_state.kf_seq))
        pt = DeviceLoopTracker(to_port(cfg), device="cpu")
        pt.carry = carry_to_port(carried)
        pt._initialized = True
        pn, pseq = [], []
        for i in range(CARRY, LAST + 1):
            pn.append(int(pt.carry.map_state.kf_valid.sum()))
            pt.track(*frames[i], i / 30.0)
            pseq.append(pt.carry.map_state.kf_seq.numpy().copy())
        return dict(cfg=cfg, jrec=jt.flush()["records"], jn=jn, jseq=jseq,
                    prec=pt.flush()["records"], pn=pn, pseq=pseq,
                    reads=pt.readbacks)


def test_wall_steps_from_jax_carry():
    """The steps from JAX's carry; then the wall branch: the live count
    before each step is JAX's, and the port takes its wall branch (two
    readbacks) exactly where JAX's test does, a wanted keyframe with every
    slot but one live."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        loops = _run()
    finally:
        torch.set_num_threads(old)
    a, b = loops["jrec"][CARRY:], loops["prec"]
    for k, name in DEVICE_LOOP_EXACT.items():
        np.testing.assert_array_equal(b[:, k], a[:, k], err_msg=name)
    for i, (s, t) in enumerate(zip(loops["jseq"][CARRY:], loops["pseq"])):
        np.testing.assert_array_equal(t, s,
                                      err_msg=f"kf_seq, step {CARRY + i}")
    assert np.abs(b[:, :16] - a[:, :16]).max() < T_TOL
    assert (b[:, 16] == 0).all()              # OK throughout

    nk = loops["cfg"].map.max_keyframes
    jn = loops["jn"][CARRY:]
    assert loops["pn"] == jn, "live keyframes before each step"
    wall = [int(n >= nk - 1 and r[19] > 0.5) for n, r in zip(jn, a)]
    assert sum(wall) == 2, "wall steps"
    assert loops["reads"] == [1 + w for w in wall], "readbacks per step"
    # before the carry the map filled up: JAX at the wall from step 36 on
    assert min(loops["jn"][36:]) == nk - 1 > max(loops["jn"][:30])
