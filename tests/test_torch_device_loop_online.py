"""Online loop closing in the device loop: the port's
`DeviceLoopTracker.loop_closing_epoch` on the JAX carry stored just before
the firing epoch of tests/test_device_loop.py's online scenario
(dr_slam_torch/data/device_loop_online.npz, made by
scripts/make_torch_device_loop_online_fixture.py: 145 frames of the drifted
loop, with the trained codebook registered), on the CPU.

The carry loads through tests/torch_parity.py: carry_to_port, the loop
closer starts from the JAX one's state, and the port's registry holds the
trained codebook. The loop fires as JAX's did; the carry is re-seated on the
corrected reference keyframe (velocity identity, Manhattan rotation from
the corrected pose); the corrected map's integer tables are exact and its
poses and landmarks within the loop fixture's global-BA bounds
(dr_slam_torch/_smoke.py: LOOP_GBA_TOL), since the epoch runs the global BA
synchronously."""

import os

import numpy as np
import pytest
import torch

from dr_slam_torch._smoke import LOOP_GBA_TOL, load_npz, loop_closer
from dr_slam_torch.associate import vocabulary as tvoc
from dr_slam_torch.slam.device_loop import DeviceLoopTracker
from dr_slam_torch.slam.loop_closing import LoopCloser

from torch_parity import carry_to_port, loop_cfg, to_port

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "dr_slam_torch", "data", "device_loop_online.npz")
# the re-seated pose and Manhattan rotation (observed 3.0e-4 and 1.2e-4;
# the corrected keyframe poses 1.4e-3, points 8.3e-4, plane coefficients
# 1.4e-4, line endpoints 5.1e-4)
T_TOL = 2e-3


@pytest.fixture(scope="module")
def epoch():
    data = load_npz(FIXTURE)
    cfg = to_port(loop_cfg())
    W = cfg.map.vocab_words
    saved = tvoc._trained_signs.get(W)
    tvoc.set_vocabulary(data["words"])
    try:
        tr = DeviceLoopTracker(cfg, device="cpu")
        tr.carry = carry_to_port(data, "in__")
        lc = loop_closer(LoopCloser, cfg, dict(
            consistency={int(k): int(v) for k, v in data["in__consistency"]},
            last_fire_seq=int(data["in__last_fire_seq"]),
            accepted_loops=[(int(a), int(b), T) for (a, b), T in zip(
                data["in__loops_seq"], data["in__loops_T"])]),
            gba_async=False, device="cpu")
        fired = tr.loop_closing_epoch(lc)
        yield data, tr, lc, fired
    finally:
        tvoc._trained_signs.pop(W, None)
        if saved is not None:
            tvoc._trained_signs[W] = saved
        tvoc.get_codebook_signs.cache_clear()
        tvoc._codebook.cache_clear()


def test_carry_loads_bit_for_bit():
    data = load_npz(FIXTURE)
    c = carry_to_port(data, "in__")
    assert c.ref_kf.dtype == torch.int64 and c.lost.dtype == torch.bool
    assert int(c.frame_id) == int(data["fire_frame"]) + 1
    for f, v in c.map_state._asdict().items():
        want = data[f"in__map__{f}"]
        got = v.numpy()
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        np.testing.assert_array_equal(got, want, err_msg=f)
    np.testing.assert_array_equal(c.T_cw.numpy(), data["in__T_cw"])


def test_the_loop_fires(epoch):
    data, tr, lc, fired = epoch
    assert fired
    assert len(lc._accepted_loops) == len(data["in__loops_seq"]) + 1
    assert [(a, b) for a, b, _ in lc._accepted_loops] == [
        tuple(int(v) for v in x) for x in data["out__loops_seq"]]
    assert tr._loop_closer is None      # the given closer was used


def test_carry_reseated_on_the_corrected_keyframe(epoch):
    data, tr, _, _ = epoch
    c = tr.carry
    ref = int(c.ref_kf)
    assert ref == int(data["out__ref_kf"])
    np.testing.assert_array_equal(c.T_cw.numpy(),
                                  c.map_state.kf_pose[ref].numpy())
    np.testing.assert_allclose(c.T_cw.numpy(), data["out__T_cw"], rtol=0,
                               atol=T_TOL)
    np.testing.assert_allclose(c.R_cm.numpy(), data["out__R_cm"], rtol=0,
                               atol=T_TOL)
    np.testing.assert_array_equal(c.velocity.numpy(), np.eye(4))
    # the pose moved: the correction is not a no-op
    assert np.abs(c.T_cw.numpy() - data["in__T_cw"]).max() > 1e-2


def test_corrected_map_within_the_loop_bounds(epoch):
    data, tr, _, _ = epoch
    st = tr.carry.map_state
    for f in ("pt_valid", "kf_valid", "kf_mp", "kf_seq"):
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      data[f"out__map__{f}"], err_msg=f)
    for f, tol in LOOP_GBA_TOL.items():
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   data[f"out__map__{f}"], rtol=0, atol=tol,
                                   err_msg=f)
    moved = np.abs(data["out__map__kf_pose"] - data["in__map__kf_pose"]).max()
    assert moved > 1e-2
