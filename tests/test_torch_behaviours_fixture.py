"""The port on the CPU against dr_slam_torch/data/behaviours.npz, the JAX
runs that `chip_smoke.py` phase 13 holds the card to
(scripts/make_torch_behaviours_fixture.py).

- Every forced eviction of the JAX runs into the keyframe capacity: the
  `System` and the `DeviceLoopTracker` over the wall at 640x480 (phase
  13a/13c), the `System` there with the culling pass on (13a), and over tests/test_long_run.py's own 70 frames at 320x240.
  JAX's map state before each, stored compressed to the fields
  `cull_one_keyframe` reads, goes through the port's
  `cull_one_keyframe(force=True)`, which must free JAX's slot.
- The office world with its relocalization (phase 13b) on the fixture's
  frames (JAX's renders rounded as a TUM camera gives them) against the
  JAX run on the same frames: states, keyframes, reference keyframes and
  every slot's insertion sequence exact, T_cw within 3e-3, inliers and
  live points within 2% (`_smoke.behaviour_gaps`), the relocalization at
  JAX's call, and the JAX tests' acceptance on the port's run."""

import pytest
import torch

from dr_slam_torch import _smoke
from dr_slam_torch.config import tum_freiburg3
from dr_slam_torch.slam.system import System

WALLS = {"ev_": tum_freiburg3, "dlev_": tum_freiburg3, "cev_": tum_freiburg3,
         "lrev_": _smoke.small_cfg, "lrdlev_": _smoke.small_cfg}


@pytest.mark.parametrize("prefix", sorted(WALLS))
def test_forced_evictions_from_jax_states(prefix):
    data = _smoke.load_behaviours_fixture()
    got, want, _ = _smoke.fixture_evictions(
        data, prefix, _smoke.wall_cfg(WALLS[prefix]()), "cpu")
    assert len(want) >= 5, want
    assert got == want


def test_office_on_fixture_frames():
    data = _smoke.load_behaviours_fixture()
    render, black = _smoke.office_fixture_frames(data)
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        p = _smoke.office_run(System(_smoke.office_cfg(),
                                     enable_loop_closing=False, device="cpu"),
                              render, black)
    finally:
        torch.set_num_threads(old)
    j = {k[len("office_"):]: v for k, v in data.items()
         if k.startswith("office_")}
    gaps, fails = _smoke.behaviour_gaps(j, p)
    assert not fails, (fails, gaps)
    assert int(p["reloc_call"]) == int(j["reloc_call"])
    acc = _smoke.office_acceptance(p, data["office_poses_cw"])
    assert acc["lost"] == 0 and acc["ate"] < _smoke.OFFICE_ATE_MAX, acc
    assert acc["blackout_lost"], acc
    assert acc["reloc_try"] in (0, 1), acc
    assert acc["reloc_err"] < _smoke.OFFICE_RELOC_MAX, acc
