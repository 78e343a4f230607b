"""Full-size parity of the port's DeviceLoopTracker: phase 7 of
chip_smoke.py on the CPU. The tum_freiburg3 preset (640x480) from an empty
map over the 24 frames of dr_slam_torch/data/mapping_corridor.npz as the
camera gives them (uint8 gray, uint16 depth), 2 black frames, then frames
6-11 again, against the JAX DeviceLoopTracker's records in
dr_slam_torch/data/device_loop_corridor.npz (made by
scripts/make_torch_device_loop_fixture.py), under the bounds phase 7 holds
the card to (dr_slam_torch/_smoke.py: `device_loop_gaps`). Observed on the
CPU: states, keyframes and reference keyframes exact, |dT_cw| 7.1e-4,
counts within 3. The JAX run had the shipped 4096-word codebook
registered, so the port's is registered too (`_smoke.shipped_codebooks`)."""

import pytest
import torch

from dr_slam_torch._smoke import (DEVICE_LOOP_FIXTURE, device_loop_gaps,
                                  expected_launches, load_mapping_fixture,
                                  load_npz, run_device_loop, shipped_codebooks)
from dr_slam_torch.config import tum_freiburg3

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tracked():
    data = load_npz(DEVICE_LOOP_FIXTURE)
    order = [int(i) for i in data["frame"]]
    with shipped_codebooks():
        yield run_device_loop(load_mapping_fixture(), order, tum_freiburg3(),
                              "cpu", capture=True), data


def test_device_loop_matches_the_jax_run(tracked):
    run, data = tracked
    gaps, fails = device_loop_gaps(run, data)
    assert not fails, (fails, gaps)
    states = run.flushed["states"]
    assert states == ["OK"] * 24 + ["LOST"] * 2 + ["OK"] * 6
    assert [n for n in range(32) if run.flushed["records"][n, 19]] == \
        [0, 10, 22]
    assert gaps["n_keyframes"] == 3


def test_relocalization_attempts_and_readbacks(tracked):
    """The first black frame rolls back (no attempt: the frame before it
    was good); the second attempts a relocalization and fails; the first
    frame back attempts one and is accepted."""
    run, _ = tracked
    tr = run.tracker
    assert [n for n, r in enumerate(tr.relocs) if r] == [25, 26]
    assert tr.readbacks == [1 + int(r) for r in tr.relocs]
    assert len(run.verify_calls) == 2        # one verify per attempt
    assert expected_launches(run.flushed["states"], tr.relocs) == \
        [0] + [2] * 24 + [3, 3] + [2] * 5
    assert run.launches == [0] * 32          # the CPU takes no kernel
