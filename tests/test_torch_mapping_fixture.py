"""Full-size parity of the port's Tracker: the 24 frames of the mapping
fixture (dr_slam_torch/data/mapping_corridor.npz, 640x480, the
tum_freiburg3 preset) from an empty map in the default deferred mode, on
the CPU, against the JAX tracker's outputs stored there, under the bounds
that chip_smoke.py's phase 4 holds the card to (dr_slam_torch/_smoke.py:
`tracker_gaps`, whose comment gives their causes). The JAX tracker was a
`System`'s, which registers the shipped codebook, so the port's is
registered too (`_smoke.shipped_codebooks`)."""

import pytest
import torch

from dr_slam_torch._smoke import (load_mapping_fixture, run_tracker,
                                  shipped_codebooks, tracker_gaps)
from dr_slam_torch.config import tum_freiburg3

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def tracked():
    data = load_mapping_fixture()
    with shipped_codebooks():
        yield run_tracker(data, tum_freiburg3(), "cpu"), data


def test_tracker_builds_the_jax_map(tracked):
    run, data = tracked
    gaps, fails = tracker_gaps(run, data)
    assert not fails, (fails, gaps)
    assert gaps["kf_frames"] == [0, 10, 22]
    assert gaps["n_kfs"] == 3


def test_tracker_runs_the_local_mapping_pass(tracked):
    """Two local-mapping passes ran and the map grew with them."""
    run, data = tracked
    assert len(run.tracker.kf_log) == 3
    assert int(run.tracker.map_state.n_pts) > int(data["n_pts"]) // 2 > 300
    assert run.launches == [0] * len(run.results)   # the CPU takes no kernel
