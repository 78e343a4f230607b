"""The office mix on the CPU: the mix against the corridor's, the old cells'
checks of limits and configuration on the new cell, and a run of it at the
tests' small configuration.

    python -m pytest slam_bench/tests/test_office_cell.py -q"""

from __future__ import annotations

import json
import os

import pytest

from slam_bench import run
from slam_bench.tests import test_slam_bench_parts as parts
from slam_bench.tests.test_slam_bench_run import SECONDS, small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_office_is_the_corridor_with_clutter():
    mix = lambda name: json.load(open(os.path.join(
        ROOT, "slam_bench", "traffic", name + ".json")))
    office, corridor = mix("office"), mix("corridor")
    assert set(office) == set(corridor)
    assert {k for k in office if office[k] != corridor[k]} == {
        "what", "boxes_per_m"}
    assert office["boxes_per_m"] == 0.8


@pytest.mark.parametrize("check", [
    "test_lower_precision_controls_fail_the_limits",
    "test_planted_faults_fail_the_limits",
    "test_configuration_files_state_the_preset_that_runs"])
def test_office_takes_the_old_cells_checks(check):
    """The office cell's limits fail the bfloat16 control and the planted
    faults, and its files state the preset that runs, as the old cells'
    (`test_slam_bench_parts.py`, whose cells are the old two)."""
    getattr(parts, check)("tum3_slam.office")


def test_office_tracks_without_loss():
    import torch
    torch.set_num_threads(4)
    keep = {}
    out = run.run_cell(run.load_cell("tum3_slam.office"), 2**31 + 302,
                       SECONDS, False, device="cpu", cfg=small_cfg(),
                       keep=keep)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert keep["readings"]["step_mm"] < 30.0
