"""The detector's cell on the CPU: the FLOP count of its yardstick, its four
readers on stand-in summaries (and left out, None, where there is nothing
to read), its configuration file against the preset that runs, the old
cells' checks of limits and configuration on it, and a traced run of it at
the tests' small configuration.

    python -m pytest slam_bench/tests/test_detector_cell.py -q"""

from __future__ import annotations

import json
import os

import pytest

from slam_bench import run, yolox_flops
from slam_bench.tests import test_slam_bench_parts as parts
from slam_bench.tests.test_slam_bench_run import SECONDS, small_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "tum3_yolox.corridor"
READERS = ("detect_ms", "detect_per_frame", "detect_syncs_per_frame",
           "detector_mfu_pct")


def _spec() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_flops_are_yolox_s_as_published():
    """26.8 G at 640 (arXiv:2107.08430), and the layout is the program's
    YOLOX-s, convolution for convolution."""
    from dr_slam_torch.models.yolox import init_params, params_to_state_dict

    assert yolox_flops.flops() == pytest.approx(26.8e9, rel=0.03)
    assert yolox_flops.flops(320) == pytest.approx(yolox_flops.flops() / 4)
    want = {k: tuple(v.shape) for k, v in
            params_to_state_dict(init_params()).items()
            if k.endswith(".weight")}
    got = {f"convs.{name}.weight": (o, i, k, k)
           for name, (o, i, k) in yolox_flops.layout().items()}
    assert got == want


def _span(total_ms: float, count: int, syncs: int = 0) -> dict:
    return {"count": count, "total_ms": total_ms, "syncs": syncs,
            "self_ms": total_ms, "parent": "track.call"}


def _records(**spans) -> dict:
    base = {"track.call": _span(1000.0, 4), "track.dispatch": _span(500.0, 4),
            "detect.launch": _span(48.0, 4), "detect.resolve": _span(8.0, 4,
                                                                     syncs=1),
            "detect.net": {"count": 3, "device_ms": 12.0, "pending": 1,
                           "syncs": 0}}
    base.update(spans)
    return {"spans": {k: v for k, v in base.items() if v is not None},
            "call_ms": [250.0] * 4, "frames": 4, "frames_window_s": 2.0,
            "keyframes": 0, "matcher": [], "device_ops": [], "window_s": 1.0}


def test_detector_readers_on_a_recorded_summary():
    rec = _records()
    want = {"detect_ms": (48.0 + 8.0) / 4, "detect_per_frame": 1.0,
            "detect_syncs_per_frame": 1 / 4,
            "detector_mfu_pct": 100.0 * yolox_flops.flops() * 3 / 12e-3
            / 67e12}
    for name, value in want.items():
        assert run.reader(name)(rec) == pytest.approx(value, rel=1e-9)
    # a detector on every second frame: the flag reads it
    half = _records(**{"detect.launch": _span(24.0, 2)})
    assert run.reader("detect_per_frame")(half) == 0.5


# what each reader reads where there is little to read: None (left out) or
# a number, for the three per-frame readers and the device-time share
SPARSE = {
    # a program with no per-frame detector: no `detect.*` span
    "no detector": ({k: None for k in ("detect.launch", "detect.resolve",
                                       "detect.net")}, (None, None)),
    # a window with no frame: nothing per frame; the share is per network
    "no frame": ({"track.call": None}, (None, float)),
    # no network done yet when the summary was read
    "none done": ({"detect.net": {"count": 0, "device_ms": 0.0, "pending": 4,
                                  "syncs": 0}}, (float, None)),
}


@pytest.mark.parametrize("name", READERS)
@pytest.mark.parametrize("case", sorted(SPARSE))
def test_detector_readers_with_little_to_read(name, case):
    """The metric is left out, never 0, where its reader has nothing to
    read."""
    spans, (per_frame, share) = SPARSE[case]
    want = share if name == "detector_mfu_pct" else per_frame
    got = run.reader(name)(_records(**spans))
    assert got is None if want is None else isinstance(got, want)


def test_detector_metrics_are_the_detectors_layer():
    mine = {m["name"]: m for m in _spec()["per_layer"]
            if m["name"] in READERS}
    assert sorted(mine) == sorted(READERS)
    for m in mine.values():
        assert (m["layer"], m["moves"], m["workloads"]) == (
            "detector", "setup_s", [CELL])


def test_configuration_states_the_presets_detector():
    """`run.check_config` compares the camera, ORB and map groups only: the
    detector group is held to the preset here, field by field, and is
    YOLOX-s as published."""
    import dataclasses

    conf = run.load_cell(CELL)["config"]
    det = run.make_config(conf).detector
    fields = {f.name for f in dataclasses.fields(det)} - {"weights"}
    assert set(conf["detector"]) == fields
    for key, value in conf["detector"].items():
        assert getattr(det, key) == value, key
    assert det.weights is None
    assert (det.depth_mul, det.width_mul, det.input_size) == (0.33, 0.5, 640)
    assert run.load_cell(CELL)["traffic"] == run.load_cell(
        "tum3_slam.corridor")["traffic"]


@pytest.mark.parametrize("check", [
    "test_lower_precision_controls_fail_the_limits",
    "test_planted_faults_fail_the_limits",
    "test_configuration_files_state_the_preset_that_runs"])
def test_detector_cell_takes_the_old_cells_checks(check):
    """The cell's limits fail the bfloat16 control and the planted faults,
    and its file states the preset that runs, as the old cells'."""
    getattr(parts, check)(CELL)


def test_detector_cell_traced_on_the_cpu():
    """At the tests' small camera with the detector at input 128: every
    frame detected, no LOST frame, the host-side readers read and the
    device-time share left out (no CUDA events on the CPU)."""
    import torch
    from dr_slam_torch.config import DetectorConfig

    torch.set_num_threads(4)
    cfg = small_cfg().replace(detector=DetectorConfig(input_size=128))
    out = run.run_cell(run.load_cell(CELL), 2**31 + 402, SECONDS, True,
                       device="cpu", cfg=cfg)
    assert out["attempted"] >= 1 and out["failed"] == 0
    m = out["metrics"]
    assert m["detect_per_frame"]["value"] == 1.0
    assert m["detect_ms"]["value"] > 0
    assert m["detect_syncs_per_frame"]["value"] == 0.0
    assert "detector_mfu_pct" not in m
