"""The harness's parts on the CPU, without the program: the frame generator,
the reference, the metric readers, the module check, the refusal without a
card, and the lower-precision controls against the cells' limits.

    python -m pytest slam_bench/tests -q"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from slam_bench import control, frames, reference, run, trace
from slam_bench.tests import cells
from slam_bench.tests.cells import CELLS
from slam_bench.roofline import matcher_bound_ms

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("module", ["frames", "reference", "roofline",
                                    "trace"])
def test_yardstick_imports_nothing_of_the_program(module):
    """The generator, the reference and the arithmetic import neither the
    program nor JAX, in their sources and when imported alone."""
    names = _imports(os.path.join(HERE, module + ".py"))
    assert not names & {"dr_slam_torch", "dr_slam_tpu", "jax", "jaxlib"}
    code = (f"import sys; import slam_bench.{module}; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True).stdout
    loaded = set(json.loads(out.replace("'", '"')))
    assert not loaded & {"dr_slam_torch", "dr_slam_tpu", "jax", "jaxlib"}


def test_walks_follow_the_mix():
    cell = cells.load("tum3_loc.revisit")
    mix, world = cell["traffic"], cell["config"]["world"]
    T = frames.walk_poses(mix, world, 2**31 + 7, 40, "revisit")
    z = reference.centres(T)[:, 2]
    # back and forth over the first 12 positions, 0.02 m apart
    steps = np.round(np.diff(z) / mix["step_m"]).astype(int)
    assert set(steps) == {-1, 1}
    assert z.min() == pytest.approx(mix["start_z_m"])
    assert z.max() == pytest.approx(mix["start_z_m"] + 11 * mix["step_m"])
    R = T[:, :3, :3]
    assert np.allclose(R @ np.swapaxes(R, -1, -2), np.eye(3), atol=1e-12)
    # the seed moves the phases and the offset, not the step
    T2 = frames.walk_poses(mix, world, 5, 40, "revisit")
    assert not np.allclose(T, T2)
    assert np.allclose(np.diff(reference.centres(T2)[:, 2]),
                       np.diff(z))
    assert np.array_equal(T, frames.walk_poses(mix, world, 2**31 + 7, 40,
                                               "revisit"))


def test_frames_are_seeded_and_quantised_as_tum():
    cell = cells.load("tum3_slam.corridor")
    mix, world = cell["traffic"], cell["config"]["world"]
    cam = {"K4": (133.85, 134.8, 80.0, 60.0), "height": 120, "width": 160,
           "depth_factor": 5000.0,
           "planes": frames.corridor_planes(world["size_m"])}
    poses = frames.walk_poses(mix, world, 11, 3, "corridor")

    def render(seed):
        draws = frames.world_draws(seed, world)
        return frames.render_sequence(poses, cam, draws, 0.001, seed, "cpu",
                                      batch=2)

    g, d = render(11)
    assert g.dtype == np.uint8 and d.dtype == np.uint16
    assert g.shape == d.shape == (3, 120, 160)
    g2, d2 = render(11)
    assert np.array_equal(g, g2) and np.array_equal(d, d2)
    g3, _ = render(12)
    assert not np.array_equal(g, g3)
    # the end wall, 39 m off, does not fit 16 bits: no reading there
    assert (d[0, 55:65, 75:85] == 0).all()
    assert (d > 0).mean() > 0.5 and g.std() > 20
    gray, dm = frames.decode(g[0], d[0], 5000.0)
    assert gray.dtype == dm.dtype == np.float32
    assert dm.max() <= 65535 / 5000.0


def test_clutter_boxes_are_drawn_and_rendered():
    world = {"size_m": [4.0, 3.0, 40.0]}
    draws = frames.world_draws(3, world, boxes_per_m=0.8)
    assert draws["boxes"].shape == (32, 6)
    cam = {"K4": (133.85, 134.8, 80.0, 60.0), "height": 120, "width": 160,
           "depth_factor": 5000.0, "planes": frames.corridor_planes(
               world["size_m"])}
    mix = cells.load("tum3_slam.corridor")["traffic"]
    poses = frames.walk_poses(mix, world, 3, 1, "corridor")
    _, with_boxes = frames.render_sequence(poses, cam, draws, 0.0, 3, "cpu")
    _, bare = frames.render_sequence(poses, cam, frames.world_draws(3, world),
                                     0.0, 3, "cpu")
    assert (with_boxes != bare).any()


def test_reference_arithmetic():
    mix = cells.load("tum3_slam.corridor")["traffic"]
    world = {"size_m": [4.0, 3.0, 40.0]}
    true = reference.in_map_frame(
        *(lambda T: (T, T[0]))(frames.walk_poses(mix, world, 1, 30,
                                                 "corridor")))
    assert np.allclose(true[0], np.eye(4))
    r = reference.frame_readings(true, true)
    assert r["step_mm"] < 1e-9 and r["turn_mdeg"] < 1e-3
    assert r["drift_mm"] < 1e-9 and r["ate_mm"] < 1e-9
    stale = np.repeat(true[:1], len(true), 0)   # the pose never advances
    assert reference.frame_readings(stale, true)["step_mean_mm"] > 15.0
    shifted = true.copy()
    shifted[10, :3, 3] += [0.05, 0.0, 0.0]      # one pose altered by 5 cm
    assert reference.frame_readings(shifted, true)["step_mm"] == \
        pytest.approx(50.0, rel=1e-6)
    a = {"x": np.arange(6, dtype=np.float32), "v": np.ones(3, bool)}
    b = {"x": a["x"].copy(), "v": a["v"].copy()}
    assert reference.map_diff(a, b) == 0
    b["x"][2] += 1
    b["v"][0] = False
    assert reference.map_diff(a, b) == 2
    ok, checks = reference.judge({"a": 1.0, "b": float("nan")},
                                 {"a": 2.0, "b": 1.0, "c": 1.0})
    assert not ok and checks["a"] == {"value": 1.0, "limit": 2.0}
    assert reference.judge({"a": 1.0}, {"a": 2.0})[0]


@pytest.mark.parametrize("cell", CELLS)
def test_lower_precision_controls_fail_the_limits(cell):
    """The reference put in the program's place in bfloat16 fails the
    cell's check, on the true poses of a window as long as a run's and of
    three seeds; so does a saved map rounded to bfloat16."""
    c = cells.load(cell)
    conf, mix = c["config"], c["traffic"]
    n = mix["warm_frames"] + 60
    for seed in (2**31 + 11, 2**31 + 12, 2**31 + 13):
        poses = frames.walk_poses(mix, conf["world"], seed, n,
                                  c["traffic_name"])
        true = reference.in_map_frame(poses, poses[0])
        keep = {"true": true[mix["warm_frames"] - 1:], "true_all": true}
        if conf["mode"] == "slam":
            keep["kf_frame"] = np.arange(0, n, 10)
        else:
            rng = np.random.default_rng(seed)
            keep["saved_map"] = {"pt_pos": rng.normal(size=(64, 3)).astype(
                np.float32), "pt_valid": np.ones(64, bool)}
        low = control.lowered_readings(keep, 7)
        assert not reference.judge(low, c["limits"])[0], low


@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_fail_the_limits(cell):
    """The faults planted in the true poses put in the program's place (a
    pose that never advances; a pose, and a keyframe, moved 5 cm) fail the
    cell's check on three seeds."""
    c = cells.load(cell)
    conf, mix = c["config"], c["traffic"]
    n = mix["warm_frames"] + 40
    for seed in (2**31 + 21, 2**31 + 22, 2**31 + 23):
        poses = frames.walk_poses(mix, conf["world"], seed, n,
                                  c["traffic_name"])
        true = reference.in_map_frame(poses, poses[0])
        keep = {"true": true[mix["warm_frames"] - 1:], "true_all": true}
        if conf["mode"] == "slam":
            keep["kf_frame"] = np.arange(0, n, 10)
        for name, r in control.fault_readings(keep).items():
            assert not reference.judge(r, c["limits"])[0], (name, r)


def _records():
    """A stage-profiler summary as the program's profiler makes it, with
    the harness's call times, launches and a device trace."""
    from dr_slam_torch.utils.profiling import StageProfiler

    prof = StageProfiler()
    prof.enable()
    for name, ms in [("track.dispatch", 400.0), ("track.dispatch", 500.0),
                     ("resolve.readback", 2.0), ("kf.add", 30.0),
                     ("kf.local_ba", 4000.0), ("kf.readback", 5.0),
                     ("loop.resolve_gba", 1.0), ("loop.process", 20.0),
                     ("loop.pose_graph", 7.0)]:
        prof.record(name, ms)
    return {"spans": prof.summary(), "call_ms": [1000.0, 5100.0],
            "frames": 2, "frames_window_s": 6.5, "keyframes": 1,
            "matcher": [(1024, 32768, 1069), (1024, 32768, 1069)],
            "device_ops": [("void (anonymous namespace)::tile_kernel<4>(int4"
                            " const*)", 1.0, 1.00001),
                           ("(anonymous namespace)::merge_kernel(uint2)",
                            1.5, 1.50001),
                           ("void at::native::vectorized_elementwise_kernel",
                            2.0, 2.5)],
            "window_s": 5.0}


def test_metric_readers_on_a_recorded_summary():
    rec = _records()
    bound = matcher_bound_ms(1024, 32768, 1069)
    assert bound == pytest.approx(2 * 1024 * 1069 * 256 / 1979e12 * 1e3)
    want = {
        "track_dispatch_ms": 450.0,
        "tracker_self_ms": (6100.0 - 900.0 - 4035.0 - 21.0) / 2,
        "local_mapping_ms": 4035.0,
        "loop_detect_ms": 21.0,
        "matcher_roofline_pct": 100 * 2 * bound / 0.02,
        "device_idle_pct": 100 * (1 - 0.50002 / 5.0),
        "window_frames_per_s": 2 / 6.5,
        "window_frame_ms_p95": 1000.0 + 0.95 * 4100.0,
    }
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert sorted(m["name"] for m in spec["per_layer"]) == sorted(want)
    for name, value in want.items():
        assert run.reader(name)(rec) == pytest.approx(value, rel=1e-4)
    # nothing to read: the metric is left out, never 0
    empty = dict(rec, keyframes=0, matcher=[], device_ops=[], spans={},
                 frames=0, call_ms=[])
    for name in ("local_mapping_ms", "loop_detect_ms",
                 "matcher_roofline_pct", "device_idle_pct",
                 "track_dispatch_ms", "window_frames_per_s",
                 "window_frame_ms_p95"):
        assert run.reader(name)(empty) is None


def test_breakdown_names_the_gaps():
    ops = [("k1", 0.0, 1.0), ("k2", 3.0, 3.5), ("k1", 4.0, 4.1)]
    host = [("bench.subwindow", 0.0, 5.0, True), ("kf.local_ba", 1.0, 3.0,
                                                   True),
            ("aten::nonzero", 1.9, 2.1, False)]
    bd = trace.breakdown(ops, host, 0.0, 5.0)
    assert bd["device_ops"][0] == ["k1", pytest.approx(1.1)]
    assert bd["idle_gaps"][0] == ["kf.local_ba/aten::nonzero",
                                  pytest.approx(2.0)]
    assert trace.union_s([(0, 1), (0.5, 2), (3, 4)]) == pytest.approx(3.0)
    assert trace.MATCHER_KERNEL.search(
        "void (anonymous namespace)::compact_tile_kernel(unsigned char"
        " const*, int)")
    assert trace.MATCHER_KERNEL.search("_ZN12_GLOBAL__N_111tile_kernelEv")
    assert not trace.MATCHER_KERNEL.search("void cub::DeviceMergeSortKernel")


def test_profiler_bookkeeping_is_named_and_its_idle_time_counted():
    ops = [("k1", 0.0, 1.0), ("k2", 3.0, 3.5)]
    host = [("bench.subwindow", 0.0, 5.0, True),
            ("track.dispatch", 1.0, 3.0, True)]
    own = [("Activity Buffer Request", 1.5, 2.5),
           ("Activity Buffer Request", 3.2, 3.4)]
    bd = trace.breakdown(ops, host, 0.0, 5.0, own=own)
    assert bd["idle_gaps"][0] == ["profiler/Activity Buffer Request",
                                  pytest.approx(2.0)]
    assert bd["idle_gaps"][1] == ["bench.subwindow", pytest.approx(1.5)]
    # the second event runs while the device is busy: no idle time
    assert trace.idle_during(ops, own, 0.0, 5.0) == pytest.approx(1.0)
    assert trace.idle_during(ops, [], 0.0, 5.0) == 0.0


@pytest.mark.parametrize("cell", CELLS)
def test_configuration_files_state_the_preset_that_runs(cell):
    conf = cells.load(cell)["config"]
    cfg = run.make_config(conf)
    for group in run.STATED:
        assert conf[group], group
        for key, value in conf[group].items():
            assert getattr(getattr(cfg, group), key) == value
    for group, key, value in [("orb", "n_features", 1200),
                              ("map", "max_points", 16384),
                              ("camera", "no_such_size", 1)]:
        changed = json.loads(json.dumps(conf))
        changed[group][key] = value
        with pytest.raises(SystemExit, match=f"{group}.{key}"):
            run.make_config(changed)


def test_matcher_shapes_are_recorded():
    mod = types.SimpleNamespace(gated_top2_hamming=lambda *a: "out")
    args = [torch.zeros(7, 8)] + [None] * 3 + [torch.zeros(512, 8)] \
        + [None] * 4 + [torch.arange(512) < 100]
    with trace.MatcherShapes(mod) as shapes:
        assert mod.gated_top2_hamming(*args) == "out"
    assert shapes.launches() == [(7, 512, 100)]
    assert mod.gated_top2_hamming(*args) == "out"
    assert len(shapes.launches()) == 1


def test_module_check_catches_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    monkeypatch.setitem(sys.modules, "dr_slam_tpu.ops",
                        types.ModuleType("dr_slam_tpu.ops"))
    monkeypatch.setitem(sys.modules, "dr_slam_torch_extra",
                        types.ModuleType("dr_slam_torch_extra"))
    assert run.forbidden_modules() == ["dr_slam_tpu", "jax"]
    canned = {"correct": True, "attempted": 1, "failed": 0, "metrics": {},
              "device": {}, "checks": {}}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: canned)
    monkeypatch.setattr(run, "card_line", lambda: "test")
    assert run.main(["--workload", CELLS[0], "--seed", "1",
                     "--seconds", "1"]) == 3


def test_no_card_no_run():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, "slam_bench/run.py", "--workload", CELLS[0],
         "--seed", str(2**31 + 5), "--seconds", "1"], cwd=ROOT, env=env,
        capture_output=True, text=True)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "CUDA device" in proc.stderr
