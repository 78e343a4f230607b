"""Run one cell of the benchmark once on one NVIDIA GPU.

    python3 slam_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout that holds `BENCHMARK.json`, this folder and
the program (`dr_slam_torch`). The cell names a configuration
(`configs/<config>.json`), a traffic mix (`traffic/<traffic>.json`) and the
limits of its correctness check (`limits/<cell>.json`); each per-layer
metric is read by `metrics/<metric>.py`. All four are found by the names in
`BENCHMARK.json`, so a cell or a metric is added with new files only.

A run: render the seed's frames on the card and quantise them as a TUM PNG
pair holds them (set-up), build the System (in localization mode: build a
map, save it under TMPDIR, load it into a new System), warm up, then hand
frame i to `System.track_rgbd` no earlier than i / rate seconds after the
window opens, reading each frame's pose back to the host, for `--seconds`
seconds, from one process with one host thread per math library. With
`--trace 0` the metrics are the device's memory peak and the set-up time;
the window's frame rate and latency tail go to standard error's `run` line
(on a shared host they spread too widely for a bound). With
`--trace 1` the program's stage profiler is on in the window, which also
gives the frame rate and the latency tail as per-layer metrics, and after it,
once the next keyframe pass has run, `torch.profiler` traces a sub-window
of the few calls that follow the pass (the per-frame path alone; the result
line's `subwindow` says what it held and how much of its idle time the
profiler's own bookkeeping took).
Then the poses are judged against the true trajectory (`reference.py`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`
and `subwindow`, and last `checks` (each number compared, with its limit). Without a CUDA
device, or with fewer than the cell asks for, it prints no result and exits
with 2; if JAX or the JAX package was imported, with 3."""

from __future__ import annotations

import os
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    # one process with one host thread per math library: the program is
    # bound by the host's launches, and idle thread pools only add noise
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
                      OPENBLAS_NUM_THREADS="1")

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from slam_bench import frames, reference, trace  # noqa: E402

HERE = os.path.join(ROOT, "slam_bench")
FORBIDDEN = ("jax", "jaxlib", "flax", "dr_slam_tpu")
# the traced sub-window: this many calls right after a keyframe pass, so
# that it holds the per-frame path alone; a pass comes within the tracker's
# max_frames (30) of the last one, so the wait is bounded
SUBWINDOW_CALLS = 3
PASS_WAIT_CALLS = 40
SUBWINDOW_TRIES = 2


def _json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT, spec: dict | None = None) -> dict:
    """The cell `name` of `BENCHMARK.json` (or of `spec`, a dict laid out as
    it is) with its configuration, traffic mix, limits and the metrics it
    reports."""
    spec = spec or _json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return {"name": name, "chips": w["chips"],
            "config": _json(root, conf["file"]),
            "traffic_name": w["traffic"],
            "traffic": _json(root, "slam_bench", "traffic",
                             w["traffic"] + ".json"),
            "limits": _json(root, "slam_bench", "limits", name + ".json"),
            "end_to_end": reported(spec["end_to_end"]),
            "per_layer": reported(spec["per_layer"])}


def reader(metric: str):
    """`read(records)` of `metrics/<metric>.py`."""
    path = os.path.join(HERE, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "slam_bench.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Top-level names in sys.modules that are JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# the configuration file's groups of sizes, each the preset's field of the
# same name: the file states them, the preset is what runs
STATED = ("camera", "orb", "map")


def check_config(conf: dict, cfg) -> None:
    """Refuse the run where a size the configuration file states differs
    from the preset that runs, or names no field of it."""
    bad = []
    for group in STATED:
        for key, want in conf.get(group, {}).items():
            have = getattr(getattr(cfg, group), key, None)
            if have is None or have != want:
                bad.append(f"{group}.{key}: file {want!r}, preset {have!r}")
    if bad:
        raise SystemExit(f"configuration {conf['preset']!r} differs from its "
                         "file: " + "; ".join(bad))


def make_config(conf: dict):
    from dr_slam_torch import config as presets
    cfg = getattr(presets, conf["preset"])()
    check_config(conf, cfg)
    return cfg


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _host_pose(T) -> np.ndarray:
    if isinstance(T, torch.Tensor):
        return T.detach().cpu().numpy().astype(np.float64)
    return np.asarray(T, np.float64)


def _map_arrays(system) -> dict:
    return {k: v.detach().cpu().numpy()
            for k, v in system.tracker.map_state._asdict().items()}


def cell_frames(cell: dict, cfg, seed: int, n: int, dev) -> tuple:
    """The seed's walk of `n` frames (after the map's walk, in localization
    mode), rendered on `dev` and quantised as a TUM PNG pair holds them:
    (true poses, the map's anchor pose, frames of the map's walk, gray,
    depth)."""
    conf, mix = cell["config"], cell["traffic"]
    world = conf["world"]
    cam = {"K4": cfg.camera.K4, "height": cfg.camera.height,
           "width": cfg.camera.width,
           "depth_factor": cfg.camera.depth_factor,
           "planes": frames.corridor_planes(world["size_m"])}
    poses = frames.walk_poses(mix, world, seed, n, cell["traffic_name"])
    n_map = 0
    if conf["mode"] == "localization":
        map_mix = _json(HERE, "traffic", conf["map_walk"] + ".json")
        n_map = int(conf["map_frames"])
        map_poses = frames.walk_poses(map_mix, world, seed, n_map,
                                      conf["map_walk"])
        anchor = map_poses[0]
        poses = np.concatenate([map_poses, poses])
    else:
        anchor = poses[0]
    draws = frames.world_draws(seed, world, mix["boxes_per_m"])
    gray, depth = frames.render_sequence(poses, cam, draws,
                                         mix["depth_noise_per_m"], seed, dev)
    return poses, anchor, n_map, gray, depth


def keyframe_poses(tracker, rate: float) -> tuple:
    """(frame index, pose after local mapping (K, 4, 4)) of every live
    keyframe of the tracker's map, in insertion order."""
    st = tracker.map_state
    valid = st.kf_valid.cpu().numpy()
    order = np.where(valid)[0]
    order = order[np.argsort(st.kf_seq.cpu().numpy()[order])]
    kf_frame = np.rint(st.kf_ts.cpu().numpy()[order] * rate).astype(int)
    return kf_frame, st.kf_pose.cpu().numpy()[order].astype(np.float64)


def run_cell(cell: dict, seed: int, seconds: float, trace_on: bool,
             device="cuda", cfg=None, keep: dict | None = None) -> dict:
    """One run of `cell`; returns the result line's object (without the
    module check). `cfg` replaces the configuration's preset (the tests'
    small configuration); `keep`, a dict, receives the run's poses and
    maps for the controls."""
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.system import System
    from dr_slam_torch.utils.profiling import PROFILER

    dev = torch.device(device)
    conf, mix = cell["config"], cell["traffic"]
    cfg = cfg or make_config(conf)
    rate = float(mix["rate_hz"])
    warm = int(mix["warm_frames"])
    localize = conf["mode"] == "localization"
    parts = {}

    # -- the frames: every one the window could reach at the camera's rate
    t = time.perf_counter()
    n = (warm + math.ceil(rate * seconds) + 1 + PASS_WAIT_CALLS
         + SUBWINDOW_TRIES * SUBWINDOW_CALLS)
    poses, anchor, n_map, gray, depth = cell_frames(cell, cfg, seed, n, dev)
    true_map = reference.in_map_frame(poses, anchor)
    if dev.type == "cuda":
        # the peak is the system's, not the generator's
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    parts["render_s"] = time.perf_counter() - t

    est = np.full((len(poses), 4, 4), np.nan)
    df = cfg.camera.depth_factor

    cpu_ms = []     # the main thread's CPU time of each call

    def call(system, g: int) -> float:
        """Hand frame g to the system; ms until its pose is on the host."""
        gr, de = frames.decode(gray[g], depth[g], df)
        c0 = time.thread_time()
        t0 = time.perf_counter()
        res = system.track_rgbd(gr, de, g / rate)
        with torch.profiler.record_function("bench.pose_readback"):
            est[g] = _host_pose(res.T_cw)
        cpu_ms.append((time.thread_time() - c0) * 1e3)
        return (time.perf_counter() - t0) * 1e3

    # -- the system (and, in localization mode, the map)
    t = time.perf_counter()
    readings = {}
    if localize:
        mapper = System(cfg, enable_loop_closing=False, device=dev)
        for g in range(n_map):
            call(mapper, g)
        mapper.tracker.flush()
        saved = _map_arrays(mapper)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "map.npz")
            mapper.save_map(path)
            mapper.shutdown()
            del mapper
            system = System(cfg, enable_loop_closing=False, device=dev)
            system.load_map(path)
        loaded = _map_arrays(system)
        readings["map_diff"] = reference.map_diff(saved, loaded)
        if keep is not None:
            keep.update(saved_map=saved)
        system.activate_localization_mode()
        parts["map_s"] = time.perf_counter() - t
    else:
        system = System(cfg, enable_loop_closing=bool(conf["loop_closing"]),
                        device=dev)
    t = time.perf_counter()
    for g in range(n_map, n_map + warm):
        call(system, g)
    _sync(dev)
    parts["warm_s"] = time.perf_counter() - t

    # -- the window
    tr = system.tracker
    first = n_map + warm
    kf_before, id_before = len(tr.kf_log), tr.frame_id
    map_kfs_open = tr._n_kfs_host
    if trace_on:
        PROFILER.enable()
        PROFILER.reset()
    lat, raised, pass_calls = [], 0, []
    g = first
    n_cpu = len(cpu_ms)
    t_open = time.perf_counter()
    setup_s = t_open - T_START
    while True:
        due = (g - first) / rate
        now = time.perf_counter() - t_open
        if now >= seconds or due >= seconds:
            break
        if now < due:
            time.sleep(due - now)
        n_kf = len(tr.kf_log)
        try:
            lat.append(call(system, g))
            if len(tr.kf_log) > n_kf:
                pass_calls.append(len(lat) - 1)
        except Exception:   # a failed call: counted, and the window ends
            traceback.print_exc()
            raised += 1
            g += 1
            break
        g += 1
    t_close = time.perf_counter()
    window_s = t_close - t_open
    window_cpu_ms = cpu_ms[n_cpu:n_cpu + len(lat)]
    attempted = g - first
    keyframes = len(tr.kf_log) - kf_before
    map_kfs_close = tr._n_kfs_host

    records = subwindow = None
    if trace_on and not raised:
        spans = PROFILER.summary()
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        # untimed calls up to the next keyframe pass (localization makes
        # none), then the sub-window: the calls after it, traced; tried
        # again right after a pass that fell inside it
        after_pass = False
        for _ in range(0 if localize else PASS_WAIT_CALLS):
            n_kf = len(tr.kf_log)
            call(system, g)
            g += 1
            if len(tr.kf_log) > n_kf:
                after_pass = True
                break
        for tries in range(1, SUBWINDOW_TRIES + 1):
            n_kf = len(tr.kf_log)
            with trace.MatcherShapes(map_ops) as shapes, \
                    profile(activities=acts) as prof:
                with record_function("bench.subwindow"):
                    sub_ms = []
                    for _ in range(SUBWINDOW_CALLS):
                        sub_ms.append(call(system, g))
                        g += 1
                    _sync(dev)
            passes = len(tr.kf_log) - n_kf
            if not passes:
                break
        PROFILER.disable()
        raw = trace.read_profile(prof)
        sub = next((a, b) for name, a, b, ann in raw["host"]
                   if ann and name == "bench.subwindow")
        ops = [(name, max(a, sub[0]), min(b, sub[1]))
               for name, a, b in raw["device_ops"] if b > sub[0] and a < sub[1]]
        records = {"spans": spans, "call_ms": lat, "frames": len(lat),
                   "frames_window_s": window_s,
                   "keyframes": keyframes, "matcher": shapes.launches(),
                   "device_ops": ops, "window_s": sub[1] - sub[0]}
        bd = trace.breakdown(ops, raw["host"], *sub, own=raw["own"])
        busy_s = trace.union_s((a, b) for _, a, b in ops)
        own_idle = trace.idle_during(ops, raw["own"], *sub)
        # the profiler slows the host: the same calls in the window, where
        # they carried no pass, against the traced ones
        plain = [ms for i, ms in enumerate(lat) if i not in pass_calls]
        slowdown = (float(np.mean(sub_ms) / np.median(plain))
                    if plain else None)
        span = sub[1] - sub[0]
        subwindow = {"calls": SUBWINDOW_CALLS, "after_pass": after_pass,
                     "tries": tries, "passes": passes, "call_ms": sub_ms,
                     "profiler_idle_pct": 100.0 * own_idle / span,
                     "host_slowdown": slowdown,
                     "idle_pct_at_window_speed": (
                         100.0 * (1.0 - busy_s * slowdown / span)
                         if slowdown else None)}

    # -- after the window: resolve the last frame, read the peak
    tr.flush()
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        kind = torch.cuda.get_device_name(dev)
    else:
        peak, kind = 0, "cpu"
    ids = set(range(id_before + 1, id_before + attempted + 1))
    lost = {r["idx"] for r in system.metrics.records
            if r["event"] in ("frame", "frame_resolved")
            and r.get("state") == "LOST" and r["idx"] in ids}
    failed = len(lost) + raised

    # -- the check against the true trajectory
    judged = slice(first - 1, g)
    readings.update(reference.frame_readings(est[judged], true_map[judged]))
    if not localize:
        kf_frame, kf_est = keyframe_poses(tr, rate)
        readings = reference.with_keyframes(readings, kf_est,
                                            true_map[kf_frame])
        if keep is not None:
            keep.update(kf_frame=kf_frame, kf_est=kf_est)
    if keep is not None:
        keep.update(est=est[judged], true=true_map[judged], true_all=true_map,
                    readings=readings)
    system.shutdown()
    del system
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    correct, checks = reference.judge(readings, cell["limits"])
    correct = correct and raised == 0 and len(lat) > 0

    lat_ms = np.asarray(lat, np.float64)
    info = {"samples": len(lat), "window_s": window_s,
            "frames_per_s": len(lat) / window_s if window_s else None,
            "frame_ms_p95": float(np.percentile(lat_ms, 95)) if lat else None,
            "keyframes": keyframes, "lost": len(lost), "raised": raised,
            "frame_ms_p50": float(np.median(lat_ms)) if lat else None,
            "map_keyframes": [map_kfs_open, map_kfs_close],
            "call_ms": [round(x, 3) for x in lat], "pass_calls": pass_calls,
            "call_cpu_ms": [round(x, 3) for x in window_cpu_ms],
            "subwindow": subwindow,
            "setup_parts_s": parts,
            "drift_mm": readings["drift_mm"], "ate_mm": readings["ate_mm"],
            "turn_mdeg": readings["turn_mdeg"]}
    print("run " + json.dumps(info), file=sys.stderr)

    if trace_on:
        metrics = {}
        for m in cell["per_layer"]:
            v = reader(m["name"])(records) if records else None
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = {"device_memory_peak_mib": peak / 2**20 if peak else None,
               "setup_s": setup_s}
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell["end_to_end"] if e2e.get(m["name"]) is not None}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": kind, "count": cell["chips"],
                   "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if records is not None:
        device_info.update(busy_s=busy_s, window_s=records["window_s"])
        out["breakdown"] = bd
        out["subwindow"] = subwindow
    out["checks"] = checks
    return out


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi not readable: {e}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    cell = load_cell(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s), "
              f"found {have}: no run", file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    print("card " + card_line(), file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were imported: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
