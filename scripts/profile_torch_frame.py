"""Where one frame of the PyTorch port's main path spends its time on the GPU.

    python scripts/profile_torch_frame.py [--frames 24] [--out PATH]

Drives `extract_and_track` (tum_freiburg3 preset, 640x480) on cuda over the
smoke fixture's frames (dr_slam_torch/data/smoke_corridor.npz, the map the
JAX package built) and reports, per stage of the frame and for the whole:
- `wall_ms`: host-clock time per frame of the stage, with the device
  synchronised before and after it (what the stage costs when nothing
  overlaps it: launch overhead and device time together);
- `aten_ops`: PyTorch operator calls per frame (torch.profiler, CPU side);
- `device_ms`: kernel time per frame on the card (torch.profiler, CUDA side);
- for the frame: the pipelined time per frame (frames enqueued back to back,
  one synchronise at the end, nothing profiled); and, in a second pipelined
  loop traced with torch.profiler's CUDA activity alone, the host-clock
  time per frame, the device busy time per frame (the union of the kernels'
  intervals) and the device's idle share, all three from that one window
  (the tracing slows the host, so that window's frame is longer than the
  unprofiled one);
- the matcher kernel's device time per frame, for each of its CUDA
  kernels;
- `float64_gemm_ms_per_frame`: the device time per frame of the float64
  GEMM kernels, by the function that launched them: the innermost of the
  `PROBES` (functions inside a stage, labelled on their own) or stage
  whose range holds the launching operator.

Prints one JSON line (also written to --out, if given) after the card's name
and power limit. Needs one CUDA device; there is no CPU fallback."""

from __future__ import annotations

import argparse
import collections
import functools
import json
import os
import re
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

# (module, attribute) of each stage, looked up where the main path calls it
STAGES = [
    ("dr_slam_torch.ops.orb", "extract_orb"),
    ("dr_slam_torch.frontend.frame", "_sample_depth"),
    ("dr_slam_torch.ops.normals", "surface_normals"),
    ("dr_slam_torch.ops.planes", "segment_planes"),
    ("dr_slam_torch.ops.lines", "extract_lines"),
    ("dr_slam_torch.slam.track_step", "track_manhattan_frame"),
    ("dr_slam_torch.slam.map_ops", "match_points_projection"),
    ("dr_slam_torch.slam.track_step", "word_ids"),
    ("dr_slam_torch.slam.map_ops", "match_reference_kf"),
    ("dr_slam_torch.slam.map_ops", "match_planes"),
    ("dr_slam_torch.slam.map_ops", "match_lines_projection"),
    ("dr_slam_torch.slam.map_ops", "build_pose_obs"),
    ("dr_slam_torch.slam.track_step", "pose_optimize"),
    ("dr_slam_torch.slam.map_ops", "update_point_stats"),
]

# functions called inside a stage, given a profiler range of their own (not
# timed apart: their wall time stays in their stage's)
PROBES = [("dr_slam_torch.geometry.se3", "se3_left_jacobian_inv")]

# cuBLAS / CUTLASS kernel names of a float64 GEMM or GEMV
FLOAT64_GEMM = re.compile(r"d884gemm|dgemm|dgemv|gemv.*double")


def instrument(mode: str, wall: dict):
    """Wrap every stage: "sync" times it on the host clock between two
    synchronisations, "label" gives it a profiler range. Returns a function
    that restores the originals."""
    import importlib
    from torch.profiler import record_function

    saved = []
    probes = PROBES if mode == "label" else []
    for kind, (mod_name, attr) in ([("stage", x) for x in STAGES]
                                   + [("probe", x) for x in probes]):
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def wrapped(*a, _fn=fn, _name=f"{kind}::{attr}", **kw):
            if mode == "label":
                with record_function(_name):
                    return _fn(*a, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            wall[_name.split("::")[1]] += time.perf_counter() - t0
            return out

        setattr(mod, attr, functools.wraps(fn)(wrapped))

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--out", default=None,
                    help="also write the JSON result to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_frame.py needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile

    from dr_slam_torch._smoke import card_line, load_fixture, pipelined
    from dr_slam_torch.config import tum_freiburg3

    cfg = tum_freiburg3()
    fx = load_fixture(torch.device("cuda"))
    run = functools.partial(pipelined, fx, cfg=cfg)

    run(4)                                     # build, warm the allocator
    torch.cuda.synchronize()

    # pipelined frame time, nothing instrumented
    t0 = time.perf_counter()
    run(args.frames)
    torch.cuda.synchronize()
    pipelined_ms = (time.perf_counter() - t0) / args.frames * 1e3

    # busy and idle share: one traced pipelined window, its wall time and
    # its kernels
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(args.frames)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / args.frames * 1e3
    window = [(e.time_range.start, e.time_range.end) for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if not window:
        raise SystemExit("the profiler saw no kernel on the device")
    busy_ms = _union_us(window) / args.frames / 1e3
    if busy_ms > traced_ms:
        raise SystemExit(f"device busy {busy_ms} ms exceeds the window's "
                         f"{traced_ms} ms per frame: kernels miscounted")

    # per-stage wall time, synchronised around each stage
    wall = collections.defaultdict(float)
    restore = instrument("sync", wall)
    run(args.frames)
    restore()

    # operator counts and kernel time, per stage and in all
    restore = instrument("label", wall)
    n_prof = min(args.frames, 8)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_prof)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) / n_prof * 1e3
    restore()
    events = prof.events()
    ops = collections.Counter()
    dev_us = collections.Counter()
    by_name = collections.Counter()
    matcher_us = collections.Counter()
    f64_us = collections.Counter()
    n_ops = 0
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            # the stage ranges are mirrored onto the device timeline too
            if not e.name.startswith(("stage::", "probe::")):
                by_name[e.name[:60]] += e.time_range.elapsed_us()
            for part in ("tile_kernel", "merge_kernel"):
                if part in e.name:
                    matcher_us[part] += e.time_range.elapsed_us()
            continue
        for k in e.kernels:
            if FLOAT64_GEMM.search(k.name):
                f64_us[_owner(e)] += k.duration
        if e.name.startswith("stage::"):
            name = e.name[len("stage::"):]
            dev_us[name] += getattr(e, "device_time_total", 0.0)
            ops[name] += sum(1 for _ in _aten_descendants(e))
        elif e.name.startswith("aten::") and _top_level_aten(e):
            n_ops += 1
    stages = {attr: {"wall_ms": wall[attr] / args.frames * 1e3,
                     "aten_ops": ops[attr] / n_prof,
                     "device_ms": dev_us[attr] / n_prof / 1e3}
              for _, attr in STAGES}
    result = {
        "card": card_line(), "torch": torch.__version__,
        "device": torch.cuda.get_device_name(0), "frames": args.frames,
        "pipelined_ms_per_frame": pipelined_ms,
        "frames_per_s": 1e3 / pipelined_ms,
        "aten_ops_per_frame": n_ops / n_prof,
        "traced_ms_per_frame": traced_ms,
        "device_busy_ms_per_frame": busy_ms,
        "device_events_per_frame": len(window) / args.frames,
        "device_idle_share": 1.0 - busy_ms / traced_ms,
        "matcher_kernels_device_ms_per_frame": {
            k: v / n_prof / 1e3 for k, v in matcher_us.items()},
        "stages": stages,
        "float64_gemm_ms_per_frame": {
            k: v / n_prof / 1e3 for k, v in f64_us.items()},
        "top_device_events_ms_per_frame": {
            k: v / n_prof / 1e3 for k, v in by_name.most_common(8)},
        "profiled_wall_ms_per_frame": profiled_ms,
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(result["card"])
    print(json.dumps(result))


def _union_us(intervals) -> float:
    """Length of the union of (start, end) intervals: the time in which at
    least one kernel ran."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _aten_descendants(e):
    """ATen operators called directly by the stage (not those that an
    operator calls internally)."""
    stack = list(e.cpu_children)
    while stack:
        c = stack.pop()
        if c.name.startswith("aten::"):
            yield c
        else:
            stack.extend(c.cpu_children)


def _owner(e) -> str:
    """The innermost probe or stage range around CPU event `e`."""
    p = e
    while p is not None:
        if p.name.startswith(("probe::", "stage::")):
            return p.name
        p = p.cpu_parent
    return "outside every stage"


def _top_level_aten(e) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name.startswith("aten::"):
            return False
        p = p.cpu_parent
    return True


if __name__ == "__main__":
    main()
