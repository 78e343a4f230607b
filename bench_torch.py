"""Benchmark entry point of the PyTorch port: the twin of bench.py, leg for
leg, on one NVIDIA GPU. Prints ONE JSON line with bench.py's keys:

    {"metric": "tracking_fps_pipelined_640x480", "value": N,
     "unit": "frames/sec", "vs_baseline": N / 30, "interactive_fps": N,
     "interactive_readbacks_per_frame": N,
     "interactive_fps_host_readback": N, "ate_rmse_m": N,
     "ate_rmse_raw_m": N, "loops_closed": N}

    python3 bench_torch.py                      # the card, bench.py's lengths
    python3 bench_torch.py --device cpu --odometry-frames 2 --windows 1 \\
        --interactive-frames 30 --warm 25 --tracking-frames 30 \\
        --accuracy-frames 20                    # short legs on the CPU

Runs on cuda, and raises without a GPU unless --device cpu is passed.
vs_baseline is frames/s over 30, the reference's camera rate (bench.py).

The legs, at the `tum_freiburg3()` preset (640x480) unless a `cfg` is given:
- `bench_odometry`: a 12-frame corridor map built in this process by a
  `System`, saved and loaded again, then `extract_and_track` pipelined
  over frames 12-15 cycled (velocity held at the identity), the best of 3
  windows of 240 frames. The headline `value`.
- `bench_interactive_device`: `DeviceLoopTracker` over 120 frames after 25
  warm-up frames, each frame's copy to the card issued on a side stream
  before the frame before it is dispatched. `interactive_fps`; the loop
  reads its flags back once per step (more on a relocalization attempt or
  a capacity-wall step), and the line says how often.
- `bench_tracking`: `System.track_rgbd` over 60 frames, the frames after
  the warm-up timed. `interactive_fps_host_readback`.
- `bench_accuracy`: the closed-loop accuracy protocol
  (`dr_slam_torch._smoke.accuracy_run`, the twin of
  scripts/bench_accuracy.py) in this process: `ate_rmse_m`,
  `ate_rmse_raw_m`, `loops_closed`.
- `bench_frontend`: `extract_orb` over 30 pre-rendered frames. Not part of
  the line: bench.py prints it only when the odometry leg cannot run, and
  here a leg that fails ends the run.

bench.py's workarounds for its TPU runtime are dropped: the map and the
frames are made in this process, with no subprocess and no file cache, and
the accuracy protocol runs in this process too. No leg's failure is caught:
a leg that raises ends the run with a non-zero exit and no line.

Not ported: bench.py's `mfu_estimate`. It divides XLA's cost analysis of
the frame program by a table of TPU peak rates; a TPU figure is no measure
of this port, and a SLAM frame is bound by its host's launches, not by
arithmetic.

Each leg also returns its run record (`LegRun.record`): per frame the
states, keyframe flags, reference keyframes, poses, counts and matcher
launches, so that a caller can hold the timed run against the JAX
package's run of the same loop (chip_smoke.py phase 14,
tests/test_torch_bench.py)."""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dr_slam_torch import resolve_device, to_numpy  # noqa: E402

MAP_FRAMES = 12          # bench.py: the odometry map's frames 0-11
ODOMETRY_FRAMES = 16     # frames 12-15 are the pipelined loop's
# frames of the first window under torch.profiler: a 640x480 frame's trace
# is about 107 MB of JSON on the H100 (8 frames: 860 MB), written gzipped
PROFILE_FRAMES = 2


class LegRun(NamedTuple):
    fps: float
    record: dict


def _cfg(cfg):
    from dr_slam_torch.config import tum_freiburg3

    return cfg if cfg is not None else tum_freiburg3()


def _sequence(cfg, n: int, dev):
    from dr_slam_torch.io import synthetic

    cam = cfg.camera
    return synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(n), K4=cam.K4, height=cam.height,
        width=cam.width, device=dev)


def _f32(x, dev) -> torch.Tensor:
    """A numpy array or a tensor as a float32 tensor on `dev`."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, torch.float32)
    return torch.from_numpy(np.array(x, np.float32)).to(dev)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launches() -> int:
    from dr_slam_torch.ops import match_cuda

    return match_cuda.gated_top2_hamming.launches


def bench_frontend(n_frames: int = 30, cfg=None, device="cuda",
                   frames=None) -> LegRun:
    """ORB front-end frames/s: `extract_orb` with its defaults over
    `n_frames` corridor frames rendered on the device beforehand (at
    `cfg`'s camera; `tum_freiburg3()`'s is the renderer's default, as in
    bench.py's leg), one warm call first. `frames`: the gray images to use
    instead. Record: the valid keypoints per frame."""
    from dr_slam_torch.ops import orb

    dev = resolve_device(device)
    if frames is None:
        seq = _sequence(_cfg(cfg), n_frames, dev)
        frames = [seq.render(i)[0] for i in range(n_frames)]
    frames = [_f32(g, dev) for g in frames[:n_frames]]
    _sync(dev)
    orb.extract_orb(frames[0])
    _sync(dev)
    kps = []
    t0 = time.perf_counter()
    for f in frames:
        kps.append(orb.extract_orb(f))
    _sync(dev)
    dt = time.perf_counter() - t0
    n_valid = np.asarray([int(k.valid.sum()) for k in kps], np.int32)
    return LegRun(len(frames) / dt, {"n_valid": n_valid, "seconds": dt})


def bench_tracking(n_frames: int = 60, cfg=None, device="cuda",
                   frames=None) -> LegRun:
    """Closed-loop frames/s of `System(cfg).track_rgbd` (loop closing on,
    the default deferred mode): corridor frames rendered beforehand and
    read back to numpy, as bench.py's are; the first
    min(2 * min_frames + 3, n_frames - 10) frames warm the keyframe path
    and the rest are timed, up to a synchronise at the end.

    Each frame's upload from numpy waits for the stream, so the previous
    frame's decision bundle is on the host when the frame starts and the
    deferred decision lags by exactly one frame, as in the JAX package's
    run with `wait_pending`.

    `frames`: [(gray, depth in metres)] to use instead of the renders.
    Record, per frame: the state code, the keyframe flag, the reference
    keyframe after the call, T_cw, inliers, matches and matcher launches;
    the keyframes' frames, the live keyframe and point counts."""
    from dr_slam_torch.slam.system import System

    cfg = _cfg(cfg)
    dev = resolve_device(device)
    if frames is None:
        seq = _sequence(cfg, n_frames, dev)
        frames = [(f.gray, f.depth) for f in (seq[i] for i in range(n_frames))]
    frames = list(frames[:n_frames])
    n = len(frames)
    sysm = System(cfg, device=dev)
    tr = sysm.tracker
    warm = min(2 * cfg.tracking.min_frames + 3, n - 10)
    rec = {k: [] for k in ("state", "is_keyframe", "ref_kf", "T_cw",
                           "n_inliers", "n_matches", "launches")}

    def track(i):
        before = _launches()
        g, d = frames[i]
        res = sysm.track_rgbd(g, d, i / 30.0)
        rec["state"].append(res.state.value)
        rec["is_keyframe"].append(bool(res.is_keyframe))
        rec["ref_kf"].append(int(tr.ref_kf))
        rec["T_cw"].append(res.T_cw)
        rec["n_inliers"].append(int(res.n_inliers))
        rec["n_matches"].append(int(res.n_matches))
        rec["launches"].append(_launches() - before)

    for i in range(warm):
        track(i)
    sysm.block_until_ready()
    t0 = time.perf_counter()
    for i in range(warm, n):
        track(i)
    sysm.block_until_ready()
    dt = time.perf_counter() - t0
    rec["T_cw"] = [to_numpy(T).astype(np.float32) for T in rec["T_cw"]]
    out = {k: np.asarray(v) for k, v in rec.items()}
    st = tr.map_state
    out.update(kf_frames=np.asarray([int(round(ts * 30.0))
                                     for ts, _ in tr.kf_log], np.int32),
               n_kfs=int(st.kf_valid.sum()), n_pts=int(st.n_pts),
               warm=warm, seconds=dt)
    return LegRun((n - warm) / dt, out)


def _quantize(gray, depth, depth_factor: float):
    """bench.py's camera-native staging of a float render, on the host:
    uint8 gray, uint16 depth units."""
    g = np.asarray(to_numpy(gray), np.float32)
    d = np.asarray(to_numpy(depth), np.float32)
    return (np.clip(g + 0.5, 0, 255).astype(np.uint8),
            np.clip(d * depth_factor + 0.5, 0, 65535).astype(np.uint16))


class _Stager:
    """Double-buffered copies of host frames to the card. The frames are
    pinned first (a `non_blocking` copy from pageable memory is
    synchronous); `issue(i)` starts frame i's copy on a side stream and
    records an event behind it; `take` makes the current stream wait for
    that event and marks the copies as used there (`record_stream`), so the
    caching allocator does not hand their memory to a later copy on the side
    stream while the current stream still reads it. On the CPU the frames
    are used as they are."""

    def __init__(self, grays, depths, dev):
        self.dev = dev
        self.cuda = dev.type == "cuda"
        self.host = [(torch.from_numpy(g), torch.from_numpy(d))
                     for g, d in zip(grays, depths)]
        if self.cuda:
            self.host = [(g.pin_memory(), d.pin_memory())
                         for g, d in self.host]
            self.stream = torch.cuda.Stream(dev)

    def issue(self, i: int):
        g, d = self.host[i]
        if not self.cuda:
            return g, d, None
        with torch.cuda.stream(self.stream):
            g = g.to(self.dev, non_blocking=True)
            d = d.to(self.dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        return g, d, done

    def take(self, staged):
        g, d, done = staged
        if done is not None:
            cur = torch.cuda.current_stream(self.dev)
            cur.wait_event(done)
            g.record_stream(cur)
            d.record_stream(cur)
        return g, d


def bench_interactive_device(n_frames: int = 120, warm: int = 25, cfg=None,
                             device="cuda", frames=None) -> LegRun:
    """Closed-loop frames/s of the device-resident state machine
    (`DeviceLoopTracker`: init, tracking, LOST rollback, keyframe insertion
    with the local-mapping pass), every keyframe's cost in the timed loop.
    The corridor frames are rendered beforehand and quantised as bench.py
    quantises them (uint8 gray, uint16 depth units). The first `warm`
    frames go in as numpy; from then on frame i+1's copy to the card is
    issued on a side stream before frame i is dispatched (`_Stager`), and
    the frames after the warm-up are timed up to a synchronise.

    The shipped codebooks are registered for the run, as a `System`
    registers them, so the leg does not depend on what ran before it.
    Unlike the reference's one jitted step, the port branches on the host:
    each step reads back its flags (`StepInfo.readbacks`), and the record
    counts those readbacks.

    `frames`: [(gray, depth in metres)] float renders to quantise and use
    instead. Record: the tracker's flushed records (`REC_SIZE` floats per
    frame), readbacks, relocalization attempts and matcher launches per
    frame, the live keyframe and point counts."""
    from dr_slam_torch._smoke import shipped_codebooks
    from dr_slam_torch.slam.device_loop import DeviceLoopTracker

    cfg = _cfg(cfg)
    dev = resolve_device(device)
    if frames is None:
        seq = _sequence(cfg, n_frames, dev)
        frames = [seq.render(i) for i in range(n_frames)]
    staged = [_quantize(g, d, cfg.camera.depth_factor)
              for g, d in frames[:n_frames]]
    n = len(staged)
    gray = [g for g, _ in staged]
    depth = [d for _, d in staged]
    launches = []
    with shipped_codebooks():
        tr = DeviceLoopTracker(cfg, device=dev)
        for i in range(warm):
            before = _launches()
            tr.track(gray[i], depth[i], i / 30.0)
            launches.append(_launches() - before)
        _sync(dev)
        stager = _Stager(gray[warm:], depth[warm:], dev)
        t0 = time.perf_counter()
        nxt = stager.issue(0) if warm < n else None
        for i in range(warm, n):
            cur = nxt
            if i + 1 < n:
                nxt = stager.issue(i + 1 - warm)
            g, d = stager.take(cur)
            before = _launches()
            tr.track(g, d, i / 30.0)
            launches.append(_launches() - before)
        _sync(dev)
        dt = time.perf_counter() - t0
        flushed = tr.flush()
    st = tr.map_state
    return LegRun((n - warm) / dt, {
        "records": flushed["records"], "states": flushed["states"],
        "readbacks": np.asarray(tr.readbacks), "relocs": np.asarray(
            tr.relocs), "launches": np.asarray(launches),
        "n_keyframes": flushed["n_keyframes"], "n_pts": int(st.n_pts),
        "warm": warm, "seconds": dt})


def bench_odometry(n_frames: int = 240, cfg=None, device="cuda", frames=None,
                   windows: int = 3) -> LegRun:
    """Per-frame tracking throughput with pipelined dispatch:
    `extract_and_track` chained on the device against a built map, no
    per-frame readbacks.

    The map: `System(cfg, enable_loop_closing=False)` over corridor frames
    0-11, saved with `save_map` (unflushed, as bench.py saves it) and
    loaded again with `io/map_io.load_map`. The loop: frames 12-15 staged
    in camera-native types (uint8 gray, uint16 depth units, cast on the
    device), cycled; the velocity held at the identity, the reference
    keyframe 1, the pose starting at the identity and the Manhattan
    rotation at the map's; map state, pose and rotation chained from frame
    to frame and window to window. One warm call (it builds the CUDA
    matcher), then the best of `windows` windows of `n_frames` frames, each
    ended by a synchronise.

    With DRSLAM_PROFILE_DIR set, torch.profiler records the first window's
    first PROFILE_FRAMES frames (a frame is some 67,000 ATen ops) and
    writes a gzipped Chrome trace there, bench_odometry_trace.json.gz;
    that window's time then includes the profiler's.

    `frames`: 16 [(gray, depth in metres)] to use instead of the renders.
    Record: the loaded and the built map, the state the windows start from
    (`start`: map state, pose, rotation), the staged frames, the last
    frame's output, each window's frames/s and matcher launches."""
    from dr_slam_torch._smoke import Fixture, pipelined
    from dr_slam_torch.io import map_io
    from dr_slam_torch.slam.system import System

    cfg = _cfg(cfg)
    dev = resolve_device(device)
    if frames is None:
        seq = _sequence(cfg, ODOMETRY_FRAMES, dev)
        frames = [(f.gray, f.depth) for f in
                  (seq[i] for i in range(ODOMETRY_FRAMES))]
    sysm = System(cfg, enable_loop_closing=False, device=dev)
    for i in range(MAP_FRAMES):
        g, d = frames[i]
        sysm.track_rgbd(g, d, i / 30.0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench_map.npz")
        sysm.save_map(path)
        st = loaded = map_io.load_map(path, cfg, dev)

    def cast8(g):
        return torch.clamp(g + 0.5, 0, 255).to(torch.uint8)

    def cast16(d):
        return torch.clamp(d * cfg.camera.depth_factor + 0.5, 0,
                           65535).to(torch.uint16)
    staged = [(cast8(_f32(g, dev)), cast16(_f32(d, dev)))
              for g, d in frames[MAP_FRAMES:ODOMETRY_FRAMES]]
    _sync(dev)
    fx = Fixture({}, st, staged, torch.eye(4, device=dev),
                 torch.eye(4, device=dev), st.R_wm,
                 torch.tensor(1, device=dev))

    def after(fx, out):
        return fx._replace(state=out.new_map_state, T_last=out.T_cw,
                           R_cm=out.R_cm)
    fx = after(fx, pipelined(fx, 1, cfg))
    _sync(dev)
    start = (fx.state, fx.T_last, fx.R_cm)
    prof_dir = os.environ.get("DRSLAM_PROFILE_DIR")
    fps, launches = [], []
    for w in range(windows):
        before = _launches()
        t0 = time.perf_counter()
        done = 0
        if prof_dir and w == 0:
            from torch.profiler import ProfilerActivity, profile

            done = min(PROFILE_FRAMES, n_frames)
            acts = [ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
            with profile(activities=acts) as prof:
                out = pipelined(fx, done, cfg)
                _sync(dev)
            os.makedirs(prof_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(
                prof_dir, "bench_odometry_trace.json.gz"))
            fx = after(fx, out)
        if done < n_frames:
            k = done % len(staged)
            out = pipelined(fx._replace(frames=staged[k:] + staged[:k]),
                            n_frames - done, cfg)
            fx = after(fx, out)
        _sync(dev)
        fps.append(n_frames / (time.perf_counter() - t0))
        launches.append(_launches() - before)
    return LegRun(max(fps), {
        "loaded_map": loaded, "system_map": sysm.tracker.map_state,
        "start": start, "staged": staged, "out": out, "window_fps": fps,
        "launches": launches})


def bench_accuracy(device="cuda", frames: int | None = None) -> dict:
    """The closed-loop accuracy protocol (`_smoke.accuracy_run`, the twin
    of scripts/bench_accuracy.py) in this process, over its first `frames`
    frames (all 270 by default): the line scripts/bench_accuracy_torch.py
    prints. bench.py runs it in a subprocess with a timeout only to keep
    its TPU runtime from degrading; here nothing needs protecting."""
    import runpy

    from dr_slam_torch._smoke import accuracy_run

    summary_line = runpy.run_path(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "scripts",
        "bench_accuracy_torch.py"))["summary_line"]
    return summary_line(accuracy_run(resolve_device(device), frames=frames,
                                     record=False).summary)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        description="The port's twin of bench.py: prints one JSON line.")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--odometry-frames", type=int, default=240,
                    help="frames per pipelined window (bench.py: 240)")
    ap.add_argument("--windows", type=int, default=3,
                    help="pipelined windows, the best reported (bench.py: 3)")
    ap.add_argument("--interactive-frames", type=int, default=120,
                    help="device-loop frames, warm-up included (bench.py: 120)")
    ap.add_argument("--warm", type=int, default=25,
                    help="device-loop warm-up frames (bench.py: 25)")
    ap.add_argument("--tracking-frames", type=int, default=60,
                    help="System frames, warm-up included (bench.py: 60)")
    ap.add_argument("--accuracy-frames", type=int, default=None,
                    help="frames of the accuracy protocol (default: all 270)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    def note(msg):
        print(f"[bench_torch] {msg}", file=sys.stderr, flush=True)

    t0 = time.perf_counter()
    odo = bench_odometry(args.odometry_frames, device=dev,
                         windows=args.windows)
    note(f"odometry: windows {[round(f, 4) for f in odo.record['window_fps']]}"
         f" frames/s, launches {odo.record['launches']}, "
         f"{time.perf_counter() - t0:.1f} s")
    fps = odo.fps
    out = {
        "metric": "tracking_fps_pipelined_640x480",
        "value": round(fps, 2),
        "unit": "frames/sec",
        # the reference's design point is its 30 frames/s camera
        # (TUM3.yaml:22), as in bench.py
        "vs_baseline": round(fps / 30.0, 3),
    }
    t0 = time.perf_counter()
    inter = bench_interactive_device(args.interactive_frames, args.warm,
                                     device=dev)
    rec = inter.record
    timed = rec["readbacks"][rec["warm"]:]
    note(f"device loop: {inter.fps:.4f} frames/s over "
         f"{len(timed)} timed frames ({rec['seconds']:.2f} s), keyframes "
         f"at {np.nonzero(rec['records'][:, 19])[0].tolist()}, launches "
         f"{int(rec['launches'].sum())}, {time.perf_counter() - t0:.1f} s")
    out["interactive_fps"] = round(inter.fps, 2)
    out["interactive_readbacks_per_frame"] = round(float(np.mean(timed)), 3)
    t0 = time.perf_counter()
    trk = bench_tracking(args.tracking_frames, device=dev)
    rec = trk.record
    note(f"tracking: {trk.fps:.4f} frames/s over "
         f"{len(rec['state']) - rec['warm']} timed frames "
         f"({rec['seconds']:.2f} s), keyframes at {rec['kf_frames'].tolist()}"
         f", launches {int(rec['launches'].sum())}, "
         f"{time.perf_counter() - t0:.1f} s")
    out["interactive_fps_host_readback"] = round(trk.fps, 2)
    t0 = time.perf_counter()
    acc = bench_accuracy(dev, args.accuracy_frames)
    note(f"accuracy: {json.dumps(acc)}, {time.perf_counter() - t0:.1f} s")
    out.update({k: acc[k] for k in ("ate_rmse_m", "ate_rmse_raw_m",
                                    "loops_closed")})
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
