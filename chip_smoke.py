"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and the result line is not printed):
1. build: compiles the CUDA kernel from dr_slam_torch/csrc with nvcc and,
   at the same time, the native frame loader from the same directory with
   g++.
2. kernel: the gated top-2 Hamming kernel against its plain PyTorch version
   at the main path's shapes (K = 1024 keypoints, NC = 32768 candidates), on
   inputs with a few thousand valid candidates and equal-distance ties built
   across chunks, with no valid candidate, and with all 32768 valid; zero
   mismatches are required. The kernel is timed at full occupancy beside its
   bound there.
3. main path: `extract_and_track` at 640x480 (tum_freiburg3 preset) on the
   four fixture frames against the map the JAX package built
   (dr_slam_torch/data/smoke_corridor.npz, made by
   scripts/make_torch_smoke_fixture.py); each frame must launch the kernel
   twice, and T_cw / n_matches / n_inliers must agree with the JAX outputs
   stored in the fixture. The kernel is then held against its plain version
   on the inputs the main path gave it, and timed there: its `ms` is 20
   launches captured into a CUDA graph and replayed 10 times between two
   CUDA events (device time, without the host's ctypes call), beside 200
   eager launches back to back, 200 wrapper calls and 10 calls of the plain
   version, each divided by its count, and the device time of each of its
   three CUDA kernels from torch.profiler. Last, a pipelined
   loop of 64 frames (the four frames cycled, as bench.py's
   bench_odometry does) is timed.
4. tracker: `Tracker(cfg, device="cuda").process_frame` from an empty map
   over the 24 frames of dr_slam_torch/data/mapping_corridor.npz (made by
   scripts/make_torch_mapping_fixture.py), in the default deferred mode
   with a synchronise after each frame: initialization, tracking, the
   keyframe decision, keyframe insertion and the local-mapping pass. Frame
   0 must initialize, every frame be OK, the keyframes fall at the JAX
   tracker's frames, the keyframe count equal the JAX one, the pose and the
   point count stay within the bounds of dr_slam_torch/_smoke.py
   (`tracker_gaps`), and the matcher launch exactly twice per tracked
   frame. Prints each keyframe's stage times (CUDA events around each
   `kf.*` stage), the pass's frames/s and its peak device memory.
5. system: `System(cfg, device="cuda")` loads the map of
   dr_slam_torch/data/reloc_corridor.npz (made by
   scripts/make_torch_reloc_fixture.py; 640x480, the map of frames 0-23)
   and so starts LOST. Scenario A: localization mode over frames 18-29;
   scenario B: loop closing on, frames 24, 25, a black frame, 26-29. States
   and reference keyframes must equal the JAX System's, T_cw and the counts
   stay within the bounds of `system_gaps`, the map is unchanged in A, and
   every relocalized frame launches the matcher. The kernel is then held
   against its plain version on relocalization's inputs: the full-map
   verify, and the wide search without the scale gate (`kp_octave=None`),
   called on the last relocalized frame's features if no candidate needed
   it. Prints the wall ms of each frame, synchronised.
6. loop: `LoopCloser.process` on the call that closed the loop in the JAX
   package's loop scenario (dr_slam_torch/data/loop_small.npz, made by
   scripts/make_torch_loop_fixture.py; that scenario's 320x240 config),
   held to the bounds of `loop_gaps`, then the global BA it dispatches,
   resolved blocking. Prints loop.process and its pose-graph, re-anchoring
   and seam-fuse stages between CUDA events, the BA's host dispatch time and
   its device time on its own stream, and the peak device memory.
7. device loop: `DeviceLoopTracker(cfg, device="cuda")` from an empty map
   over the 24 mapping-fixture frames as the camera gives them (uint8 gray,
   uint16 depth), 2 black frames, then frames 6-11 again (a teleport back
   along the corridor), against the JAX DeviceLoopTracker's records in
   dr_slam_torch/data/device_loop_corridor.npz (made by
   scripts/make_torch_device_loop_fixture.py): states, keyframe flags,
   reference keyframes and their sequences exact, T_cw and the counts
   within `device_loop_gaps`' bounds; the matcher launched twice per
   tracked frame, once more per relocalization attempt (the second black
   frame and the first frame back) and never on init; the kernel against
   its plain version on each attempt's verify inputs. Prints each step,
   wall ms per frame and frames/s (each frame synchronises on the readback
   of its flags), readbacks per frame, each keyframe's `kf.*` stage times
   between CUDA events, the stage profiler's summary of the same spans
   (on for this phase), and the peak device memory.
8. multi-sequence: `MultiSequenceTracker(cfg, 2, device="cuda")` over 12
   steps, sequence 0 on fixture frames 0-11 and sequence 1 on frames 4-15:
   sequence 0 equals phase 7's first 12 records (states, keyframe flags and
   reference keyframes exact, T_cw within 1e-4: the card's scatter-adds are
   atomics), sequence 1 never goes LOST and differs from sequence 0. Prints
   the aggregate frames/s.

9. dataset runner and streaming node: the 24 mapping-fixture frames are
   written as a TUM sequence by the port's `export_tum_sequence` (ground
   truth from dr_slam_torch/data/tum_corridor.npz, made by
   scripts/make_torch_tum_fixture.py) and decoded back by the port's
   Pillow reader and by the native loader (csrc/frame_loader.cpp, built
   with g++ in phase 1); both must equal the fixture's frames exactly.
   Then scripts/run_tum_torch.py's `main` runs on cuda through the native
   loader, synchronised after each frame: states, keyframes and reference
   keyframes equal the JAX runner's, T_cw and counts within `tracker_gaps`'
   bounds, the saved trajectories within the same pose bound, the ATE
   within 1e-3 of JAX's, 2 matcher launches per tracked frame, and the
   kernel against its plain version on both of frame 11's launches;
   `plane_meshes` on the final map beside the JAX mesh's counts. Last, a
   `SlamServer` over `System(cfg, device="cuda")` serves a `CameraClient`
   frames 0-11 on 127.0.0.1 from a thread of its own, then save_map and
   save_occupancy: odometry against the JAX node's within `node_gaps`'
   bounds, the saved map loadable. Prints decode ms per frame, frames/s and
   ms per round trip.

10. detector, cylinders, viewers: (a) `System(cfg, detector=YOLOX(
   input_size=640), live_viewer=True, device="cuda")` (YOLOX-s, the
   seeded random init) over the 24 mapping-fixture frames, fed as phase 9
   decodes them: states, keyframes and reference keyframes exact against
   the JAX System in dr_slam_torch/data/detect_corridor.npz (made by
   scripts/make_torch_detect_fixture.py), T_cw and counts within
   `tracker_gaps`' bounds, 2 matcher launches per tracked frame and the
   kernel against its plain version on both of frame 11's launches; at
   each detector call (keyframes 0, 10 and 22, on frames 0, 11 and 23) the
   decoded candidates within `CAND_TOL` of JAX's, the detections equal, and
   `select` on the JAX candidates at a threshold under the random
   network's scores equal to JAX's. Prints the detector's wall ms per call
   (median of 20, synchronised), its split into resize, network, decode
   and select between CUDA events, the host's greedy NMS, the peak memory,
   the bound, the detector frames beside phase 9's, and cuDNN's error with
   TF32 off and on. (b) the shipped trained weights at 256 over six
   synthetic scenes: the JAX test's gate and every box at IoU > 0.9 from
   JAX's. (c) a cylinder depth map at 640x480: block labels, valid,
   n_cells and cell masks exact, radius, centre and axis within `CYL_TOL`,
   also through `extract_frame` with `detect_cylinders`. (d) the live
   viewer of (a) serves /state.json with the map's counts; where matplotlib
   is installed, /map.png, `Viewer.render_map` and `draw_frame_overlay`
   write PNGs.

Phases 3-4 and 6-9 run with the shipped codebooks registered, as the JAX
runs that made the fixtures had them (a bare Tracker or DeviceLoopTracker
registers none; the System registers them itself).

The kernel table's `launches` adds the main path's, the tracker's, the two
System scenarios', the loop phase's, the device loop's, the multi-sequence
phase's, the runner's and node's and the detector System's.

The line before the last is the card's name and power limit; the kernel
table is one JSON line before it; the last line is the result object."""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


# Tolerances against the JAX outputs (computed on a CPU in float32). The JAX
# package's build_pyramid is jitted, and inside that jit XLA computes the
# antialiased resize weights with its own float32 rounding: its level 1 lies
# up to 2.5e-3 grey levels from float64, the port's within 3e-5. That reorders
# keypoints whose FAST responses are near-tied: on a CPU the port differs from
# the JAX outputs in 28 of 1024 match slots and by one match on the first
# fixture frame, and with the JAX pyramid swapped in it matches exactly
# (tests/test_torch_fixture_parity.py). The card also sums in another order
# (cuBLAS / reductions), so poses differ by float rounding that the four
# chained frames and the iterative pose solve carry forward. A count may move
# by 2%.
T_TOL = 1e-3          # max |T_cw - T_cw_jax| entry (rotation, meters)
COUNT_TOL = 0.02      # |n_matches - jax|, |n_inliers - jax| over the jax count
# 64, not bench_odometry's 240: at about 1 s a frame on the host, the
# loop would take most of the run's time limit as the phases grow
PIPELINE_FRAMES = 64

# Where the TPU kernel that the CUDA kernel replaces lives, in the JAX
# reference package. The package name is assembled so that a search of this
# script for imports of that package finds nothing: it imports none of it.
REPLACES = "dr_slam_" + "tpu/ops/match_pallas.py:112"

H100_BYTES_PER_S = 3.35e12     # HBM3 rate, H100 SXM data sheet
H100_INT8_OPS_PER_S = 1979e12  # dense int8 tensor-core rate
H100_FP32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (TF32 off)


def _time_ms(fn, reps: int, torch) -> float:
    """Device time per call: one pair of CUDA events around `reps` calls
    enqueued back to back, after two warm-up calls."""
    for _ in range(2):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, reps: int, torch) -> float:
    """Device time per call without the host's enqueue: `reps` calls
    captured into one CUDA graph, one CUDA event pair around 10 replays,
    divided by 10 * reps."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(10):
        g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / (10 * reps)


MATCHER_KERNELS = ("compact_tile_kernel", "tile_kernel", "merge_kernel")


def _device_split(fn, reps: int, torch) -> dict:
    """Device time per call (ms) of each of the matcher's CUDA kernels, from
    torch.profiler's CUDA activity over `reps` calls after one warm-up."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = dict.fromkeys(MATCHER_KERNELS, 0.0)
    for e in prof.events():
        name = next((k for k in MATCHER_KERNELS if k in e.name), None)
        if name is not None and e.device_type == torch.autograd.DeviceType.CUDA:
            split[name] += e.time_range.elapsed_us() / 1e3 / reps
    return split


def _compare(out_k, out_r, torch) -> tuple[dict, float]:
    names = ("best", "idx", "second", "colk")
    mism = {n: int((a != b).sum()) for n, a, b in zip(names, out_k, out_r)}
    err = 0.0
    for a, b in ((out_k[0], out_r[0]), (out_k[2], out_r[2])):
        fin = torch.isfinite(a) & torch.isfinite(b)
        if bool(fin.any()):
            err = max(err, float((a[fin] - b[fin]).abs().max()))
    return mism, err


def _bound(args) -> tuple[float, str]:
    """Least time for the matcher's work on these inputs. Bytes: every
    candidate's valid flag is read and its colk written; a valid
    candidate's descriptor, position, radius, level and scale flag are
    read; the keypoints' descriptor, position, validity and octave are read
    and their best, second and idx written. Operations: the binary dot
    product of every keypoint with every valid candidate, 2 * 256 int8
    operations each, at the int8 tensor-core rate."""
    kp_desc, pt_desc, pt_valid = args[0], args[4], args[9]
    K, NC = kp_desc.shape[0], pt_desc.shape[0]
    n_valid = int(pt_valid.sum())
    nbytes = NC * (1 + 4) + n_valid * (32 + 8 + 4 + 4 + 1) \
        + K * (32 + 8 + 1 + 4) + K * 12
    ops = 2.0 * K * n_valid * 256
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_INT8_OPS_PER_S * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def _stream_ms(torch, dev, fn):
    """(fn's result, ms between two CUDA events around it after a
    synchronise; on the CPU, wall ms)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    torch.cuda.synchronize()
    return out, a.elapsed_time(b)


def system_phase(dev, cfg, card: str) -> tuple[dict, float]:
    """Phase 5: scenarios A and B of the reloc fixture through `System`, and
    the kernel against its plain version on relocalization's inputs. ->
    (matcher launches per scenario, the kernel's max abs error)."""
    import numpy as np
    import torch

    from dr_slam_torch._smoke import (RELOC_FIXTURE, load_npz, run_system,
                                      save_fixture_map, system_gaps)
    from dr_slam_torch.frontend.frame import extract_frame
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam import map_ops

    data = load_npz(RELOC_FIXTURE)
    first = int(data["first_frame"])
    launches, captured, runs = {}, [], {}
    with tempfile.TemporaryDirectory() as tmp:
        map_path = os.path.join(tmp, "map.npz")
        save_fixture_map(data, map_path)
        for name in ("a", "b"):
            frames = [int(f) for f in data[f"{name}__frame"]]
            match_cuda.gated_top2_hamming.launches = 0
            run = run_system(data, name, cfg, dev, map_path, capture=True)
            launches[name] = match_cuda.gated_top2_hamming.launches
            runs[name] = run
            gaps, fails = system_gaps(run, data, name)
            what = ("localization mode" if name == "a"
                    else "loop closing on, a black frame")
            for i, r in enumerate(run.results):
                print(f"[system {name}] frame {frames[i]}: {r.state.name} "
                      f"ref_kf {run.ref_kf[i]} (jax "
                      f"{int(data[f'{name}__ref_kf'][i])}) n_inliers "
                      f"{r.n_inliers} (jax {int(data[f'{name}__n_inliers'][i])})"
                      f" launches {run.launches[i]} {run.ms[i]:.1f} ms"
                      + (" relocalized" if run.reloc[i] else ""), flush=True)
            reloc_ms = [ms for ms, rel in zip(run.ms, run.reloc) if rel]
            print(f"[system {name}] {what}: {json.dumps(gaps)}; relocalized "
                  "frames at " + ", ".join(f"{ms:.1f}" for ms in reloc_ms)
                  + f" ms (synchronised, wall) on {card}; matcher launches "
                  f"{launches[name]}", flush=True)
            if not reloc_ms:
                fail(f"system {name}: no frame relocalized")
            # (the count is the kernel's: on the CPU the plain version runs)
            if dev.type == "cuda" and any(
                    rel and n < 1 for rel, n in zip(run.reloc, run.launches)):
                fail(f"system {name}: a relocalized frame did not launch the "
                     f"matcher: {run.launches}")
            if fails:
                fail(f"system {name} disagrees with the JAX System: "
                     + "; ".join(fails))
            captured += run.matcher_calls
    # the kernel on relocalization's own inputs: the full-map verify, and
    # the wide search without the scale gate (kp_octave=None); where no
    # candidate needed the wide search, it is called here on the last
    # relocalized frame's features, from the pose it relocalized to
    checks = [("verify", next(a for _, wide, a in reversed(captured)
                              if not wide))]
    wide = [a for _, w, a in captured if w]
    if not wide:
        run = runs["b"]
        i = max(k for k, rel in enumerate(run.reloc) if rel)
        frame = int(data["b__frame"][i])
        gray = torch.from_numpy(data["gray"][frame - first]
                                .astype(np.float32)).to(dev)
        depth = torch.from_numpy((data["depth"][frame - first]
                                  / cfg.camera.depth_factor)
                                 .astype(np.float32)).to(dev)
        feats = extract_frame(gray, depth, cfg, dev)
        T = torch.from_numpy(np.asarray(run.results[i].T_cw,
                                        np.float32)).to(dev)
        kernel = map_ops.gated_top2_hamming

        def keep(*a):
            wide.append(tuple(x.clone() for x in a))
            return kernel(*a)
        map_ops.gated_top2_hamming = keep
        try:
            map_ops.match_points_projection(
                run.system.tracker.map_state, feats.kp.uv, feats.kp.desc,
                feats.kp.valid, T, cfg.camera.K4, radius=10.0,
                max_hamming=map_ops.TH_HIGH, width=cfg.camera.width,
                height=cfg.camera.height, kp_angle=feats.kp.angle)
        finally:
            map_ops.gated_top2_hamming = kernel
        print(f"[system] no candidate took the wide search; it was called "
              f"on frame {frame}'s features", flush=True)
    checks.append(("wide, kp_octave=None", wide[-1]))
    err = 0.0
    for name, a in checks:
        out_k = match_cuda.gated_top2_hamming(*a)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out_r = match_cuda.gated_top2_hamming_ref(*a)
        mism, e = _compare(out_k, out_r, torch)
        print(f"[kernel] relocalization {name}: K={a[0].shape[0]} "
              f"NC={a[4].shape[0]} valid={int(a[9].sum())} scale-gated "
              f"{int((a[8] & a[9]).sum())} mismatches={mism} "
              f"max_abs_err={e}", flush=True)
        if any(mism.values()):
            fail(f"kernel disagrees with its plain version ({name}): {mism}")
        err = max(err, e)
    return launches, err


def loop_phase(dev, card: str) -> int:
    """Phase 6: `LoopCloser.process` on the loop fixture's firing call and
    the global BA it dispatches, against the JAX run. -> matcher launches."""
    import numpy as np
    import torch

    from dr_slam_torch._smoke import (LOOP_FIXTURE, LOOP_GBA_TOL, load_npz,
                                      loop_call, loop_closer, loop_gaps,
                                      loop_small_cfg)
    from dr_slam_torch.io.map_io import from_jax_state
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam.loop_closing import LoopCloser

    cuda = dev.type == "cuda"
    data = load_npz(LOOP_FIXTURE)
    call = loop_call(data, "fire")
    st = from_jax_state(call["state"], dev)
    lc = loop_closer(LoopCloser, loop_small_cfg(), call, device=dev)
    lc.stage_events = []
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
    match_cuda.gated_top2_hamming.launches = 0
    t0 = time.perf_counter()
    (new, fired), ms = _stream_ms(
        torch, dev, lambda: lc.process(st, call["cur_kf"], call["odom"]))
    wall = (time.perf_counter() - t0) * 1e3
    launches = match_cuda.gated_top2_hamming.launches
    gaps, fails = loop_gaps(data, call, lc, st, new, fired)
    stages = ", ".join(f"{n} {a.elapsed_time(b):.2f} ms"
                       for n, a, b in lc.stage_events)
    print(f"[loop] loop.process {ms:.2f} ms between CUDA events ({wall:.1f} "
          f"ms wall), of which {stages or 'stages not timed on the CPU'}, on "
          f"{card}; matcher launches {launches}", flush=True)
    print(f"[loop] against the JAX correction: {json.dumps(gaps)}", flush=True)
    if fails:
        fail("loop closing disagrees with the JAX run: " + "; ".join(fails))
    lc.dispatch_gba(new, guard_gen=0)
    merged = lc.resolve_gba(new, guard_gen=0, block=True)
    gba = "not measured on the CPU"
    if cuda:
        torch.cuda.synchronize()
        gba = (f"{lc.gba_events[0].elapsed_time(lc.gba_events[1]):.1f} ms "
               "between CUDA events on its stream")
    gba_gaps = {f: float(np.abs(getattr(merged, f).cpu().numpy()
                                - data[f"gba__{f}"]).max())
                for f in LOOP_GBA_TOL}
    peak = (f"{(torch.cuda.max_memory_allocated() - held) / 2 ** 30:.3f} GiB"
            if cuda else "not measured")
    print(f"[loop] global BA: host dispatch {lc.dispatch_seconds * 1e3:.1f} "
          f"ms, device {gba}; against the JAX one {json.dumps(gba_gaps)}; "
          f"peak device memory {peak} above what the earlier phases held, "
          f"on {card}", flush=True)
    bad = [f for f, tol in LOOP_GBA_TOL.items() if gba_gaps[f] > tol]
    if bad:
        fail(f"global BA disagrees with the JAX one in {bad}")
    return launches


def device_loop_phase(dev, cfg, card: str) -> tuple[int, float, object]:
    """Phase 7: the DeviceLoopTracker at full width over the mapping
    fixture's frames, 2 black frames and frames 6-11 again, against the JAX
    run in the device-loop fixture; the kernel against its plain version
    on `_reloc_attempt`'s verify inputs. -> (matcher launches, the kernel's
    max abs error, the run)."""
    import numpy as np
    import torch

    from dr_slam_torch._smoke import (DEVICE_LOOP_FIXTURE, device_loop_gaps,
                                      expected_launches, load_mapping_fixture,
                                      load_npz, run_device_loop)
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.utils.profiling import PROFILER

    data = load_npz(DEVICE_LOOP_FIXTURE)
    order = [int(i) for i in data["frame"]]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    match_cuda.gated_top2_hamming.launches = 0
    PROFILER.reset()
    PROFILER.enable()
    try:
        run = run_device_loop(load_mapping_fixture(), order, cfg, dev,
                              capture=True)
    finally:
        PROFILER.disable()
    launches = match_cuda.gated_top2_hamming.launches
    profile = PROFILER.summary()
    PROFILER.reset()
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    tr = run.tracker
    states = run.flushed["states"]
    recs, want = run.flushed["records"], data["records"]
    for n, i in enumerate(order):
        print(f"[device loop] step {n} (frame {i}): {states[n]} n_inliers "
              f"{int(recs[n, 17])} (jax {int(want[n, 17])}) n_matches "
              f"{int(recs[n, 18])} (jax {int(want[n, 18])}) kf "
              f"{int(recs[n, 19])} ref_kf {int(recs[n, 20])} (jax "
              f"{int(want[n, 20])}) launches {run.launches[n]} readbacks "
              f"{tr.readbacks[n]}" + (" relocalization attempted"
                                      if tr.relocs[n] else "")
              + f" {run.ms[n]:.1f} ms", flush=True)
    for k, stages in enumerate(run.keyframes):
        total = sum(ms for _, ms in stages)
        print(f"[device loop] keyframe {k}: " + ", ".join(
            f"{name} {ms:.2f} ms" for name, ms in stages)
            + f"; total {total:.2f} ms between CUDA events on {card}",
            flush=True)
    print(f"[device loop] stage profiler (CUDA events, read after one "
          f"synchronise): {json.dumps(profile)}", flush=True)
    n_kf = int(recs[:, 19].sum())
    if profile.get("kf.add", {}).get("count") != n_kf:
        fail(f"device loop: the stage profiler holds {profile}, not {n_kf} "
             "kf.add spans")
    seconds = sum(run.ms) / 1e3
    print(f"[device loop] {len(order)} frames in {seconds:.2f} s = "
          f"{len(order) / seconds:.3f} frames/s ({seconds / len(order) * 1e3:.1f}"
          f" ms/frame wall; each frame synchronises on its flags' readback), "
          f"readbacks per frame {json.dumps(tr.readbacks)}, peak device "
          f"memory {peak_gib:.3f} GiB above what the earlier phases held, "
          f"on {card}", flush=True)
    gaps, fails = device_loop_gaps(run, data)
    print(f"[device loop] against the JAX DeviceLoopTracker: "
          f"{json.dumps(gaps)}; jax n_keyframes {int(data['n_keyframes'])} "
          f"n_pts {int(data['n_pts'])}; matcher launches {launches}",
          flush=True)
    want_launches = expected_launches(states, tr.relocs)
    if run.launches != want_launches or launches != sum(want_launches):
        fail(f"device loop: matcher launches {run.launches}, expected "
             f"{want_launches}")
    if not tr.relocs[order.index(-1) + 1]:
        fail("device loop: the second black frame attempted no "
             "relocalization")
    if fails:
        fail("device loop disagrees with the JAX run: " + "; ".join(fails))
    if not np.isfinite(recs).all():
        fail("device loop: non-finite records")
    # the kernel on the verify of every relocalization attempt
    err = 0.0
    for n, a in zip([n for n, r in enumerate(tr.relocs) if r],
                    run.verify_calls):
        out_k = match_cuda.gated_top2_hamming(*a)
        torch.cuda.synchronize()
        out_r = match_cuda.gated_top2_hamming_ref(*a)
        mism, e = _compare(out_k, out_r, torch)
        print(f"[kernel] device-loop relocalization verify, step {n}: "
              f"K={a[0].shape[0]} NC={a[4].shape[0]} valid={int(a[9].sum())} "
              f"keypoints {int(a[2].sum())} mismatches={mism} "
              f"max_abs_err={e}", flush=True)
        if any(mism.values()):
            fail(f"kernel disagrees with its plain version (device-loop "
                 f"verify, step {n}): {mism}")
        err = max(err, e)
    if len(run.verify_calls) != sum(tr.relocs):
        fail(f"{sum(tr.relocs)} relocalization attempts but "
             f"{len(run.verify_calls)} verify launches")
    return launches, err, run


MULTI_STEPS = 12
MULTI_OFFSET = 4      # sequence 1 starts at this fixture frame


def multi_seq_phase(dev, cfg, card: str, loop_run) -> int:
    """Phase 8: MultiSequenceTracker(cfg, 2) over 12 steps, sequence 0 on
    fixture frames 0-11, sequence 1 on frames 4-15; sequence 0 against
    phase 7's first 12 records. -> matcher launches."""
    import numpy as np
    import torch

    from dr_slam_torch._smoke import load_mapping_fixture
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.parallel.multi_seq import MultiSequenceTracker

    mdata = load_mapping_fixture()
    tr = MultiSequenceTracker(cfg, 2, device=dev)
    match_cuda.gated_top2_hamming.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(MULTI_STEPS):
        idx = [i, i + MULTI_OFFSET]
        tr.track(mdata["gray"][idx], mdata["depth"][idx], [i / 30.0] * 2)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = match_cuda.gated_top2_hamming.launches
    f = tr.flush()
    ref = loop_run.flushed["records"][:MULTI_STEPS]
    s0, s1 = f[0]["records"], f[1]["records"]
    dT = float(np.abs(s0[:, :16] - ref[:, :16]).max())
    trans = [3, 7, 11]                  # T_cw's translation in a record
    spread = float(np.abs(s1[:, trans] - s0[:, trans]).max())
    print(f"[multi] 2 sequences x {MULTI_STEPS} steps in {seconds:.2f} s = "
          f"{2 * MULTI_STEPS / seconds:.3f} frames/s aggregate (one stream), "
          f"on {card}; states {f[0]['states'].count('OK')} / "
          f"{f[1]['states'].count('OK')} OK, keyframes "
          f"{f[0]['n_keyframes']} / {f[1]['n_keyframes']}, sequence 0 vs "
          f"phase 7 |dT_cw| {dT:.2e}, sequences apart by {spread:.3f} m; "
          f"readbacks per step {json.dumps(tr.readbacks)}; matcher launches "
          f"{launches}", flush=True)
    for k, name in ((16, "states"), (19, "is_kf"), (20, "ref_kf")):
        if not np.array_equal(s0[:, k], ref[:, k]):
            fail(f"multi: sequence 0's {name} differ from phase 7's")
    if dT > 1e-4:
        fail(f"multi: sequence 0 |dT_cw| {dT:.2e} > 1e-4 from phase 7")
    if "LOST" in f[1]["states"] or spread < 1e-3:
        fail(f"multi: sequence 1 {f[1]['states']}, apart by {spread}")
    want = sum(2 * f[s]["states"][1:].count("OK") for s in range(2))
    if launches != want:
        fail(f"multi: {launches} matcher launches, expected {want}")
    return launches


# plane_meshes' vertex and face counts on the runner's final map against the
# JAX runner's: the plane clouds are placed by poses within TRACKER_T_TOL,
# so a sample near a 10 cm cell border may change cells (on the CPU the
# counts are equal).
MESH_TOL = 0.05
CHECK_FRAME = 11      # the runner's frame whose matcher inputs are kept


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _hold_kept(kept: list, path: str, torch, dev) -> float:
    """The kernel against its plain version on both matcher launches that
    `path` made on CHECK_FRAME. -> the largest abs error."""
    from dr_slam_torch.ops import match_cuda

    if len(kept) != 2:
        fail(f"{path}: {len(kept)} matcher calls kept on frame "
             f"{CHECK_FRAME}, expected 2")
    err = 0.0
    for stage, a in enumerate(kept, 1):
        out_k = match_cuda.gated_top2_hamming(*a)
        _sync(torch, dev)
        out_r = match_cuda.gated_top2_hamming_ref(*a)
        mism, e = _compare(out_k, out_r, torch)
        print(f"[kernel] {path} frame {CHECK_FRAME} stage {stage}: "
              f"K={a[0].shape[0]} NC={a[4].shape[0]} valid={int(a[9].sum())} "
              f"mismatches={mism} max_abs_err={e}", flush=True)
        if any(mism.values()):
            fail(f"kernel disagrees with its plain version ({path} frame "
                 f"{CHECK_FRAME} stage {stage}): {mism}")
        err = max(err, e)
    return err


def tum_phase(dev, cfg, card: str) -> tuple[dict, dict]:
    """Phase 9: the mapping fixture's frames exported as a TUM sequence and
    decoded back, scripts/run_tum_torch.py over them, and a streaming-node
    session over frames 0-11, against the JAX runner and node in the TUM
    fixture. -> (matcher launches by part, the numbers printed)."""
    import importlib.util

    import numpy as np
    import torch

    from dr_slam_torch._smoke import (NODE_FRAMES, TUM_T0, TrackerRun,
                                      TRACKER_T_TOL, export_fixture_sequence,
                                      load_mapping_fixture, load_tum_fixture,
                                      node_frames, node_gaps, node_session,
                                      read_tum_rows, track_rgbd_hook,
                                      tracker_gaps)
    from dr_slam_torch.io import map_io, transport, tum
    from dr_slam_torch.io.mesh_export import plane_meshes
    from dr_slam_torch.io.native_loader import NativeTUMLoader
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.system import System

    data, mdata = load_tum_fixture(), load_mapping_fixture()
    factor = cfg.camera.depth_factor
    n = len(mdata["gray"])
    want_gray = mdata["gray"].astype(np.float32)
    want_depth = mdata["depth"].astype(np.float32) / np.float32(factor)
    root = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "run_tum_torch", os.path.join(root, "scripts", "run_tum_torch.py"))
    runner = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(runner)
    launches, numbers = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        seq = export_fixture_sequence(tum.export_tum_sequence,
                                      os.path.join(tmp, "seq"), mdata,
                                      data["gt_T_cw"], factor)
        # --- decode: the Pillow reader and the native loader -----------------
        ds = tum.TUMDataset(seq, depth_factor=factor)
        t0 = time.perf_counter()
        frames = [ds[i] for i in range(len(ds))]
        numbers["reader_ms"] = (time.perf_counter() - t0) * 1e3 / len(ds)
        t0 = time.perf_counter()
        loader = NativeTUMLoader(ds)
        try:
            native = [(i, g, d) for i, _, g, d in loader]
        finally:
            loader.close()
        numbers["native_ms"] = (time.perf_counter() - t0) * 1e3 / len(ds)
        bad = [i for i, f in enumerate(frames)
               if not (np.array_equal(f.gray, want_gray[i])
                       and np.array_equal(f.depth, want_depth[i]))]
        bad += [i for i, g, d in native
                if not (np.array_equal(g, want_gray[i])
                        and np.array_equal(d, want_depth[i]))]
        print(f"[tum] {len(ds)} frames exported and decoded back at "
              f"{frames[0].gray.shape[1]}x{frames[0].gray.shape[0]}: reader "
              f"{numbers['reader_ms']:.2f} ms/frame, native loader "
              f"{numbers['native_ms']:.2f} ms/frame (host wall, prefetch "
              f"thread included); frames differing from the fixture's: {bad}",
              flush=True)
        if bad or len(native) != n or len(ds) != n:
            fail(f"tum: decoded frames differ from the fixture's: {bad}")

        # --- the dataset runner ----------------------------------------------
        # each frame synchronised and timed after System.track_rgbd; the
        # matcher's inputs on CHECK_FRAME kept (the count stays the
        # wrapper's own)
        results, ref_kf, per_frame, ms, box = [], [], [], [], {}
        last = [time.perf_counter(), 0]
        kept, kernel = [], map_ops.gated_top2_hamming

        def on_frame(res, system):
            _sync(torch, dev)
            now = time.perf_counter()
            ms.append((now - last[0]) * 1e3)
            per_frame.append(match_cuda.gated_top2_hamming.launches - last[1])
            last[:] = [now, match_cuda.gated_top2_hamming.launches]
            results.append(res)
            ref_kf.append(system.tracker.ref_kf)
            box["system"] = system

        def keep(*a):
            if len(results) == CHECK_FRAME:
                kept.append(tuple(x.clone() for x in a))
            return kernel(*a)

        out_dir = os.path.join(tmp, "out")
        match_cuda.gated_top2_hamming.launches = 0
        map_ops.gated_top2_hamming = keep
        t0 = time.perf_counter()
        last[0] = t0
        try:
            with track_rgbd_hook(on_frame), \
                    contextlib.redirect_stdout(io.StringIO()):   # its JSON
                summary = runner.main([seq, "--out", out_dir,
                                       "--native-loader", "--device",
                                       dev.type])
        finally:
            map_ops.gated_top2_hamming = kernel
        seconds = time.perf_counter() - t0
        launches["runner"] = match_cuda.gated_top2_hamming.launches
        system = box["system"]
        run = TrackerRun(results, system.tracker, per_frame, sum(ms) / 1e3, [])
        view = {k[len("run__"):]: v for k, v in data.items()
                if k.startswith("run__")}
        gaps, fails = tracker_gaps(run, view, t0=TUM_T0)
        jsum = json.loads(str(data["run__summary"]))
        gaps["d_ate"] = abs(summary["ate_rmse_m"] - jsum["ate_rmse_m"])
        for name, key in (("CameraTrajectory.txt", "run__camera_traj"),
                          ("KeyFrameTrajectory.txt", "run__kf_traj")):
            rows, want = read_tum_rows(os.path.join(out_dir, name)), data[key]
            if rows.shape != want.shape or not np.array_equal(rows[:, 0],
                                                              want[:, 0]):
                fails.append(f"{name}: rows {rows.shape}, JAX {want.shape}")
                continue
            gaps[name] = float(np.abs(rows[:, 1:] - want[:, 1:]).max())
            if gaps[name] > TRACKER_T_TOL:
                fails.append(f"{name} off by {gaps[name]:.2e}")
        if ref_kf != data["run__ref_kf"].tolist():
            fails.append(f"ref_kf {ref_kf}, JAX {data['run__ref_kf'].tolist()}")
        if gaps["d_ate"] > 1e-3:
            fails.append(f"ATE {summary['ate_rmse_m']}, JAX "
                         f"{jsum['ate_rmse_m']}")
        if summary["n_keyframes"] != jsum["n_keyframes"]:
            fails.append(f"summary {summary}, JAX {jsum}")
        v, f, _ = plane_meshes(system.tracker.map_state)
        for got, key in ((len(v), "mesh__n_verts"), (len(f), "mesh__n_faces")):
            if abs(got - int(data[key])) > MESH_TOL * int(data[key]):
                fails.append(f"plane_meshes: {got} against JAX "
                             f"{int(data[key])} ({key})")
        numbers.update(runner_fps=n / sum(ms) * 1e3, runner_s=seconds,
                       mesh=(len(v), len(f)), frame_ms=ms)
        for i, r in enumerate(results):
            print(f"[tum] frame {i}: {r.state.name} ref_kf {ref_kf[i]} (jax "
                  f"{int(data['run__ref_kf'][i])}) n_inliers {r.n_inliers} "
                  f"(jax {int(data['run__n_inliers'][i])}) launches "
                  f"{per_frame[i]} {ms[i]:.1f} ms", flush=True)
        print(f"[tum] run_tum_torch.py: {json.dumps(summary)} (JAX "
              f"{json.dumps(jsum)}); {n} frames in {sum(ms) / 1e3:.2f} s = "
              f"{numbers['runner_fps']:.3f} frames/s synchronised per frame "
              f"({seconds:.2f} s with start-up, shutdown and the files) on "
              f"{card}; against the JAX runner {json.dumps(gaps)}; "
              f"plane_meshes {len(v)} vertices {len(f)} faces (JAX "
              f"{int(data['mesh__n_verts'])} / {int(data['mesh__n_faces'])});"
              f" matcher launches {launches['runner']}", flush=True)
        want_launches = [0] + [2] * (n - 1)
        if dev.type == "cuda" and per_frame != want_launches:
            fail(f"tum runner: matcher launches {per_frame}, expected "
                 f"{want_launches}")
        if fails:
            fail("tum runner disagrees with the JAX runner: "
                 + "; ".join(fails))
        # the kernel on the runner's own inputs: both launches of CHECK_FRAME
        numbers["max_abs_err"] = _hold_kept(kept, "runner", torch, dev)

        # --- the streaming node ----------------------------------------------
        server = transport.SlamServer(System(cfg, device=dev))
        map_path = os.path.join(tmp, "node_map.npz")
        match_cuda.gated_top2_hamming.launches = 0
        try:
            with track_rgbd_hook(lambda res, system: _sync(torch, dev)):
                sess = node_session(transport, server,
                                    node_frames(mdata, factor),
                                    map_path=map_path)
        finally:
            server.close()
        launches["node"] = match_cuda.gated_top2_hamming.launches
        gaps, fails = node_gaps(sess, data)
        loaded = map_io.load_map(map_path, cfg, dev)
        rt = sess["ms"]
        numbers["node_ms"] = float(np.median(rt))
        print(f"[node] {len(rt)} frames through SlamServer on "
              f"{'%s:%d' % server.address}: round trip "
              + ", ".join(f"{x:.1f}" for x in rt)
              + f" ms (median {numbers['node_ms']:.1f} ms, each frame "
              f"synchronised) on {card}; states "
              f"{[o['state'] for o in sess['odom']]}; save_map "
              f"{sess['saved']} ({int(loaded.n_kfs)} keyframes loaded back); "
              f"save_occupancy {json.dumps(sess['occ_status'])}; against the "
              f"JAX node {json.dumps(gaps)}; matcher launches "
              f"{launches['node']}", flush=True)
        if sess["saved"] != {"ok": True, "cmd": "save_map"} or \
                int(loaded.n_kfs) < 1:
            fails.append(f"save_map: {sess['saved']}")
        if dev.type == "cuda" and launches["node"] != 2 * (NODE_FRAMES - 1):
            fails.append(f"node: {launches['node']} matcher launches, "
                         f"expected {2 * (NODE_FRAMES - 1)}")
        if fails:
            fail("node disagrees with the JAX node: " + "; ".join(fails))
    return launches, numbers


DETECT_REPS = 20      # timed detector calls, after 2 warm-up calls


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _fetch(port: int, path: str) -> tuple[int, bytes]:
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def detect_phase(dev, cfg, card: str, runner_ms=None) -> tuple[int, dict]:
    """Phase 10: the System with YOLOX-s at 640 over the mapping fixture's
    frames (10a), the shipped trained detector (10b), the cylinders at
    640x480 (10c) and the viewers (10d), against the JAX runs in the detect
    fixture. runner_ms: phase 9's per-frame wall ms, to set the keyframe
    frames beside. -> (matcher launches in 10a, the numbers printed)."""
    import importlib.util

    import numpy as np
    import torch
    import torch.nn.functional as F

    from dr_slam_torch._smoke import (SYNTH_WEIGHTS, TUM_T0, TrackerRun,
                                      box_iou, candidate_gaps, cylinder_gaps,
                                      detection_gaps, detections_numpy,
                                      load_detect_fixture,
                                      load_mapping_fixture, synth_gate,
                                      tracker_gaps, yolox_macs)
    from dr_slam_torch.frontend.frame import extract_frame
    from dr_slam_torch.models import yolox
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.ops.cylinders import segment_cylinders
    from dr_slam_torch.ops.planes import segment_planes
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.system import System
    from dr_slam_torch.viz.viewer import Viewer, draw_frame_overlay

    cuda = dev.type == "cuda"
    data, mdata = load_detect_fixture(), load_mapping_fixture()
    n = len(mdata["gray"])
    factor = np.float32(cfg.camera.depth_factor)
    frames = [(torch.from_numpy(mdata["gray"][i].astype(np.float32)).to(dev),
               torch.from_numpy(mdata["depth"][i].astype(np.float32)
                                / factor).to(dev)) for i in range(n)]
    numbers = {}

    # --- 10a: the System with YOLOX-s at 640 on the runner's frames ---------
    results, ref_kf, ms, per_frame, calls, kept = [], [], [], [], [], []

    class Recording(yolox.YOLOX):
        def detect(self, rgb):
            out = super().detect(rgb)
            calls.append((len(results), rgb, out))
            return out

    kernel = map_ops.gated_top2_hamming

    def keep(*a):
        if len(results) == CHECK_FRAME:
            kept.append(tuple(x.clone() for x in a))
        return kernel(*a)

    det = Recording(input_size=640, device=dev)
    system = System(cfg, detector=det, live_viewer=True, device=dev)
    live = system._live
    live.every, live.min_period = n, 0.0     # one render: the last frame's
    match_cuda.gated_top2_hamming.launches = 0
    map_ops.gated_top2_hamming = keep
    try:
        for i, (g, d) in enumerate(frames):
            before = match_cuda.gated_top2_hamming.launches
            t0 = time.perf_counter()
            results.append(system.track_rgbd(g, d, TUM_T0 + i / 30.0))
            _sync(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            per_frame.append(match_cuda.gated_top2_hamming.launches - before)
            ref_kf.append(system.tracker.ref_kf)
    finally:
        map_ops.gated_top2_hamming = kernel
    launches = match_cuda.gated_top2_hamming.launches
    live.flush()      # its worker's render competes with the timings below
    st = system.tracker.map_state
    counts = {"n_keyframes": int(st.kf_valid.sum()),
              "n_points": int(st.pt_valid.sum()),
              "n_planes": int(st.pl_valid.sum())}
    system.tracker.flush()
    view = {k[len("run__"):]: v for k, v in data.items()
            if k.startswith("run__")}
    gaps, fails = tracker_gaps(TrackerRun(results, system.tracker, per_frame,
                                          sum(ms) / 1e3, []), view, t0=TUM_T0)
    if ref_kf != view["ref_kf"].tolist():
        fails.append(f"ref_kf {ref_kf}, JAX {view['ref_kf'].tolist()}")
    if [c[0] for c in calls] != data["det__frame"].tolist():
        fails.append(f"detector called on frames {[c[0] for c in calls]}, "
                     f"JAX {data['det__frame'].tolist()}")
    for i, r in enumerate(results):
        print(f"[detect] frame {i}: {r.state.name} ref_kf {ref_kf[i]} (jax "
              f"{int(view['ref_kf'][i])}) n_inliers {r.n_inliers} (jax "
              f"{int(view['n_inliers'][i])}) launches {per_frame[i]} "
              f"{ms[i]:.1f} ms" + (" detector" if i in data["det__frame"]
                                   else ""), flush=True)
    print(f"[detect] System with YOLOX-s at 640 over {n} frames: against the "
          f"JAX System {json.dumps(gaps)}; matcher launches {launches}",
          flush=True)
    want_launches = [0] + [2] * (n - 1)
    if cuda and per_frame != want_launches:
        fails.append(f"matcher launches {per_frame}, expected {want_launches}")
    low_th = [float(x) for x in data["low_th"]]
    for k, (frame, rgb, out) in enumerate(calls[:len(data["det__frame"])]):
        cand = yolox.decode(det.heads(det.resize(rgb))).cpu().numpy()
        cgaps, cfails = candidate_gaps(cand, data["det__cand"][k],
                                       data["det__class_margin"][k])
        want = {f: data[f"det__{f}"][k] for f in ("boxes", "scores",
                                                  "classes", "valid")}
        dgaps, dfails = detection_gaps(detections_numpy(out), want)
        # select on the JAX candidates, below the random network's scores
        low = detections_numpy(yolox.select(
            torch.from_numpy(data["det__cand"][k]).to(dev), *low_th))
        lfails = [f"select at {low_th}: {f} differs" for f in low
                  if not np.array_equal(low[f], data[f"low__{f}"][k])]
        print(f"[detect] keyframe call {k} (frame {frame}): candidates "
              f"{json.dumps(cgaps)}; detections {json.dumps(dgaps)}; select "
              f"at score {low_th[0]:.3f} IoU {low_th[1]:.2f} on the JAX "
              f"candidates: "
              f"{int(low['valid'].sum())} kept, "
              f"{'equal' if not lfails else 'DIFFERENT'}", flush=True)
        fails += [f"call {k}: {f}" for f in cfails + dfails + lfails]
    if fails:
        fail("detector System disagrees with the JAX run: " + "; ".join(fails))
    numbers["max_abs_err"] = _hold_kept(kept, "detector System", torch, dev)

    # the detector alone on the last keyframe call's input, detect's four
    # steps one after the other: wall per call (synchronised), the split
    # between CUDA events in the same calls, the host's NMS pass, the peak
    # memory, and cuDNN's float32 against TF32
    rgb = calls[-1][1]
    reps = DETECT_REPS if cuda else 2
    for _ in range(2):
        det.detect(rgb)
    _sync(torch, dev)
    nms_ms, wall, greedy = [], [], yolox.greedy_nms

    def timed_nms(*a):
        t0 = time.perf_counter()
        keep_ = greedy(*a)
        nms_ms.append((time.perf_counter() - t0) * 1e3)
        return keep_
    split = {p: [] for p in ("resize", "network", "decode", "select")}
    yolox.greedy_nms = timed_nms
    try:
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)] \
                if cuda else []
            t0 = time.perf_counter()
            cuda and ev[0].record()
            img = det.resize(rgb)
            cuda and ev[1].record()
            outs = det.heads(img)
            cuda and ev[2].record()
            cand_t = yolox.decode(outs)
            cuda and ev[3].record()
            yolox.select(cand_t, det.score_th, det.iou_th)
            cuda and ev[4].record()
            _sync(torch, dev)
            wall.append((time.perf_counter() - t0) * 1e3)
            for p, a, b in zip(split, ev, ev[1:]):
                split[p].append(a.elapsed_time(b))
    finally:
        yolox.greedy_nms = greedy
    numbers["detect_ms"] = _median(wall)
    numbers["split"] = {p: _median(v) for p, v in split.items() if v}
    numbers["nms_host_ms"] = _median(nms_ms)
    peak = "not measured on the CPU"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        det.detect(rgb)
        torch.cuda.synchronize()
        numbers["peak_mib"] = (torch.cuda.max_memory_allocated() - held) / 2 ** 20
        peak = f"{numbers['peak_mib']:.1f} MiB"
    macs = yolox_macs(det.params["meta"], det.input_size)
    n_params = sum(v["w"].size + v["b"].size for k, v in det.params.items()
                   if k != "meta")
    nbytes = 4 * (n_params + rgb.numel() + 32 * 7)
    numbers["bound_ms"] = max(2 * macs / H100_FP32_FLOPS_PER_S,
                              nbytes / H100_BYTES_PER_S) * 1e3
    print(f"[detect] YOLOX-s at 640: {numbers['detect_ms']:.2f} ms per call "
          f"(median of {reps} synchronised calls, host wall) on {card}; split "
          f"between CUDA events (median, ms) "
          f"{json.dumps(numbers['split']) if cuda else 'not measured on the CPU'}"
          f"; greedy NMS on the host {numbers['nms_host_ms']:.3f} ms (after "
          f"one readback of the 128 x 128 suppression matrix); peak device "
          f"memory {peak} above what was held; {macs / 1e9:.3f} GMAC "
          f"({2 * macs / 1e9:.2f} GFLOP), {n_params / 1e6:.3f} M parameters: "
          f"bound {numbers['bound_ms']:.4f} ms at the float32 peak", flush=True)
    kf_frames = [int(f) for f in data["det__frame"]]
    with_det = ", ".join(f"{f}: {ms[f]:.1f}" for f in kf_frames)
    without = ("phase 9 " + ", ".join(f"{f}: {runner_ms[f]:.1f}"
                                      for f in kf_frames)
               if runner_ms else "phase 9 not run")
    print(f"[detect] wall ms of the frames that ran the detector {with_det} "
          f"(with it), {without} (without it)", flush=True)
    if cuda:
        w = det.net.convs["csp2_b0_2"].weight
        x = torch.randn(1, w.shape[1], 160, 160, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
        ref = F.conv2d(x.double(), w.double(), padding=1)
        scale = float(ref.abs().max())
        err32 = float((F.conv2d(x, w, padding=1) - ref).abs().max()) / scale
        torch.backends.cudnn.allow_tf32 = True
        try:
            err_tf32 = float((F.conv2d(x, w, padding=1) - ref).abs().max()) \
                / scale
        finally:
            torch.backends.cudnn.allow_tf32 = False
        print(f"[detect] cuDNN with allow_tf32=False: a 3x3 convolution "
              f"{tuple(w.shape)} at 160x160 within {err32:.2e} of float64 "
              f"(relative to its largest output); with TF32 {err_tf32:.2e}",
              flush=True)
        if err32 > 1e-5 or err_tf32 < 10 * err32:
            fail("cuDNN does not honour allow_tf32=False")

    # --- 10b: the shipped trained weights at 256 ----------------------------
    det_s = yolox.YOLOX(weights=SYNTH_WEIGHTS, input_size=256, score_th=0.4,
                        device=dev)
    preds, worst, fails = [], 1.0, []
    for i, img in enumerate(data["synth__img"]):
        got = detections_numpy(det_s.detect(img.astype(np.float32)))
        pred = got["boxes"][got["valid"]]
        want = data["synth__boxes"][i][data["synth__valid"][i]]
        wcls = data["synth__classes"][i][data["synth__valid"][i]]
        preds.append(pred)
        if len(pred) != len(want):
            fails.append(f"image {i}: {len(pred)} boxes, JAX {len(want)}")
        for p, c in zip(pred, got["classes"][got["valid"]]):
            best = max((box_iou(p, q) for q, qc in zip(want, wcls) if qc == c),
                       default=0.0)
            worst = min(worst, best)
    gate = synth_gate(preds, data["synth__gt"], data["synth__n"])
    gate_jax = synth_gate([data["synth__boxes"][i][data["synth__valid"][i]]
                           for i in range(len(preds))],
                          data["synth__gt"], data["synth__n"])
    print(f"[detect] yolox_synth.npz at 256 over {len(preds)} scenes: gate "
          f"{json.dumps(gate)} (JAX {json.dumps(gate_jax)}); every port box "
          f"at IoU >= {worst:.4f} from its JAX counterpart", flush=True)
    if not gate["ok"] or worst <= 0.9:
        fails.append(f"gate {gate}, worst IoU to JAX {worst}")
    if fails:
        fail("trained detector: " + "; ".join(fails))

    # --- 10c: cylinders at 640x480 ------------------------------------------
    K4 = cfg.camera.K4
    depth = torch.from_numpy(data["cyl__depth"]).to(dev)
    planes = segment_planes(depth, K4)
    label = planes.block_label.cpu().numpy()
    (seg, cyl_ms) = _stream_ms(torch, dev, lambda: segment_cylinders(
        depth, K4, planes.block_label))
    cgaps, fails = cylinder_gaps(seg, data, "cyl")
    if not np.array_equal(label, data["cyl__block_label"]):
        fails.append(f"block_label differs in "
                     f"{int((label != data['cyl__block_label']).sum())} cells")
    ccfg = cfg.replace(plane=dataclasses.replace(cfg.plane,
                                                 detect_cylinders=True))
    feats = extract_frame(torch.from_numpy(data["cyl__gray"]).to(dev), depth,
                          ccfg, dev)
    fgaps, ffails = cylinder_gaps(feats.cylinders, data, "cylf")
    print(f"[cylinders] 640x480, radius {data['cyl__scene'][2]:.2f} m at "
          f"{data['cyl__scene'][1]:.2f} m: segment_cylinders "
          f"{json.dumps(cgaps)} (JAX valid "
          f"{data['cyl__valid'].tolist()}, n_cells "
          f"{data['cyl__n_cells'].tolist()}, radius "
          f"{np.round(data['cyl__radius'], 4).tolist()}), {cyl_ms:.2f} ms "
          f"{'between CUDA events' if cuda else 'wall'}; extract_frame with "
          f"detect_cylinders {json.dumps(fgaps)}", flush=True)
    if fails + ffails:
        fail("cylinders disagree with the JAX ones: "
             + "; ".join(fails + ["extract_frame: " + f for f in ffails]))

    # --- 10d: the viewers ----------------------------------------------------
    has_mpl = importlib.util.find_spec("matplotlib") is not None
    try:
        code, body = _fetch(live.port, "/state.json")
        served = json.loads(body)
        fails = [] if code == 200 and served.get("frame") == n else \
            [f"/state.json {code} {served}"]
        fails += [f"/state.json {k} {served.get(k)}, the map {v}"
                  for k, v in counts.items() if served.get(k) != v]
        code, png = _fetch(live.port, "/map.png")
        if has_mpl:
            if code != 200 or png[:8] != b"\x89PNG\r\n\x1a\n" or len(png) < 5000:
                fails.append(f"/map.png {code}, {len(png)} bytes")
            with tempfile.TemporaryDirectory() as tmp:
                Viewer(system).render_map(os.path.join(tmp, "map.png"))
                g, d = frames[-1]
                draw_frame_overlay(g, extract_frame(g, d, cfg, dev),
                                   os.path.join(tmp, "overlay.png"),
                                   detections=system.last_detections,
                                   plane_block=cfg.plane.block)
                sizes = {f: os.path.getsize(os.path.join(tmp, f))
                         for f in ("map.png", "overlay.png")}
            fails += [f"{f}: {b} bytes" for f, b in sizes.items() if b < 10000]
            print(f"[viewer] /state.json {json.dumps(served)}; /map.png "
                  f"{len(png)} bytes; render_map and draw_frame_overlay "
                  f"{json.dumps(sizes)} bytes", flush=True)
        else:
            if code != 404:
                fails.append(f"/map.png {code} without a renderer")
            print(f"[viewer] /state.json {json.dumps(served)}; matplotlib is "
                  "not installed here (importlib.util.find_spec), so "
                  "render_map, draw_frame_overlay and /map.png were not run "
                  "(the live viewer's worker reports the render's "
                  "ImportError on stderr and goes on serving; /map.png "
                  "answers 404)", flush=True)
    finally:
        live.close()
    if fails:
        fail("viewers: " + "; ".join(fails))
    return launches, numbers


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "dr_slam_torch")):
        fail(f"no dr_slam_torch package beside {__file__}: run this script "
             "from a checkout of the repository")
    sys.path.insert(0, root)
    import numpy as np

    from dr_slam_torch._smoke import (card_line, load_fixture,
                                      load_mapping_fixture, pipelined,
                                      register_shipped_codebooks, run_tracker,
                                      synthetic_matcher_inputs, tracker_gaps)
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.track_step import extract_and_track

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} | {card}", flush=True)

    # --- 1. build: nvcc and g++ at the same time -------------------------------
    from concurrent.futures import ThreadPoolExecutor

    from dr_slam_torch.io import native_loader
    with ThreadPoolExecutor(2) as pool:
        loader_build = pool.submit(native_loader.build)
        info = match_cuda.build()
        loader_info = loader_build.result()
    print(f"[build] gated_top2_hamming.cu -> {os.path.basename(info['path'])} "
          f"in {info['seconds']:.1f} s; frame_loader.cpp -> "
          f"{os.path.basename(loader_info['path'])} in "
          f"{loader_info['seconds']:.1f} s", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"[build] {line.strip()}")

    # --- 2. kernel vs plain: ties, no valid candidate, all valid ---------------
    args = synthetic_matcher_inputs()
    none_valid = args[:9] + (torch.zeros_like(args[9]),)
    all_valid = args[:9] + (torch.ones_like(args[9]),)
    for case, a in (("synthetic ties", args), ("no valid", none_valid),
                    ("all valid", all_valid)):
        out_k = match_cuda.gated_top2_hamming(*a)
        torch.cuda.synchronize()
        out_r = match_cuda.gated_top2_hamming_ref(*a)
        mism, err = _compare(out_k, out_r, torch)
        print(f"[kernel] {case}: K=1024 NC=32768 valid={int(a[9].sum())} "
              f"mismatches={mism} max_abs_err={err}", flush=True)
        if any(mism.values()):
            fail(f"kernel disagrees with its plain version ({case}): {mism}")
    bufs = match_cuda.kernel_buffers(1024, 32768, dev)
    full_ms = _graph_ms(lambda: match_cuda.launch_kernel(all_valid, bufs), 20,
                        torch)
    full_bound, full_by = _bound(all_valid)
    split = _device_split(lambda: match_cuda.launch_kernel(all_valid, bufs),
                          20, torch)
    print(f"[kernel] full occupancy (32768 valid): {full_ms:.5f} ms per launch, "
          f"bound {full_bound:.6f} ms by {full_by} on {card}; device ms by "
          f"kernel {json.dumps(split)}", flush=True)

    # --- 3. main path ----------------------------------------------------------
    register_shipped_codebooks()
    cfg = tum_freiburg3()
    fx = load_fixture(dev)
    data = fx.data

    # capture the matcher's inputs on the main path (the count stays the
    # wrapper's own)
    captured = []
    kernel = map_ops.gated_top2_hamming

    def capture(*a):
        if not captured:
            captured.append(tuple(x.clone() for x in a))
        return kernel(*a)

    map_ops.gated_top2_hamming = capture
    match_cuda.gated_top2_hamming.launches = 0
    st, T, V, R = fx.state, fx.T_last, fx.velocity, fx.R_cm
    outs = []
    t0 = time.perf_counter()
    for g, d in fx.frames:
        feats, out = extract_and_track(g, d, st, T, V, R, fx.ref_kf, cfg,
                                       device="cuda")
        st, T, V, R = out.new_map_state, out.T_cw, out.velocity, out.R_cm
        outs.append(out)
    torch.cuda.synchronize()
    t_main = time.perf_counter() - t0
    launches = match_cuda.gated_top2_hamming.launches
    map_ops.gated_top2_hamming = kernel
    print(f"[main] {len(fx.frames)} frames in {t_main:.2f} s (first frame "
          f"includes warm-up); kernel launches {launches}", flush=True)
    if launches != 2 * len(fx.frames):
        fail(f"expected {2 * len(fx.frames)} kernel launches, got {launches}")

    for i, out in enumerate(outs):
        Tc = out.T_cw.cpu().numpy()
        if Tc.shape != (4, 4) or not np.isfinite(Tc).all():
            fail(f"frame {i}: T_cw not a finite 4x4")
        dT = float(np.abs(Tc - data["T_cw"][i]).max())
        nm, ni = int(out.n_matches), int(out.n_inliers)
        jm, ji = int(data["n_matches"][i]), int(data["n_inliers"][i])
        mp = out.mp_idx.cpu().numpy()
        mp_mism = int((mp != data["mp_idx"][i]).sum())
        print(f"[main] frame {12 + i}: |dT_cw|max={dT:.2e} n_matches "
              f"{nm} (jax {jm}) n_inliers {ni} (jax {ji}) mp_idx "
              f"mismatches {mp_mism}/{mp.size}", flush=True)
        if (dT > T_TOL or abs(nm - jm) > COUNT_TOL * jm
                or abs(ni - ji) > COUNT_TOL * ji):
            fail(f"frame {12 + i} disagrees with the JAX outputs")

    # the kernel on the main path's own inputs (frame 12, stage 1)
    args = captured[0]
    out_k = match_cuda.gated_top2_hamming(*args)
    out_r = match_cuda.gated_top2_hamming_ref(*args)
    mism, err = _compare(out_k, out_r, torch)
    K, NC = args[0].shape[0], args[4].shape[0]
    n_valid = int(args[9].sum())
    print(f"[kernel] main-path inputs K={K} NC={NC} valid={n_valid} "
          f"mismatches={mism} max_abs_err={err}", flush=True)
    if any(mism.values()):
        fail(f"kernel disagrees with its plain version: {mism}")
    # kernel: launches into buffers allocated once, replayed from a CUDA
    # graph (and, for comparison, enqueued eagerly back to back); wrapper:
    # the whole call (checks, allocation, launch) back to back
    bufs = match_cuda.kernel_buffers(K, NC, dev)
    ms = _graph_ms(lambda: match_cuda.launch_kernel(args, bufs), 20, torch)
    eager_ms = _time_ms(lambda: match_cuda.launch_kernel(args, bufs), 200,
                        torch)
    wrapper_ms = _time_ms(lambda: match_cuda.gated_top2_hamming(*args), 200,
                          torch)
    plain_ms = _time_ms(lambda: match_cuda.gated_top2_hamming_ref(*args), 10,
                        torch)
    bound_ms, bound_by = _bound(args)
    split = _device_split(lambda: match_cuda.launch_kernel(args, bufs), 50,
                          torch)
    print(f"[kernel] {ms:.5f} ms per launch (eager back to back {eager_ms:.5f}"
          f" ms, wrapper call {wrapper_ms:.5f} "
          f"ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms by "
          f"{bound_by}) on {card}; device ms by kernel {json.dumps(split)}",
          flush=True)

    # pipelined loop: frames enqueued back to back, one sync at the end
    match_cuda.gated_top2_hamming.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = pipelined(fx, PIPELINE_FRAMES, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if match_cuda.gated_top2_hamming.launches != 2 * PIPELINE_FRAMES:
        fail("pipelined loop did not launch the kernel twice per frame")
    if not bool(torch.isfinite(out.T_cw).all()):
        fail("pipelined loop produced a non-finite pose")
    print(f"[pipeline] {PIPELINE_FRAMES} frames in {dt:.2f} s = "
          f"{PIPELINE_FRAMES / dt:.2f} frames/s ({dt / PIPELINE_FRAMES * 1e3:.1f}"
          f" ms/frame) at 640x480 on {card}", flush=True)

    # --- 4. tracker from an empty map ------------------------------------------
    mdata = load_mapping_fixture()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    match_cuda.gated_top2_hamming.launches = 0
    run = run_tracker(mdata, cfg, dev)
    tracker_launches = match_cuda.gated_top2_hamming.launches
    peak_gib = (torch.cuda.max_memory_allocated() - held) / 2 ** 30
    gaps, fails = tracker_gaps(run, mdata)
    n = len(run.results)
    for i, r in enumerate(run.results):
        print(f"[tracker] frame {i}: {r.state.name} n_inliers {r.n_inliers} "
              f"(jax {int(mdata['n_inliers'][i])}) n_matches {r.n_matches} "
              f"(jax {int(mdata['n_matches'][i])}) launches "
              f"{run.launches[i]}", flush=True)
    for k, stages in enumerate(run.keyframes):
        total = sum(ms for _, ms in stages)
        what = "initialization" if k == 0 else "local-mapping pass"
        print(f"[tracker] keyframe {k} ({what}, frame "
              f"{gaps['kf_frames'][k]}): "
              + ", ".join(f"{name} {ms:.2f} ms" for name, ms in stages)
              + f"; total {total:.2f} ms device time (CUDA events) on {card}",
              flush=True)
    passes = [sum(ms for _, ms in st) for st in run.keyframes[1:]]
    per_kf = sum(passes) / max(len(passes), 1)
    print(f"[tracker] {n} frames from an empty map in {run.seconds:.2f} s = "
          f"{n / run.seconds:.3f} frames/s (synchronised per frame), "
          f"{len(passes)} local-mapping passes at {per_kf:.2f} ms per keyframe, "
          f"peak device memory {peak_gib:.3f} GiB above what the earlier phases "
          f"held, on {card}", flush=True)
    print(f"[tracker] against the JAX tracker: {json.dumps(gaps)}; jax "
          f"n_kfs {int(mdata['n_kfs'])} n_pts {int(mdata['n_pts'])} "
          f"n_planes {int(mdata['n_planes'])} n_lines "
          f"{int(mdata['n_lines'])}; matcher launches {tracker_launches}",
          flush=True)
    if run.launches != [0] + [2] * (n - 1) or tracker_launches != 2 * (n - 1):
        fail(f"tracker: expected 2 matcher launches per tracked frame, got "
             f"{run.launches}")
    if fails:
        fail("tracker disagrees with the JAX tracker: " + "; ".join(fails))

    # --- 5. System: relocalization into a saved map ---------------------------
    system_launches, err5 = system_phase(dev, cfg, card)
    err = max(err, err5)
    # --- 6. loop closing on the loop fixture -------------------------------------
    loop_launches = loop_phase(dev, card)
    # --- 7. the device-resident loop ---------------------------------------------
    device_loop_launches, err7, loop_run = device_loop_phase(dev, cfg, card)
    err = max(err, err7)
    # --- 8. multi-sequence ---------------------------------------------------------
    multi_launches = multi_seq_phase(dev, cfg, card, loop_run)
    # --- 9. the dataset runner and the streaming node -----------------------------
    tum_launches, tum_numbers = tum_phase(dev, cfg, card)
    err = max(err, tum_numbers["max_abs_err"])
    # --- 10. the detector, the cylinders and the viewers ---------------------
    detect_launches, detect_numbers = detect_phase(dev, cfg, card,
                                                   tum_numbers["frame_ms"])
    err = max(err, detect_numbers["max_abs_err"])
    print(f"[kernel] launches by path: main {launches}, tracker "
          f"{tracker_launches}, system a {system_launches['a']}, system b "
          f"{system_launches['b']}, loop {loop_launches}, device loop "
          f"{device_loop_launches}, multi-sequence {multi_launches}, runner "
          f"{tum_launches['runner']}, node {tum_launches['node']}, detector "
          f"System {detect_launches} (the pipelined timing loop's "
          f"{2 * PIPELINE_FRAMES} not counted)", flush=True)
    total_launches = (launches + tracker_launches
                      + sum(system_launches.values()) + loop_launches
                      + device_loop_launches + multi_launches
                      + sum(tum_launches.values()) + detect_launches)
    print(f"[total] {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "gated_top2_hamming", "route": "cuda",
        "source": "dr_slam_torch/csrc/gated_top2_hamming.cu",
        "replaces": REPLACES,
        "launches": total_launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
