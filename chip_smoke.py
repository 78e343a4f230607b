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
   three CUDA kernels from torch.profiler. The pipelined loop (the frames
   cycled, as bench.py's bench_odometry does) is timed in phase 14a.
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
11. synthetic renderer, run script, sharded solves, trainer: (a) the port's
   `render_frame` on the card over the 24 corridor poses of
   mapping_corridor.npz and the two scenes of
   dr_slam_torch/data/synthetic_fixture.npz (made by
   scripts/make_torch_synthetic_fixture.py; office clutter and the small
   room, quadratic depth noise from PRNGKey(7)), quantised as the fixtures
   are: hit masks exact, depth within one uint16 step, the share of gray
   pixels off by more than one level under GRAY_OFF_SHARE; ms per rendered
   frame. (b) scripts/run_synthetic_torch.py's `main` with --frames 24:
   no frame LOST, ATE under 0.05 m and within 2x + 5 mm of the JAX run's,
   2 matcher launches per tracked frame, the kernel against its plain
   version on both of frame 11's launches; frames/s. (c)
   `synthetic_map_state` at tests/test_backend.py's realistic capacity
   (240 keyframes x 512 slots) against the JAX state's checksums, then
   `bundle_adjust` and `sharded_bundle_adjust` on meshes of 1 and 4
   entries of the one card (2 GN x 8 CG): 1 shard bit-equal, 4 within
   SHARD_TOL, the pose error down below 0.7 of its start; host dispatch
   and device ms of each; `sharded_place_scores` over 4 shards exact with
   keyframe 5 first for query 5; `batched_frontend` on 4 frames equal to
   4 `extract_orb` calls; with more than one card, the mesh of real cards
   too (printed only). (d) scripts/train_yolox_torch.py: the first
   batch's loss and gradient norm against the JAX trainer's, then 20
   steps within LOSS_TOL0 + LOSS_TOL_STEP per step of the JAX losses; ms
   per step split into the host-side batch and the device step.
12. closed-loop accuracy: scripts/bench_accuracy.py's protocol on the port
   (`_smoke.accuracy_run("cuda")`, the twin of
   scripts/bench_accuracy_torch.py, each frame synchronised): a codebook
   trained on the sequence, `System` with loop closing on over the 270
   frames of a circular path at 320x240 and its first 70 again, drift
   injected after frame 120, the loop closed and corrected, the raw and
   corrected ATE; against the JAX run in dr_slam_torch/data/
   accuracy_loop.npz (made by scripts/make_torch_accuracy_fixture.py, JAX
   tracking with the port's pose rule): states, keyframe flags, reference
   keyframes, keyframes' frames, LOST frames and the loops closed (at
   least one; frame, keyframe slot and keyframe pair) exact over every
   frame, the corrected ATE under ACCURACY_ATE_MAX, under the raw ATE less
   ACCURACY_ATE_GAIN and within 2x + 5 mm of JAX's (bounds in
   dr_slam_torch/_smoke.py); T_cw's largest gap to JAX's and the frames
   over TRACKER_T_TOL are printed, and the reference test's LOST bound
   beside JAX's count. The kernel is held against its plain version on both
   launches of frames 60 and 121 (before and after the injection).
   Prints frames/s, the ms of tracked frames and of the frames that ran a
   local-mapping pass, `loop.process` ms and the global BA's dispatch
   and device ms at the firing, and the launches.
13. behaviours: the reference behaviours against dr_slam_torch/data/
   behaviours.npz (made by scripts/make_torch_behaviours_fixture.py from
   JAX runs). 13a: each forced eviction the JAX `System` made at 640x480,
   with the culling pass off and on (the wall comes at call 70 then), from
   its stored state, through the port's `cull_one_keyframe(force=True)` on
   the card, which must free JAX's slot; then `System(cfg, device="cuda")`
   over 48 frames of the 2 cm corridor at 640x480 (`tum_freiburg3`, 12
   keyframe slots, a keyframe forced every 4 frames, the culling pass off so
   the wall comes: `_smoke.wall_cfg`), each call synchronised, against the
   JAX run: states, keyframes per call, reference keyframes and every
   slot's insertion sequence exact, T_cw within TRACKER_T_TOL and the
   counts within 2% (`_smoke.behaviour_gaps`; the card renders the frames
   itself, which moves the gray's last bits only). The five forced
   evictions are timed. 13b: tests/test_transfer_validation.py's office
   world at its own 320x240 (fx 262): 40 frames, three black frames, frame
   20 again until it relocalizes, fed the fixture's frames (JAX's renders
   rounded as a TUM camera gives them, gray uint8 and depth uint16: the
   port's own renders of this world move T_cw 5.9e-3 from JAX's on the
   CPU) and held by the same rule against the JAX run on them (but for
   frame 1's inliers, read back at call 2: the first tracked frame's pose
   is weakly held, and the port's own float order moves that count by
   more than 2% between the card and the CPU, so it is held from the port
   on the host's CPU), the
   relocalization at JAX's call and the JAX tests' acceptance (no frame
   LOST, ATE under 0.08 m, LOST after the blackout, OK on the first or
   second try within 0.10 m). 13c: the
   `DeviceLoopTracker` over 13a's frames: the stored evictions again, then
   states, keyframe flags, reference slots and sequences exact against
   JAX's loop, T_cw within TRACKER_T_TOL, the live keyframe count before
   each step equal, and two
   readbacks exactly on JAX's wall steps (one elsewhere). The kernel is
   held against its plain version on both launches of 13a's first wall
   call and on every launch of 13b's relocalized call.
14. bench legs: bench_torch.py's legs on the card at cut depths, against
   the JAX package's runs of bench.py's loops in dr_slam_torch/data/
   bench_runs.npz (made by scripts/make_torch_bench_fixture.py, with the
   port's two rules on the JAX side: the decision lagged by one frame,
   rotations projected onto SO(3)). 14a: `bench_odometry` on the mapping
   fixture's frames 0-15 (JAX's renders): its map of frames 0-11, loaded
   back from its file, equal to the `System`'s own and held against the
   JAX map of the same frames (live keyframes exact, points within 2%,
   keyframe poses within TRACKER_T_TOL), then one pipelined window of
   PIPELINE_FRAMES frames (the pipelined frames/s of this script) at
   exactly 2 launches per frame, and the synchronising calls of one more
   pipelined frame counted under `torch.cuda.set_sync_debug_mode` (printed
   only; its 2 launches counted). 14b: `bench_tracking` over its 60
   frames, fed the fixture's (JAX's renders as uint8 gray and uint16
   depth: on the port's own float renders T_cw moves 4.3e-3 from JAX's on
   JAX's, and four frames' inliers 2-4.5%, scripts/parity_bench_torch.py);
   14c: `bench_interactive_device` over BENCH_DEVICE_FRAMES frames after
   BENCH_DEVICE_WARM warm-up frames of the port's renders, through its
   pinned, double-buffered copies. Both held as phases 4 and 7: states,
   keyframes and reference keyframes exact, T_cw within TRACKER_T_TOL,
   counts within 2% (the inliers of `_smoke.BENCH_PYRAMID_FRAMES`, where
   the JAX package's jitted ORB pyramid alone moves them, are printed and
   held by their witnesses on the CPU, tests/test_torch_bench.py), ATE under
   BENCH_ATE_MAX and within 2x + 5 mm of JAX's, 2 launches per tracked
   frame. 14d: `bench_frontend` over 30 frames, valid keypoints within 2%
   of JAX's. The kernel is held against its plain version on 14b's call
   BENCH_KEPT_CALL. Prints each leg's frames/s and the device loop's
   readbacks per step.

Phases 3-4 and 6-9 run with the shipped codebooks registered, as the JAX
runs that made the fixtures had them (a bare Tracker or DeviceLoopTracker
registers none; the System registers them itself).

The kernel table's `launches` adds the main path's, the tracker's, the two
System scenarios', the loop phase's, the device loop's, the multi-sequence
phase's, the runner's and node's, the detector System's, the synthetic
run script's, the accuracy protocol's, the three behaviour runs' and the
three bench legs' that track (odometry, tracking, device loop).

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
# phase 14a's pipelined window: 16 frames, not bench_odometry's 240: at
# about 1 s a frame on the host, the window would take most of the run's
# time limit as the phases grow
PIPELINE_FRAMES = 16

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


def _hold_kept(kept: list, path: str, torch, dev,
               frame: int = CHECK_FRAME) -> float:
    """The kernel against its plain version on both matcher launches that
    `path` made on `frame`. -> the largest abs error."""
    from dr_slam_torch.ops import match_cuda

    if len(kept) != 2:
        fail(f"{path}: {len(kept)} matcher calls kept on frame "
             f"{frame}, expected 2")
    err = 0.0
    for stage, a in enumerate(kept, 1):
        out_k = match_cuda.gated_top2_hamming(*a)
        _sync(torch, dev)
        out_r = match_cuda.gated_top2_hamming_ref(*a)
        mism, e = _compare(out_k, out_r, torch)
        print(f"[kernel] {path} frame {frame} stage {stage}: "
              f"K={a[0].shape[0]} NC={a[4].shape[0]} valid={int(a[9].sum())} "
              f"mismatches={mism} max_abs_err={e}", flush=True)
        if any(mism.values()):
            fail(f"kernel disagrees with its plain version ({path} frame "
                 f"{frame} stage {stage}): {mism}")
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


# Phase 11 bounds, written before the first run on the card. Gray: the
# renderer fuses the texture hash's first product as XLA does and rounds
# sin from float64, so a quantised pixel should differ from the JAX
# render's by more than one grey level only where the card's float32
# sin/cos or a cell edge rounds the other way.
GRAY_OFF_SHARE = 0.005    # share of pixels with |gray8 - jax| > 1
SYNTH_ATE_MAX = 0.05      # run_synthetic's own sanity bound (m)
SHARD_TOL = 2e-3          # 4 shards against 1 (tests/test_backend.py)
LOSS_TOL0 = 1e-5          # first-batch loss, relative
GRAD_NORM_TOL = 1e-4      # its gradient's global norm, relative
LOSS_TOL_STEP = 1e-4      # + this much relative per trained step


def _events_ms(torch, dev, fn):
    """(fn's result, host ms to return, device ms between CUDA events)."""
    _sync(torch, dev)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        ms = (time.perf_counter() - t0) * 1e3
        return out, ms, ms
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    out = fn()
    host = (time.perf_counter() - t0) * 1e3
    b.record()
    b.synchronize()
    return out, host, a.elapsed_time(b)


def synthetic_phase(dev, cfg, card: str) -> tuple[int, dict]:
    """Phase 11: the renderer against the JAX renders, the run script, the
    sharded solves and place recognition at realistic capacity, the
    batched front-end, and the detector trainer against the JAX trainer.
    -> (matcher launches of the run script, the numbers printed)."""
    import importlib.util

    import numpy as np
    import torch

    from dr_slam_torch import _smoke, config
    from dr_slam_torch.associate.keyframe_db import common_word_counts
    from dr_slam_torch.associate.vocabulary import bow_scores
    from dr_slam_torch.io import synthetic
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.ops.orb import extract_orb
    from dr_slam_torch.optimize.global_ba import (bundle_adjust,
                                                  problem_from_state)
    from dr_slam_torch.parallel import sharded_ba, sharded_place
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.utils.prng import PRNGKey

    fx = _smoke.load_synth_fixture()
    root = os.path.dirname(os.path.abspath(__file__))

    def script(name):
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(root, "scripts", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    numbers, fails = {}, []
    factor = cfg.camera.depth_factor
    K4 = cfg.camera.K4

    # --- (a) the renderer ----------------------------------------------------
    mdata = _smoke.load_mapping_fixture()
    planes = torch.from_numpy(synthetic.BoxRoom().planes()).to(dev)
    poses = synthetic.corridor_trajectory(len(mdata["gray"]))
    renders = [("corridor", poses[i], planes, None, None, mdata["gray"][i],
                mdata["depth"][i]) for i in range(len(poses))]
    for name, room, traj, boxes in _smoke.synthetic_scenes(synthetic):
        renders.append((name, traj[_smoke.SYNTH_FRAME],
                        torch.from_numpy(room.planes()).to(dev),
                        torch.from_numpy(boxes).to(dev),
                        PRNGKey(_smoke.SYNTH_FRAME), fx[f"{name}__gray"],
                        fx[f"{name}__depth"]))
    render_ms, off, hit_bad, depth_worst, corridor = [], {}, [], 0, []
    for name, T, pl, boxes, key, want_g, want_d in renders:
        T = torch.from_numpy(T).to(dev)
        _sync(torch, dev)
        t0 = time.perf_counter()
        g, d = synthetic.render_frame(T, pl, K4, 480, 640,
                                      depth_noise_key=key, boxes=boxes,
                                      quadratic_noise=key is not None)
        _sync(torch, dev)
        render_ms.append((time.perf_counter() - t0) * 1e3)
        if name == "corridor":
            corridor.append(g)
        g8, d16 = _smoke.quantize(g, d, factor)
        if not np.array_equal(d16 > 0, want_d > 0):
            hit_bad.append(name)
        depth_worst = max(depth_worst, int(np.abs(
            d16.astype(np.int64) - want_d).max()))
        share = float((np.abs(g8.astype(np.int64) - want_g) > 1).mean())
        off[name] = max(off.get(name, 0.0), share)
    numbers["render_ms"] = float(np.median(render_ms[1:]))
    print(f"[synthetic] renderer: {len(renders)} frames at 640x480 (the 24 "
          f"corridor frames of mapping_corridor.npz, the clutter and "
          f"small-room frames of synthetic_fixture.npz with quadratic depth "
          f"noise): hit masks differing {hit_bad}, depth within "
          f"{depth_worst} uint16 steps, share of gray pixels off by more "
          f"than one level (worst frame) {json.dumps(off)} (bound "
          f"{GRAY_OFF_SHARE}); {numbers['render_ms']:.3f} ms per frame "
          f"(median, synchronised; first {render_ms[0]:.1f} ms) on {card}",
          flush=True)
    if hit_bad or depth_worst > 1 or max(off.values()) > GRAY_OFF_SHARE:
        fails.append("renderer: hit masks, depth or gray off the JAX renders")

    # --- (b) the run script --------------------------------------------------
    run = script("run_synthetic_torch")
    jsum = json.loads(str(fx["run_summary"]))
    per_frame, kept, kernel = [], [], map_ops.gated_top2_hamming
    last = [0]

    def on_frame(res, system):
        per_frame.append(match_cuda.gated_top2_hamming.launches - last[0])
        last[0] = match_cuda.gated_top2_hamming.launches

    def keep(*a):
        if len(per_frame) == CHECK_FRAME:
            kept.append(tuple(x.clone() for x in a))
        return kernel(*a)

    match_cuda.gated_top2_hamming.launches = 0
    map_ops.gated_top2_hamming = keep
    try:
        with tempfile.TemporaryDirectory() as tmp, \
                _smoke.track_rgbd_hook(on_frame), \
                contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            summary = run.main(["--frames", str(_smoke.SYNTH_RUN_FRAMES),
                                "--out", tmp, "--device", dev.type])
    finally:
        map_ops.gated_top2_hamming = kernel
    launches = match_cuda.gated_top2_hamming.launches
    n = _smoke.SYNTH_RUN_FRAMES
    numbers["run_fps"] = summary["fps"]
    print(f"[synthetic] run_synthetic_torch.py --frames {n}: "
          f"{json.dumps(summary)} (JAX {json.dumps(jsum)}); "
          f"{summary['fps']} frames/s (rendering, tracking and mapping, one "
          f"synchronise at the end) on {card}; matcher launches per frame "
          f"{per_frame}", flush=True)
    ate_max = min(SYNTH_ATE_MAX, 2 * jsum["ate_rmse_m"] + 0.005)
    if summary["lost_frames"] or summary["ate_rmse_m"] >= ate_max:
        fails.append(f"run script: {summary['lost_frames']} frames LOST, "
                     f"ATE {summary['ate_rmse_m']} (bound {ate_max:.4f})")
    if dev.type == "cuda" and per_frame != [0] + [2] * (n - 1):
        fails.append(f"run script: matcher launches {per_frame}")
    numbers["max_abs_err"] = _hold_kept(kept, "run_synthetic", torch, dev)

    # --- (c) sharded solves and place recognition ----------------------------
    mcfg = _smoke.map_state_cfg(config)
    st, poses_true = synthetic.synthetic_map_state(mcfg, _smoke.MAP_KFS,
                                                   seed=3, device=dev)
    sums = _smoke.state_checksums({f: getattr(st, f).cpu().numpy()
                                   for f in st._fields})
    bad = []
    for f, v in sums.items():
        want = fx[f"ms__{f}"]
        if v.dtype.kind == "i" and not np.array_equal(v, want):
            bad.append(f)
        elif v.dtype.kind == "f" and abs(v[0] - want[0]) > 1e-6 * max(
                want[1], 1.0):
            bad.append(f)
    p = problem_from_state(st)
    rows = int(p.obs_valid.sum())
    print(f"[sharded] synthetic_map_state({_smoke.MAP_KFS} keyframes x "
          f"{mcfg.orb.max_keypoints} slots, {mcfg.map.max_points} points) "
          f"on {dev}: {p.obs_kf.shape[0]} observation rows, {rows} valid, "
          f"{int(p.struct.pobs_valid.sum())} plane and "
          f"{int(p.struct.lobs_valid.sum())} line rows; checksums against "
          f"the JAX state differing: {bad}", flush=True)
    if bad or not np.array_equal(poses_true, fx["ms_poses_true"]):
        fails.append(f"synthetic_map_state checksums differ: {bad}")
    kw = dict(n_gn_iters=2, n_cg_iters=8)
    K4m = mcfg.camera.K4
    home = "cuda:0" if dev.type == "cuda" else "cpu"
    one = sharded_ba.make_mesh(devices=[home])
    four = sharded_ba.make_mesh(devices=[home] * 4)
    solves = {}
    for name, fn in (
            ("single", lambda: bundle_adjust(p, K4m, **kw)),
            ("single again", lambda: bundle_adjust(p, K4m, **kw)),
            ("1 shard", lambda: sharded_ba.sharded_bundle_adjust(
                p, K4m, one, **kw)),
            ("4 shards", lambda: sharded_ba.sharded_bundle_adjust(
                p, K4m, four, **kw))):
        solves[name] = _events_ms(torch, dev, fn)
    ref = solves["single"][0]

    def bits(a, b):
        return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                   for x, y in zip(a, b))

    # bit-equality is defined where the solve repeats itself bit for bit:
    # under torch's deterministic algorithms (the gathers' backward
    # scatter-adds), as well as in the default mode where it already does
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        det = [bundle_adjust(p, K4m, **kw),
               sharded_ba.sharded_bundle_adjust(p, K4m, one, **kw)]
    finally:
        torch.use_deterministic_algorithms(False)
    gap4 = max(float((x - y).abs().max()) for x, y in
               zip(solves["4 shards"][0], ref))
    e0 = float(np.linalg.norm(st.kf_pose[:_smoke.MAP_KFS, :3, 3].cpu().numpy()
                              - poses_true[:, :3, 3], axis=1).mean())
    e1 = float(np.linalg.norm(
        solves["4 shards"][0][0][:_smoke.MAP_KFS, :3, 3].cpu().numpy()
        - poses_true[:, :3, 3], axis=1).mean())
    numbers["solve_ms"] = {k: (v[1], v[2]) for k, v in solves.items()}
    print(f"[sharded] bundle_adjust and sharded_bundle_adjust, 2 GN x 8 CG: "
          + "; ".join(f"{k}: host dispatch {v[1]:.1f} ms, device "
                      f"{v[2]:.1f} ms" for k, v in solves.items())
          + f" on {card} (the 4 shards share one card: this times the split "
          f"and the reduction, not a speed-up); default mode: single "
          f"bit-equal to a second single solve "
          f"{bits(solves['single again'][0], ref)}, 1 shard bit-equal to "
          f"single {bits(solves['1 shard'][0], ref)}; deterministic "
          f"algorithms: 1 shard bit-equal to single {bits(det[1], det[0])}; "
          f"4 shards against single {gap4:.2e} (bound {SHARD_TOL}); mean "
          f"translation error {e0:.4f} -> {e1:.4f} m", flush=True)
    if not bits(det[1], det[0]):
        fails.append("a 1-shard solve is not bundle_adjust bit for bit")
    if gap4 > SHARD_TOL or not e1 < 0.7 * e0:
        fails.append(f"4-shard solve off by {gap4:.2e}, error {e0} -> {e1}")

    kf_mesh = sharded_ba.make_mesh(devices=[home] * 4, axis="kf")
    bows = sharded_place.shard_keyframe_bows(st.kf_bow, st.kf_valid, kf_mesh)
    q = st.kf_bow[5]
    (s4, c4), host, dms = _events_ms(
        torch, dev,
        lambda: sharded_place.sharded_place_scores(q, bows, kf_mesh))
    s1 = bow_scores(q, st.kf_bow, st.kf_valid)
    c1 = common_word_counts(q, st.kf_bow, st.kf_valid)
    exact = torch.equal(s4, s1) and torch.equal(c4, c1)
    top = int(torch.argmax(s4))
    print(f"[sharded] sharded_place_scores over 4 shards of the "
          f"{tuple(st.kf_bow.shape)} tf matrix: equal to the single scan "
          f"{exact}, query 5 ranks keyframe {top} first; host {host:.3f} ms, "
          f"device {dms:.3f} ms on {card}", flush=True)
    if not exact or top != 5:
        fails.append(f"sharded place scores: exact {exact}, top {top}")

    imgs = torch.stack(corridor[:4])
    orb_kw = dict(n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels,
                  scale=cfg.orb.scale_factor,
                  max_keypoints=cfg.orb.max_keypoints)
    (uv, desc, valid), host, dms = _events_ms(
        torch, dev, lambda: sharded_ba.batched_frontend(
            imgs, sharded_ba.make_mesh(devices=[home] * 4, axis="data"),
            **orb_kw))
    same = all(torch.equal(uv[i], kp.uv) and torch.equal(desc[i], kp.desc)
               and torch.equal(valid[i], kp.valid)
               for i, kp in enumerate(extract_orb(im, **orb_kw)
                                      for im in imgs))
    print(f"[sharded] batched_frontend on 4 frames at 640x480 over 4 shards: "
          f"equal to 4 extract_orb calls {same}, {int(valid.sum())} valid "
          f"keypoints; host {host:.1f} ms, device {dms:.1f} ms on {card}",
          flush=True)
    if not same:
        fails.append("batched_frontend differs from extract_orb")
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        real = sharded_ba.make_mesh()
        out, host, dms = _events_ms(torch, dev, lambda: sharded_ba
                                    .sharded_bundle_adjust(p, K4m, real, **kw))
        print(f"[sharded] a mesh of {len(real.devices)} cards: against "
              f"single {max(float((x - y).abs().max()) for x, y in zip(out, ref)):.2e}, "
              f"host {host:.1f} ms, device {dms:.1f} ms (printed, not held)",
              flush=True)

    # --- (d) the detector trainer --------------------------------------------
    tr = script("train_yolox_torch")
    net, _ = tr.make_net(0.33, 0.125, dev)
    rng = np.random.RandomState(7)
    batch = tr.to_device(tr.make_batch(rng, _smoke.TRAIN_BATCH), dev)
    loss0 = tr.loss_batch(net, *batch)
    loss0.backward()
    gnorm = float(torch.sqrt(sum(torch.sum(x.grad.double() ** 2)
                                 for x in net.parameters())))
    loss0 = float(loss0.detach())
    want = fx["train_losses"]
    d0 = abs(loss0 - float(want[0])) / float(want[0])
    dg = abs(gnorm - float(fx["train_grad_norm0"])) / float(
        fx["train_grad_norm0"])
    net, _ = tr.make_net(0.33, 0.125, dev)
    opt, sched = tr.make_optimizer(net, _smoke.TRAIN_STEPS, 1e-3)
    rng = np.random.RandomState(7)
    losses, host_ms, step_ms = [], [], []
    for _ in range(_smoke.TRAIN_STEPS):
        t0 = time.perf_counter()
        batch = tr.to_device(tr.make_batch(rng, _smoke.TRAIN_BATCH), dev)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        loss, _, ms = _events_ms(torch, dev, lambda: tr.train_step(
            net, opt, sched, *batch))
        step_ms.append(ms)
        losses.append(float(loss))
    rel = np.abs(np.asarray(losses) - want) / want
    bound = LOSS_TOL0 + LOSS_TOL_STEP * np.arange(len(want))
    numbers["train_ms"] = (float(np.median(host_ms)),
                           float(np.median(step_ms[1:])))
    print(f"[train] train_yolox_torch.py at width 0.125, 256x256, batch "
          f"{_smoke.TRAIN_BATCH}: first-batch loss {loss0:.6f} (JAX "
          f"{float(want[0]):.6f}, relative {d0:.2e}, bound {LOSS_TOL0}), "
          f"gradient norm {gnorm:.6f} (JAX "
          f"{float(fx['train_grad_norm0']):.6f}, relative {dg:.2e}, bound "
          f"{GRAD_NORM_TOL}); {_smoke.TRAIN_STEPS} steps: losses "
          f"{[round(x, 5) for x in losses]}, relative to JAX's "
          f"{[float('%.2e' % x) for x in rel]} (bound {LOSS_TOL0} + "
          f"{LOSS_TOL_STEP} per step); per step: host-side batch "
          f"{numbers['train_ms'][0]:.1f} ms, device step "
          f"{numbers['train_ms'][1]:.2f} ms (median; first "
          f"{step_ms[0]:.1f} ms) on {card}", flush=True)
    if d0 > LOSS_TOL0 or dg > GRAD_NORM_TOL or (rel > bound).any():
        fails.append(f"trainer off the JAX trainer: {d0:.2e}, {dg:.2e}, "
                     f"{rel.tolist()}")
    if fails:
        fail("synthetic phase: " + "; ".join(fails))
    return launches, numbers


def accuracy_phase(dev, card: str) -> tuple[int, dict]:
    """Phase 12: scripts/bench_accuracy.py's closed-loop protocol on the
    port (`_smoke.accuracy_run`, each frame synchronised) over all 270
    frames, against the JAX run in dr_slam_torch/data/accuracy_loop.npz,
    with the kernel held against its plain version on both launches of
    each of ACCURACY_CHECK_FRAMES. -> (matcher launches of the run, the
    numbers printed)."""
    import collections

    import numpy as np
    import torch

    from dr_slam_torch import _smoke
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.loop_closing import LoopCloser

    data = _smoke.load_accuracy_fixture()
    want = json.loads(str(data["summary"]))
    per_frame, calls, last = [], [], [0]
    kept = {f: [] for f in _smoke.ACCURACY_CHECK_FRAMES}
    kernel, process = map_ops.gated_top2_hamming, LoopCloser.process

    def on_frame(res, system):
        per_frame.append(match_cuda.gated_top2_hamming.launches - last[0])
        last[0] = match_cuda.gated_top2_hamming.launches

    def keep(*a):
        if len(per_frame) in kept:
            kept[len(per_frame)].append(tuple(x.clone() for x in a))
        return kernel(*a)

    def timed(self, *a, **kw):
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = process(self, *a, **kw)
        _sync(torch, dev)
        calls.append((len(per_frame), (time.perf_counter() - t0) * 1e3,
                      bool(out[1])))
        return out

    match_cuda.gated_top2_hamming.launches = 0
    map_ops.gated_top2_hamming = keep
    LoopCloser.process = timed
    t0 = time.perf_counter()
    try:
        with _smoke.track_rgbd_hook(on_frame):
            run = _smoke.accuracy_run(dev)
    finally:
        map_ops.gated_top2_hamming = kernel
        LoopCloser.process = process
    seconds = time.perf_counter() - t0
    launches = match_cuda.gated_top2_hamming.launches

    summ, n = run.summary, len(run.ms)
    gaps, fails = _smoke.accuracy_gaps(run, data)
    print(f"[accuracy] {n} frames at 320x240 (loop config, codebook in "
          f"effect: {run.codebook}) against JAX's run with the same pose "
          f"rule: frames where states, keyframe flags, reference keyframes "
          f"differ {gaps['differ']}; keyframes at {run.kf_frames} (JAX "
          f"{gaps['jax_kf_frames']}); LOST frames {gaps['lost']} (JAX "
          f"{gaps['jax_lost']}; tests/test_loop_closure.py's bound "
          f"{_smoke.ACCURACY_LOST_MAX}); |dT_cw|max {gaps['dT_max']:.2e}, "
          f"frames over {_smoke.TRACKER_T_TOL} {gaps['dT_over']} (the "
          f"card's own renders)", flush=True)
    print(f"[accuracy] loops (frame, keyframe slot, (loop seq, current "
          f"seq)): {gaps['loops']} (JAX {gaps['jax_loops']})", flush=True)
    print(f"[accuracy] ATE corrected {summ['ate_rmse_m']:.4f} m, raw "
          f"{summ['ate_rmse_raw_m']:.4f} m (JAX {want['ate_rmse_m']}, "
          f"{want['ate_rmse_raw_m']}); bound on the corrected "
          f"{gaps['ate_max']:.4f} m", flush=True)
    # every frame but the first that ends OK matched through the kernel
    # (a LOST frame launches it only if relocalization has a candidate)
    idle = [i for i in range(1, n) if run.records["state"][i] == 2
            and per_frame[i] < 1]
    if dev.type == "cuda" and (per_frame[0] != 0 or idle):
        fails.append(f"matcher launches per frame {per_frame}: none on the "
                     f"tracked frames {idle}")

    ms = np.asarray(run.ms)
    mapped = [i for i in range(1, n) if run.mapped[i]]
    busy = {c[0] for c in calls} | set(gaps["lost"])
    tracked = [i for i in range(1, n) if not run.mapped[i] and i not in busy]
    fire = [c for c in calls if c[2]]
    quiet = [c[1] for c in calls if not c[2]]
    lc = run.system._loop_closer
    gba = "not dispatched"
    if lc is not None and dev.type != "cuda" and lc.dispatch_seconds:
        gba = f"solved at dispatch in {lc.dispatch_seconds * 1e3:.1f} ms"
    elif lc is not None and lc.gba_events is not None:
        gba = (f"host dispatch {lc.dispatch_seconds * 1e3:.1f} ms, device "
               f"{lc.gba_events[0].elapsed_time(lc.gba_events[1]):.1f} ms")
    numbers = {"fps": n / (ms.sum() / 1e3), "ate": summ["ate_rmse_m"]}
    print(f"[accuracy] {numbers['fps']:.3f} frames/s over the {n} frames "
          f"(synchronised per frame; {seconds:.1f} s with the codebook's "
          f"training); tracked frames median {np.median(ms[tracked]):.1f} "
          f"ms; the {len(mapped)} frames that ran a local-mapping pass "
          f"median {np.median(ms[mapped]):.1f} ms, mean "
          f"{ms[mapped].mean():.1f} ms (each with loop.process); "
          f"loop.process {len(calls)} calls, median of those that did not "
          f"fire {np.median(quiet):.1f} ms; at the firing (frame "
          f"{fire[0][0] if fire else None}) "
          f"{fire[0][1] if fire else float('nan'):.1f} ms, its frame "
          f"{ms[fire[0][0]] if fire else float('nan'):.1f} ms (the global "
          f"BA included: the frame's synchronise waits for its stream); "
          f"global BA {gba}; on {card}", flush=True)
    hist = collections.Counter(per_frame)
    print(f"[accuracy] matcher launches {launches}: frames by launches "
          f"{dict(sorted(hist.items()))}", flush=True)
    err = 0.0
    for frame, a in kept.items():
        err = max(err, _hold_kept(a, "accuracy", torch, dev, frame))
    numbers["max_abs_err"] = err
    if fails:
        fail("accuracy phase: " + "; ".join(fails))
    return launches, numbers


def _hold_calls(kept: list, what: str, torch, dev) -> float:
    """The kernel against its plain version on every matcher launch kept
    from one call. -> the largest abs error."""
    from dr_slam_torch.ops import match_cuda

    if not kept:
        fail(f"{what}: no matcher launch kept")
    err = 0.0
    for k, a in enumerate(kept, 1):
        out_k = match_cuda.gated_top2_hamming(*a)
        _sync(torch, dev)
        out_r = match_cuda.gated_top2_hamming_ref(*a)
        mism, e = _compare(out_k, out_r, torch)
        print(f"[kernel] {what} launch {k}: K={a[0].shape[0]} "
              f"NC={a[4].shape[0]} valid={int(a[9].sum())} "
              f"mismatches={mism} max_abs_err={e}", flush=True)
        if any(mism.values()):
            fail(f"kernel disagrees with its plain version ({what} launch "
                 f"{k}): {mism}")
        err = max(err, e)
    return err


def _hold_evictions(data: dict, prefix: str, cfg, dev, torch) -> list:
    """Each forced eviction the fixture stored (the map compressed to the
    fields `cull_one_keyframe` reads): the port's `cull_one_keyframe(force=
    True)` on the card from JAX's state must free JAX's slot. -> the ms of
    each call (synchronised)."""
    from dr_slam_torch._smoke import fixture_evictions

    got, want, ms = fixture_evictions(data, prefix, cfg, dev,
                                      lambda: _sync(torch, dev))
    print(f"[behaviours] {prefix} forced evictions from JAX's states at calls "
          f"{data[f'{prefix}call'].tolist()}: slots freed {got} (JAX {want}), "
          f"{', '.join(f'{m:.2f}' for m in ms)} ms", flush=True)
    if got != want:
        fail(f"behaviours: forced evictions from JAX's states free {got}, "
             f"JAX {want}")
    return ms


def behaviours_phase(dev, card: str) -> tuple[dict, float]:
    """Phase 13: the reference behaviours against dr_slam_torch/data/
    behaviours.npz. 13a, the capacity wall at 640x480 through `System`;
    13b, the office world with its relocalization at 320x240 through
    `System`; 13c, the `DeviceLoopTracker` over 13a's frames. ->
    (matcher launches per sub-phase, the kernel's max abs error)."""
    import numpy as np
    import torch

    from dr_slam_torch import _smoke
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.device_loop import DeviceLoopTracker
    from dr_slam_torch.slam.system import System

    data = _smoke.load_behaviours_fixture()
    launches, err, fails = {}, 0.0, []
    kernel, cull = map_ops.gated_top2_hamming, map_ops.cull_one_keyframe
    per_call, kept, forced_ms = [], {}, []
    keep_calls = set()

    def keep(*a):
        if len(per_call) in keep_calls:
            kept.setdefault(len(per_call), []).append(
                tuple(x.clone() for x in a))
        return kernel(*a)

    def timed_cull(state, *a, force=False, **kw):
        if not force:
            return cull(state, *a, force=force, **kw)
        _sync(torch, dev)
        t0 = time.perf_counter()
        out = cull(state, *a, force=force, **kw)
        _sync(torch, dev)
        forced_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def run(system_fn, what):
        """Run `system_fn(sync)` with the matcher counted per call."""
        last = [match_cuda.gated_top2_hamming.launches]

        def sync():
            _sync(torch, dev)
            per_call.append(match_cuda.gated_top2_hamming.launches - last[0])
            last[0] = match_cuda.gated_top2_hamming.launches
        per_call.clear()
        kept.clear()
        forced_ms.clear()
        match_cuda.gated_top2_hamming.launches = 0
        last[0] = 0
        map_ops.gated_top2_hamming = keep
        map_ops.cull_one_keyframe = timed_cull
        try:
            out = system_fn(sync)
        finally:
            map_ops.gated_top2_hamming = kernel
            map_ops.cull_one_keyframe = cull
        launches[what] = match_cuda.gated_top2_hamming.launches
        return out

    # --- 13a: the capacity wall at full width ---------------------------------
    cfg = _smoke.wall_cfg(tum_freiburg3(), culling=False)
    n = _smoke.WALL640_FRAMES
    seq = _smoke.wall_sequence(cfg, n, dev)
    frames = [seq.render(i) for i in range(n)]
    ev_ms = _hold_evictions(data, "ev_", cfg, dev, torch)
    ev_ms += _hold_evictions(data, "cev_", cfg, dev, torch)
    keep_calls = {int(data["ev_call"][0])}
    wall = run(lambda sync: _smoke.wall_run(
        System(cfg, enable_loop_closing=False, device=dev),
        lambda i: frames[i], n, sync), "wall")
    want = {k[len("wall_"):]: v for k, v in data.items()
            if k.startswith("wall_")}
    gaps, f = _smoke.behaviour_gaps(want, wall)
    fails += [f"13a: {x}" for x in f]
    ms = np.asarray(wall["ms"])
    passes = [i for i in range(1, n) if wall["kf"][i]]
    tracked = [i for i in range(1, n) if not wall["kf"][i]]
    print(f"[behaviours] 13a wall at 640x480, 12 slots, culling off, {n} "
          f"frames of the port's renders against JAX's run: {json.dumps(gaps)}"
          f"; keyframes at calls {passes}; live slots at the end "
          f"{int((wall['kf_seq'][-1] >= 0).sum())}", flush=True)
    print(f"[behaviours] 13a {n / (ms.sum() / 1e3):.3f} frames/s "
          f"(synchronised per frame); tracked calls median "
          f"{np.median(ms[tracked]):.1f} ms; calls with a pass median "
          f"{np.median(ms[passes]):.1f} ms, mean {ms[passes].mean():.1f} ms; "
          f"forced evictions in the run {len(forced_ms)} at "
          f"{', '.join(f'{m:.2f}' for m in forced_ms)} ms; matcher launches "
          f"{launches['wall']}, per call {per_call} on {card}", flush=True)
    if len(forced_ms) != len(data["ev_call"]):
        fails.append(f"13a: {len(forced_ms)} forced evictions, JAX "
                     f"{len(data['ev_call'])}")
    idle = [i for i in range(1, n) if per_call[i] < 2]
    if idle:
        fails.append(f"13a: calls {idle} launched the matcher under twice")
    err = max(err, _hold_calls(kept.get(min(keep_calls), []),
                               f"wall call {min(keep_calls)}", torch, dev))

    # --- 13b: the office world and its relocalization -------------------------
    ocfg = _smoke.office_cfg()
    orender, black = _smoke.office_fixture_frames(data, dev)
    keep_calls = {int(data["office_reloc_call"])}
    office = run(lambda sync: _smoke.office_run(
        System(ocfg, enable_loop_closing=False, device=dev), orender, black,
        sync), "office")
    want = {k[len("office_"):]: v for k, v in data.items()
            if k.startswith("office_")}
    # Call 2 reads back frame 1's inliers, the first tracked frame's, whose
    # pose both packages leave about 7e-3 from the truth: there the port's
    # own float order (card against CPU) moves the count by more than the
    # bound, so it is held from the port on this host's CPU instead.
    gaps, f = _smoke.behaviour_gaps(want, office, unheld_count_calls=(2,))
    fails += [f"13b: {x}" for x in f]
    crec = _smoke.BehaviourRecorder(System(ocfg, enable_loop_closing=False,
                                           device="cpu"))
    crender, _ = _smoke.office_fixture_frames(data)
    for i in range(3):
        crec.track(*crender(i), i / 30.0)
    first = [int(want["n_inliers"][2]), int(office["n_inliers"][2]),
             int(crec.arrays()["n_inliers"][2])]
    print(f"[behaviours] 13b frame 1's inliers (call 2): JAX {first[0]}, the "
          f"card {first[1]}, the port on this host's CPU {first[2]}",
          flush=True)
    if abs(first[2] - first[0]) > _smoke.TRACKER_COUNT_TOL * first[0]:
        fails.append(f"13b: frame 1's inliers on the CPU {first[2]}, JAX "
                     f"{first[0]}")
    acc = _smoke.office_acceptance(office, data["office_poses_cw"])
    call = int(office["reloc_call"])
    print(f"[behaviours] 13b office at 320x240 (fx 262), 40 frames, 3 black, "
          f"frame 20 again: states {office['state'].tolist()}; against JAX's "
          f"run: {json.dumps(gaps)}; relocalized at call {call} (JAX "
          f"{int(want['reloc_call'])}); acceptance {json.dumps(acc)}; the "
          f"relocalized call {office['ms'][call] if call >= 0 else 0:.1f} ms, "
          f"tracked calls median {np.median(office['ms'][1:40]):.1f} ms; "
          f"matcher launches {launches['office']}, on the relocalized call "
          f"{per_call[call] if call >= 0 else 0} on {card}", flush=True)
    if call != int(want["reloc_call"]):
        fails.append(f"13b: relocalized at call {call}, JAX "
                     f"{int(want['reloc_call'])}")
    if not (acc["lost"] == 0 and acc["ate"] < _smoke.OFFICE_ATE_MAX
            and acc["blackout_lost"] and acc["reloc_try"] in (0, 1)
            and acc["reloc_err"] < _smoke.OFFICE_RELOC_MAX):
        fails.append(f"13b: the JAX tests' acceptance fails: {acc}")
    if call >= 0:
        err = max(err, _hold_calls(kept.get(call, []),
                                   f"office relocalized call {call}", torch,
                                   dev))

    # --- 13c: the device loop over 13a's frames --------------------------------
    dl_ms = _hold_evictions(data, "dlev_", cfg, dev, torch)
    nk = cfg.map.max_keyframes

    def device_loop(sync):
        lt = DeviceLoopTracker(cfg, device=dev)
        n_before, ms = [], []
        for i, (g, d) in enumerate(frames):
            n_before.append(int(lt.carry.map_state.kf_valid.sum()))
            t0 = time.perf_counter()
            lt.track(g, d, i / 30.0)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return lt, n_before, np.asarray(ms)

    with _smoke.shipped_codebooks():
        lt, n_before, ms = run(device_loop, "device loop")
    rec, jrec = lt.flush()["records"], data["dl_records"][:n]
    jn = data["dl_n_kfs_before"][:n].tolist()
    differ = {name: np.nonzero(rec[:, k] != jrec[:, k])[0].tolist()
              for k, name in _smoke.DEVICE_LOOP_EXACT.items()}
    wall_steps = [i for i in range(n) if jn[i] >= nk - 1
                  and jrec[i, 19] > 0.5]
    want_reads = [2 if i in wall_steps else 1 for i in range(n)]
    dT = float(np.abs(rec[:, :16] - jrec[:, :16]).max())
    print(f"[behaviours] 13c device loop over 13a's frames against JAX's: "
          f"differ {json.dumps(differ)}; live keyframes before each step "
          f"{'equal' if n_before == jn else n_before} (JAX {jn}); JAX's wall "
          f"steps {wall_steps}; readbacks per step {lt.readbacks}; "
          f"|dT_cw|max {dT:.2e}; {n / (ms.sum() / 1e3):.3f} frames/s, wall "
          f"steps median {np.median(ms[wall_steps]):.1f} ms, other steps "
          f"median {np.median(np.delete(ms, wall_steps)):.1f} ms; matcher "
          f"launches {launches['device loop']} on {card}", flush=True)
    fails += [f"13c: {k} differs at steps {v}" for k, v in differ.items()
              if v]
    if dT > _smoke.TRACKER_T_TOL:
        fails.append(f"13c: |dT_cw| {dT:.2e} over {_smoke.TRACKER_T_TOL}")
    if n_before != jn:
        fails.append("13c: live keyframes before a step differ from JAX's")
    if lt.readbacks != want_reads:
        fails.append(f"13c: readbacks {lt.readbacks}, want {want_reads}")
    if not wall_steps:
        fails.append("13c: JAX's run never reached the wall")
    print(f"[behaviours] forced evictions alone: 13a's {len(ev_ms)} from "
          f"JAX's states median {np.median(ev_ms):.2f} ms, 13c's "
          f"{len(dl_ms)} median {np.median(dl_ms):.2f} ms on {card}",
          flush=True)
    if fails:
        fail("behaviours phase: " + "; ".join(fails))
    return launches, err


BENCH_TRACKING_FRAMES = 60   # bench.py's bench_tracking length, uncut
BENCH_DEVICE_FRAMES = 48     # bench_interactive_device: 120 in bench.py
BENCH_DEVICE_WARM = 25
BENCH_FRONTEND_FRAMES = 30
BENCH_KEPT_CALL = 40         # 14b's call whose matcher inputs are held
BENCH_ATE_MAX = 0.05         # the legs' ATE (m), as run_synthetic's bound


def _sync_calls(torch, fn) -> int:
    """The synchronising CUDA calls `fn` makes, counted as the warnings of
    `torch.cuda.set_sync_debug_mode("warn")`."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def _hold_counts(got, want, what: str, fails: list) -> float:
    """Counts within TRACKER_COUNT_TOL of JAX's. -> the largest relative
    gap."""
    from dr_slam_torch._smoke import TRACKER_COUNT_TOL, count_gaps

    rel = count_gaps(got, want)
    over = [int(i) for i in (rel > TRACKER_COUNT_TOL).nonzero()[0]]
    if over:
        fails.append(f"{what} off by more than {TRACKER_COUNT_TOL} at "
                     f"{over}: {[int(got[i]) for i in over]}, JAX "
                     f"{[int(want[i]) for i in over]}")
    return float(rel.max()) if rel.size else 0.0


def _hold_ate(T_cws, want_T_cws, poses, what: str, fails: list) -> tuple:
    """ATE under BENCH_ATE_MAX and within 2x + 5 mm of JAX's on the same
    poses. -> (ATE, JAX's ATE)."""
    from dr_slam_torch._smoke import trajectory_ate

    ate = trajectory_ate(T_cws, poses)
    want = trajectory_ate(want_T_cws, poses)
    if not (ate < BENCH_ATE_MAX and ate <= 2 * want + 0.005):
        fails.append(f"{what} ATE {ate:.5f} m (JAX {want:.5f})")
    return ate, want


def bench_phase(dev, card: str) -> tuple[dict, float]:
    """Phase 14: bench_torch.py's legs on the card at cut depths, each held
    against the JAX package's run of the same loop in
    dr_slam_torch/data/bench_runs.npz. 14a: the odometry leg on the mapping
    fixture's frames 0-15, its map against smoke_corridor.npz's, one
    pipelined window of PIPELINE_FRAMES frames; 14b: the tracking leg over
    its 60 frames; 14c: the device-loop leg over BENCH_DEVICE_FRAMES frames
    after BENCH_DEVICE_WARM; 14d: the front-end leg. -> (matcher launches
    per leg, the kernel's max abs error)."""
    import numpy as np
    import torch

    import bench_torch
    from dr_slam_torch import _smoke
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.io import synthetic
    from dr_slam_torch.ops import match_cuda
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.track_step import extract_and_track

    cfg = tum_freiburg3()
    data = _smoke.load_bench_fixture()
    launches, fails = {}, []
    counter = match_cuda.gated_top2_hamming

    # 14a: the odometry leg's map from JAX's frames, then one window
    mdata = _smoke.load_mapping_fixture()
    df = cfg.camera.depth_factor
    frames = [(mdata["gray"][i].astype(np.float32),
               mdata["depth"][i].astype(np.float32) / df)
              for i in range(bench_torch.ODOMETRY_FRAMES)]
    counter.launches = 0
    odo = bench_torch.bench_odometry(PIPELINE_FRAMES, cfg, dev, frames,
                                     windows=1)
    rec = odo.record
    got_map = rec["loaded_map"]
    for name in got_map._fields:
        a, b = getattr(got_map, name), getattr(rec["system_map"], name)
        if not torch.equal(a, b):
            fails.append(f"14a: the loaded map's {name} differs from the "
                         "System's")
    kf_valid = got_map.kf_valid.cpu().numpy()
    want_valid = data["odo_kf_valid"]
    n_pts, want_pts = int(got_map.pt_valid.sum()), int(data["odo_n_pts"])
    dpose = float(np.abs(got_map.kf_pose.cpu().numpy()
                         - data["odo_kf_pose"])[want_valid].max())
    if not np.array_equal(kf_valid, want_valid):
        fails.append(f"14a: kf_valid {np.nonzero(kf_valid)[0].tolist()}, JAX "
                     f"{np.nonzero(want_valid)[0].tolist()}")
    _hold_counts([n_pts], [want_pts], "14a: map points", fails)
    if dpose > _smoke.TRACKER_T_TOL:
        fails.append(f"14a: keyframe poses {dpose:.2e} from JAX's")
    # smoke_corridor.npz's map: the same frames' float renders, built by JAX
    # without the lag rule and flushed (printed, not held)
    smoke_pts = int(_smoke.load_npz(_smoke.FIXTURE)["map__pt_valid"].sum())
    out = rec["out"]
    if (rec["launches"] != [2 * PIPELINE_FRAMES]
            or not bool(torch.isfinite(out.T_cw).all())):
        fails.append(f"14a: window launches {rec['launches']}, want "
                     f"{2 * PIPELINE_FRAMES}, finite pose "
                     f"{bool(torch.isfinite(out.T_cw).all())}")
    st, T, R = rec["start"]
    g, d = rec["staged"][0]
    eye = torch.eye(4, device=dev)
    ref = torch.tensor(1, device=dev)
    syncs = _sync_calls(torch, lambda: extract_and_track(
        g, d, st, T, eye, R, ref, cfg, device=dev))
    launches["odometry"] = counter.launches
    print(f"[bench] 14a odometry: map of frames 0-11 {int(kf_valid.sum())} "
          f"keyframes (JAX {int(want_valid.sum())}), {n_pts} points (JAX "
          f"{want_pts}; smoke_corridor.npz's unlagged map {smoke_pts}), "
          f"keyframe poses {dpose:.2e} from JAX's, loaded map equal to the "
          f"System's; {PIPELINE_FRAMES} pipelined frames "
          f"{odo.fps:.3f} frames/s, last frame n_inliers "
          f"{int(out.n_inliers)} n_matches {int(out.n_matches)}, launches "
          f"{rec['launches']}; {syncs} synchronising calls in one pipelined "
          f"frame (torch.cuda.set_sync_debug_mode) on {card}", flush=True)

    # 14b: the tracking leg over the fixture's frames, JAX's renders: on the
    # port's own the pose moves 4.3e-3 (scripts/parity_bench_torch.py)
    kernel, kept, calls = map_ops.gated_top2_hamming, [], [0]

    def keep(*a):
        calls[0] += 1
        if calls[0] == 2 * BENCH_KEPT_CALL - 1:
            kept.append(tuple(x.clone() for x in a))
        return kernel(*a)

    map_ops.gated_top2_hamming = keep
    counter.launches = 0
    try:
        trk = bench_torch.bench_tracking(
            BENCH_TRACKING_FRAMES, cfg, dev,
            _smoke.bench_fixture_frames(data, df))
    finally:
        map_ops.gated_top2_hamming = kernel
    launches["tracking"] = counter.launches
    got, n = trk.record, BENCH_TRACKING_FRAMES
    want = {k: data[f"trk_{k}"][:n] for k in
            ("state", "is_keyframe", "ref_kf", "T_cw", "n_inliers",
             "n_matches")}
    want["kf_frames"] = data["trk_kf_frames"]
    for k in ("state", "is_keyframe", "ref_kf", "kf_frames"):
        if not np.array_equal(got[k], want[k]):
            fails.append(f"14b: {k} {got[k].astype(int).tolist()}, JAX "
                         f"{want[k].astype(int).tolist()}")
    dT = float(np.abs(got["T_cw"] - want["T_cw"]).max())
    if dT > _smoke.TRACKER_T_TOL:
        fails.append(f"14b: |dT_cw| {dT:.2e} > {_smoke.TRACKER_T_TOL}")
    held = _smoke.bench_inliers_held(n, lag=1)
    rel = max(_hold_counts(got["n_inliers"][held], want["n_inliers"][held],
                           "14b: n_inliers", fails),
              _hold_counts(got["n_matches"], want["n_matches"],
                           "14b: n_matches", fails))
    pyramid = [(int(i), int(got["n_inliers"][i]), int(want["n_inliers"][i]))
               for i in np.nonzero(~held)[0]]
    if got["n_kfs"] != int(data["trk_n_kfs"]):
        fails.append(f"14b: {got['n_kfs']} keyframes, JAX "
                     f"{int(data['trk_n_kfs'])}")
    _hold_counts([got["n_pts"]], [int(data["trk_n_pts"])], "14b: points",
                 fails)
    poses = synthetic.corridor_trajectory(n)
    ate, jax_ate = _hold_ate(got["T_cw"], want["T_cw"], poses, "14b", fails)
    want_launches = [0] + [2] * (n - 1)
    if got["launches"].tolist() != want_launches:
        fails.append(f"14b: launches per frame {got['launches'].tolist()}")
    print(f"[bench] 14b tracking: {n} frames, "
          f"{got['warm']} warm, {trk.fps:.3f} frames/s timed; keyframes at "
          f"{got['kf_frames'].tolist()} (JAX "
          f"{data['trk_kf_frames'].tolist()}), |dT_cw| {dT:.2e}, counts "
          f"within {rel:.4f} (inliers on the pyramid's frames, held by "
          f"their witness on the CPU: (record, port, JAX) {pyramid}), "
          f"{got['n_pts']} points (JAX "
          f"{int(data['trk_n_pts'])}), ATE {ate:.5f} m (JAX {jax_ate:.5f}), "
          f"launches {launches['tracking']} on {card}", flush=True)
    err = _hold_calls(kept, f"14b call {BENCH_KEPT_CALL}", torch, dev)

    # 14c: the device-loop leg with its staged copies
    counter.launches = 0
    dl = bench_torch.bench_interactive_device(
        BENCH_DEVICE_FRAMES, BENCH_DEVICE_WARM, cfg, dev)
    launches["device loop"] = counter.launches
    got, want = dl.record["records"], data["dl_records"][:BENCH_DEVICE_FRAMES]
    for k, name in _smoke.DEVICE_LOOP_EXACT.items():
        if not np.array_equal(got[:, k], want[:, k]):
            fails.append(f"14c: {name} {got[:, k].astype(int).tolist()}, JAX "
                         f"{want[:, k].astype(int).tolist()}")
    dT = float(np.abs(got[:, :16] - want[:, :16]).max())
    if dT > _smoke.TRACKER_T_TOL:
        fails.append(f"14c: |dT_cw| {dT:.2e} > {_smoke.TRACKER_T_TOL}")
    held = _smoke.bench_inliers_held(len(got))
    rel = max(_hold_counts(got[:, 17][held], want[:, 17][held],
                           "14c: n_inliers", fails),
              _hold_counts(got[:, 18], want[:, 18], "14c: n_matches", fails))
    pyramid = [(int(f), int(got[f, 17]), int(want[f, 17]))
               for f in np.nonzero(~held)[0]]
    poses = synthetic.corridor_trajectory(BENCH_DEVICE_FRAMES)
    ate, jax_ate = _hold_ate(got[:, :16].reshape(-1, 4, 4),
                             want[:, :16].reshape(-1, 4, 4), poses, "14c",
                             fails)
    want_launches = _smoke.expected_launches(dl.record["states"],
                                             dl.record["relocs"])
    if dl.record["launches"].tolist() != want_launches:
        fails.append(f"14c: launches per step {dl.record['launches'].tolist()}"
                     f", want {want_launches}")
    print(f"[bench] 14c device loop: {BENCH_DEVICE_FRAMES} frames, "
          f"{BENCH_DEVICE_WARM} warm, {dl.fps:.3f} frames/s through the "
          f"pinned, double-buffered copies; keyframes at "
          f"{np.nonzero(got[:, 19])[0].tolist()}, |dT_cw| {dT:.2e}, counts "
          f"within {rel:.4f} (inliers on the pyramid's frames, held by "
          f"their witness on the CPU: (frame, port, JAX) {pyramid}), ATE "
          f"{ate:.5f} m (JAX {jax_ate:.5f}), readbacks "
          f"per step {dl.record['readbacks'].tolist()}, launches "
          f"{launches['device loop']} on {card}", flush=True)

    # 14d: the front-end leg
    fe = bench_torch.bench_frontend(BENCH_FRONTEND_FRAMES, device=dev)
    rel = _hold_counts(fe.record["n_valid"],
                       data["fe_n_valid"][:BENCH_FRONTEND_FRAMES],
                       "14d: valid keypoints", fails)
    print(f"[bench] 14d front-end: {BENCH_FRONTEND_FRAMES} frames "
          f"{fe.fps:.3f} frames/s, valid keypoints within {rel:.4f} of JAX's "
          f"on {card}", flush=True)
    if fails:
        fail("bench phase: " + "; ".join(fails))
    return launches, err


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
                                      load_mapping_fixture,
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
    # --- 11. the renderer, the run script, sharded solves, the trainer -------
    synth_launches, synth_numbers = synthetic_phase(dev, cfg, card)
    err = max(err, synth_numbers["max_abs_err"])
    # --- 12. the closed-loop accuracy protocol -------------------------------
    accuracy_launches, accuracy_numbers = accuracy_phase(dev, card)
    err = max(err, accuracy_numbers["max_abs_err"])
    # --- 13. the reference behaviours: the wall, the office, the loop's wall -
    behaviour_launches, err13 = behaviours_phase(dev, card)
    err = max(err, err13)
    # --- 14. bench_torch.py's legs ---------------------------------------------
    bench_launches, err14 = bench_phase(dev, card)
    err = max(err, err14)
    print(f"[kernel] launches by path: main {launches}, tracker "
          f"{tracker_launches}, system a {system_launches['a']}, system b "
          f"{system_launches['b']}, loop {loop_launches}, device loop "
          f"{device_loop_launches}, multi-sequence {multi_launches}, runner "
          f"{tum_launches['runner']}, node {tum_launches['node']}, detector "
          f"System {detect_launches}, run_synthetic {synth_launches}, "
          f"accuracy protocol {accuracy_launches}, behaviours "
          f"{json.dumps(behaviour_launches)}, bench legs "
          f"{json.dumps(bench_launches)}", flush=True)
    total_launches = (launches + tracker_launches
                      + sum(system_launches.values()) + loop_launches
                      + device_loop_launches + multi_launches
                      + sum(tum_launches.values()) + detect_launches
                      + synth_launches + accuracy_launches
                      + sum(behaviour_launches.values())
                      + sum(bench_launches.values()))
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
