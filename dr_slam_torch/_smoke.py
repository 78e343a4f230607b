"""Shared pieces of the port's GPU smoke run (`chip_smoke.py`), its frame
profiler (`scripts/profile_torch_frame.py`) and its CUDA and full-size
tests: the card's name line, the smoke fixture, the pipelined frame loop,
matcher inputs at the main path's shapes, the mapping fixture with the
Tracker run over it, the reloc fixture with the System run over it, the
loop fixture with the bounds of a loop correction, and the device-loop
fixture with the DeviceLoopTracker run over the mapping fixture's frames,
the TUM fixture with the dataset runner and a streaming-node session
over the same frames exported as a TUM sequence, and the synthetic fixture
with its scenes, the realistic-capacity map configuration and the map
state's checksums, and the closed-loop accuracy protocol of
scripts/bench_accuracy.py with its fixture and bounds."""

from __future__ import annotations

import contextlib
import os
import subprocess
import threading
import time
from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch import to_numpy
from dr_slam_torch.io.map_io import from_jax_state
from dr_slam_torch.slam.state import MapState
from dr_slam_torch.slam.track_step import extract_and_track

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "smoke_corridor.npz")
MAPPING_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "mapping_corridor.npz")


def register_shipped_codebooks() -> None:
    """Register the shipped codebooks (data/vocab512.npz, data/vocab.npz),
    as the `System` does at construction. The fixtures were made by JAX
    `System`s, which register them; a bare `Tracker` or `DeviceLoopTracker`
    registers none, and unregistered the port, like the reference, falls
    back to the seeded random codebook."""
    from dr_slam_torch.associate import vocabulary as voc

    data_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
    for name in ("vocab512.npz", "vocab.npz"):
        voc.load_vocabulary(os.path.join(data_dir, name))


@contextlib.contextmanager
def _restored_codebooks():
    """The codebook registry as it was before the block, with the codebook
    caches cleared."""
    from dr_slam_torch.associate import vocabulary as voc

    saved = dict(voc._trained_signs)
    try:
        yield
    finally:
        voc._trained_signs.clear()
        voc._trained_signs.update(saved)
        voc.get_codebook_signs.cache_clear()
        voc._codebook.cache_clear()


@contextlib.contextmanager
def shipped_codebooks():
    """`register_shipped_codebooks` for the block, then the registry as it
    was, with the codebook caches cleared."""
    with _restored_codebooks():
        register_shipped_codebooks()
        yield


def card_line() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` gives
    them (first card)."""
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
    except OSError:
        return "nvidia-smi unavailable"
    return proc.stdout.strip().splitlines()[0] if proc.returncode == 0 \
        else "nvidia-smi unavailable"


class Fixture(NamedTuple):
    data: dict            # the .npz arrays, the JAX outputs among them
    state: MapState       # the map the JAX package built
    frames: list          # [(gray uint8, depth as int32)] on the device
    T_last: torch.Tensor
    velocity: torch.Tensor
    R_cm: torch.Tensor
    ref_kf: torch.Tensor


def load_fixture(device) -> Fixture:
    """The smoke fixture (made by scripts/make_torch_smoke_fixture.py) on
    `device`: the map, frames 12-15 as the sensor gives them, the tracker
    state before frame 12, and the JAX outputs for those frames."""
    with np.load(FIXTURE) as fx:
        data = {k: fx[k] for k in fx.files}
    state = from_jax_state({k[5:]: v for k, v in data.items()
                            if k.startswith("map__")}, device)
    frames = [(torch.from_numpy(g).to(device),
               torch.from_numpy(d.astype(np.int32)).to(device))
              for g, d in zip(data["gray"], data["depth"])]
    T, V, R = (torch.from_numpy(data[k]).to(device)
               for k in ("T_last", "velocity", "R_cm"))
    return Fixture(data, state, frames, T, V, R,
                   torch.tensor(int(data["ref_kf"]), device=device))


def pipelined(fx: Fixture, n: int, cfg):
    """`n` frames of `extract_and_track`, the fixture's frames cycled and
    enqueued back to back as the JAX package's bench_odometry does: map
    state, pose and Manhattan rotation chained, the velocity held at the
    identity. Returns the last output; the caller synchronises."""
    st, T, R = fx.state, fx.T_last, fx.R_cm
    V = torch.eye(4, device=T.device)
    out = None
    for i in range(n):
        g, d = fx.frames[i % len(fx.frames)]
        _, out = extract_and_track(g, d, st, T, V, R, fx.ref_kf, cfg,
                                   device=T.device)
        st, T, R = out.new_map_state, out.T_cw, out.R_cm
    return out


def synthetic_matcher_inputs(K=1024, NC=32768, n_valid=3000, n_ties=64,
                             seed=0, device="cuda"):
    """Matcher inputs shaped like the main path's: K keypoints over a
    640x480 frame, NC candidate slots of which the first ~n_valid hold live
    map points (slots fill low-first), descriptors near the keypoints'
    ones, plus equal-distance ties: for n_ties keypoints two candidates in
    different tiles with the same descriptor and window, and pairs of
    identical keypoints that tie on a column."""
    rng = np.random.RandomState(seed)
    kp_desc = rng.randint(-2 ** 31, 2 ** 31, (K, 8), dtype=np.int64).astype(np.int32)
    kp_uv = np.stack([rng.uniform(0, 640, K), rng.uniform(0, 480, K)], 1)
    kp_valid = rng.rand(K) < 0.97
    kp_oct = rng.randint(0, 8, K)
    pt_desc = rng.randint(-2 ** 31, 2 ** 31, (NC, 8), dtype=np.int64).astype(np.int32)
    pt_uv = np.stack([rng.uniform(0, 640, NC), rng.uniform(0, 480, NC)], 1)
    pt_rad = np.full(NC, 28.0) * 1.2 ** rng.randint(0, 3, NC)
    pt_lvl = rng.randint(0, 8, NC)
    pt_si = rng.rand(NC) < 0.9
    pt_valid = np.zeros(NC, bool)
    pt_valid[:n_valid] = rng.rand(n_valid) < 0.8
    # candidates observed from keypoints: a copy with a few flipped bits
    src = rng.randint(0, K, n_valid)
    flips = (rng.rand(n_valid, 8, 32) < 0.05)
    pt_desc[:n_valid] = kp_desc[src] ^ (flips * (1 << np.arange(32))).sum(-1).astype(np.int64).astype(np.int32)
    pt_uv[:n_valid] = kp_uv[src] + rng.normal(0, 3, (n_valid, 2))
    pt_lvl[:n_valid] = kp_oct[src]
    # row ties across tiles: the same descriptor and place in two tiles
    for i in range(n_ties):
        k = int(rng.randint(0, K))
        c1 = int(rng.randint(0, max(1, n_valid // 2)))
        c2_lo = min(n_valid // 2 + 512, NC - 1)
        c2 = int(rng.randint(c2_lo, max(c2_lo + 1, min(NC, n_valid + 8192))))
        for c in (c1, c2):
            pt_desc[c] = kp_desc[k]
            pt_uv[c] = kp_uv[k]
            pt_lvl[c] = kp_oct[k]
            pt_valid[c] = True
        kp_valid[k] = True
    # column ties: a keypoint duplicated at a higher index
    for i in range(n_ties):
        k1, k2 = sorted(rng.choice(K, 2, replace=False))
        kp_desc[k2], kp_uv[k2], kp_oct[k2], kp_valid[k2] = \
            kp_desc[k1], kp_uv[k1], kp_oct[k1], kp_valid[k1]
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt).to(device)
    return (t(kp_desc, torch.int32), t(kp_uv, torch.float32),
            t(kp_valid, torch.bool), t(kp_oct, torch.int32),
            t(pt_desc, torch.int32), t(pt_uv, torch.float32),
            t(pt_rad, torch.float32), t(pt_lvl, torch.int32),
            t(pt_si, torch.bool), t(pt_valid, torch.bool))


def load_mapping_fixture() -> dict:
    """The mapping fixture (made by scripts/make_torch_mapping_fixture.py):
    24 corridor frames in camera-native types and the JAX tracker's outputs
    over them from an empty map."""
    with np.load(MAPPING_FIXTURE) as fx:
        return {k: fx[k] for k in fx.files}


class TrackerRun(NamedTuple):
    results: list        # TrackingResult per frame
    tracker: object      # the Tracker, flushed
    launches: list       # matcher launches per frame
    seconds: float       # wall time of the frames (synchronised per frame)
    keyframes: list      # per insertion [(stage, device ms)]; cuda only


def run_tracker(data: dict, cfg, device) -> TrackerRun:
    """The port's Tracker from an empty map over the fixture's frames, fed
    as the JAX tracker was (gray as float32, depth as d16 / depth_factor in
    float32), synchronised after each frame so the deferred decision lags
    by exactly one frame. On the GPU each keyframe stage is timed with a
    pair of CUDA events."""
    from dr_slam_torch.ops.match_cuda import gated_top2_hamming
    from dr_slam_torch.slam.tracking import Tracker

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tracker = Tracker(cfg, device=dev)
    if cuda:
        tracker.stage_events = []
    results, launches = [], []
    t0 = time.perf_counter()
    for i in range(len(data["gray"])):
        gray = data["gray"][i].astype(np.float32)
        depth = (data["depth"][i] / cfg.camera.depth_factor).astype(np.float32)
        before = gated_top2_hamming.launches
        results.append(tracker.process_frame(gray, depth, i / 30.0))
        if cuda:
            torch.cuda.synchronize()
        launches.append(gated_top2_hamming.launches - before)
    seconds = time.perf_counter() - t0
    tracker.flush()
    keyframes = []
    if cuda:
        torch.cuda.synchronize()
        for name, a, b in tracker.stage_events:
            if name == "kf.add":
                keyframes.append([])
            keyframes[-1].append((name, a.elapsed_time(b)))
    return TrackerRun(results, tracker, launches, seconds, keyframes)


# Bounds of a Tracker run against the JAX outputs in the mapping fixture.
# The JAX package's jitted pyramid computes its resize weights with other
# float32 rounding than the port (PERF.md §6), which reorders keypoints
# whose FAST responses are near-tied: counts move by one or two. Each
# keyframe's local bundle adjustment is float32 conjugate gradients whose
# sums run in another order (and on the card cuBLAS and reductions sum in
# yet another), and tracking carries the difference forward. Observed:
# |dT_cw| 6.7e-4 on an H100 and on the CPU with 1, 2 or 8 threads, 1.0e-3
# with 4 (the sums' order follows the thread count); the point count
# exact; counts within 1 on the CPU and within 4 (0.7%, the first tracked
# frame) on the H100.
TRACKER_T_TOL = 3e-3     # max |T_cw - T_cw_jax| entry over the frames
TRACKER_COUNT_TOL = 0.02  # |n_inliers|, |n_matches|, |n_pts| vs jax, relative


def count_gaps(got, want) -> np.ndarray:
    """Each count's distance from JAX's over JAX's (at least 1): what
    TRACKER_COUNT_TOL bounds."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want) / np.maximum(want, 1)


def tracker_gaps(run: TrackerRun, data: dict, t0: float = 0.0
                 ) -> tuple[dict, list]:
    """The run's distances from the JAX outputs, and the failed checks
    (frame i has the timestamp t0 + i / 30)."""
    res, st = run.results, run.tracker.map_state
    dT = [float(np.abs(to_numpy(r.T_cw) - data["T_cw"][i]).max())
          for i, r in enumerate(res)]
    kf_frames = [int(round((ts - t0) * 30.0))
                 for ts, _ in run.tracker.kf_log]
    gaps = dict(
        max_dT=max(dT),
        d_inliers=max(abs(r.n_inliers - int(data["n_inliers"][i]))
                      for i, r in enumerate(res)),
        d_matches=max(abs(r.n_matches - int(data["n_matches"][i]))
                      for i, r in enumerate(res)),
        kf_frames=kf_frames, n_kfs=int(st.n_kfs), n_pts=int(st.n_pts),
        n_planes=int(st.pl_valid.sum()), n_lines=int(st.ln_valid.sum()))
    fails = []
    if not (res[0].is_keyframe and res[0].state.name == "OK"):
        fails.append("frame 0 did not initialize the map")
    if any(r.state.name != "OK" for r in res) or run.tracker.state.name != "OK":
        fails.append("a frame was not tracked OK")
    if [r.is_keyframe for r in res] != data["is_keyframe"].tolist():
        fails.append("is_keyframe differs from the JAX tracker's")
    want = [int(f) for f in data["kf_frames"]]
    if kf_frames != want:
        fails.append(f"keyframes at frames {kf_frames}, JAX at {want}")
    if gaps["max_dT"] > TRACKER_T_TOL:
        fails.append(f"|dT_cw| {gaps['max_dT']:.2e} > {TRACKER_T_TOL}")
    for i, r in enumerate(res):
        for name, got in (("n_inliers", r.n_inliers), ("n_matches", r.n_matches)):
            ref = int(data[name][i])
            if abs(got - ref) > TRACKER_COUNT_TOL * max(ref, 1):
                fails.append(f"frame {i}: {name} {got}, JAX {ref}")
    if gaps["n_kfs"] != int(data["n_kfs"]):
        fails.append(f"n_kfs {gaps['n_kfs']}, JAX {int(data['n_kfs'])}")
    ref = int(data["n_pts"])
    if abs(gaps["n_pts"] - ref) > TRACKER_COUNT_TOL * ref:
        fails.append(f"n_pts {gaps['n_pts']}, JAX {ref}")
    return gaps, fails


# --- the System: relocalization into a saved map, and loop closing ---------

RELOC_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "reloc_corridor.npz")
LOOP_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "loop_small.npz")


def load_npz(path: str) -> dict:
    with np.load(path) as fx:
        return {k: fx[k] for k in fx.files}


def small_cfg():
    """tests/test_tracking_e2e.py's configuration in the port: 320x240, 512
    keypoints, 4096 map points, 32 keyframes, 512 vocabulary words."""
    from dr_slam_torch.config import (CameraConfig, LineConfig, MapConfig,
                                      ORBConfig, SlamConfig)
    return SlamConfig(
        camera=CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                            width=320, height=240, bf=20.0),
        orb=ORBConfig(n_features=400, n_levels=4, max_keypoints=512),
        line=LineConfig(max_lines=32),
        map=MapConfig(max_points=4096, max_lines=512, max_planes=32,
                      max_keyframes=32, vocab_words=512))


def loop_small_cfg():
    """The configuration of the JAX package's loop scenario
    (tests/test_loop_closure.py), which the loop fixture was made at:
    320x240, 512 keypoints, 4096 map points, 32 keyframes, 512 words,
    keyframe culling off, 15 / 6 px match windows, loop consistency 1."""
    import dataclasses

    cfg = small_cfg()
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, run_kf_culling=False, motion_search_radius=15.0,
        local_search_radius=6.0, loop_consistency=1))


def loop_call(data: dict, call: str) -> dict:
    """The inputs of one watched `LoopCloser.process` call of the loop
    fixture (`call` "fire" or "prev"), as numpy arrays and Python values:
    the map's fields, the current keyframe, the odometry table and the
    closer's state before the call."""
    p = f"{call}__"
    m = p + "map__"
    return dict(
        state={k[len(m):]: v for k, v in data.items() if k.startswith(m)},
        cur_kf=int(data[p + "cur_kf"]),
        odom={int(s): (int(q), T) for s, q, T in zip(
            data[p + "odom_seq"], data[p + "odom_prev"], data[p + "odom_T"])},
        consistency={int(k): int(v) for k, v in data[p + "in__consistency"]},
        last_fire_seq=int(data[p + "in__last_fire_seq"]),
        accepted_loops=[(int(a), int(b), T) for (a, b), T in zip(
            data[p + "in__loops_seq"], data[p + "in__loops_T"])])


# Bounds of the port's loop correction and global BA against the JAX
# outputs in the loop fixture (tests/test_torch_loop_closing.py). On the CPU
# the correction agrees within 1e-6 and the global BA within 6.3e-4 on poses
# and 8.6e-3 on one point (4 x 30 float32 CG iterations over the whole map,
# summed in another order); the headroom is for the card's summation order.
LOOP_CORR_TOL = {"kf_pose": 1e-3, "pt_pos": 2e-3, "pl_coef": 2e-3,
                 "ln_ep": 2e-3}
LOOP_GBA_TOL = {"kf_pose": 5e-3, "pt_pos": 5e-2, "pl_coef": 5e-3,
                "ln_ep": 1e-2}


def loop_gaps(data: dict, call: dict, lc, st: MapState, new: MapState,
              fired: bool) -> tuple[dict, list]:
    """A firing `LoopCloser.process` against the JAX run's: the flag, the
    accepted loop (sequences exact, T_rel within 1e-3), the surviving
    points and observation table exact, the corrected map within
    LOOP_CORR_TOL. -> (gaps, failed checks)."""
    fails = []
    loops = [(a, b) for a, b, _ in lc._accepted_loops]
    want = [tuple(int(v) for v in x) for x in data["fire__after__loops_seq"]]
    gaps = {f: float(np.abs(to_numpy(getattr(new, f))
                            - data[f"fire__out__{f}"]).max())
            for f in LOOP_CORR_TOL}
    gaps["fused"] = int(st.pt_valid.sum()) - int(new.pt_valid.sum())
    gaps["loops"] = loops
    if not fired:
        return gaps, ["the loop did not close"]
    gaps["T_rel"] = float(np.abs(lc._accepted_loops[-1][2]
                                 - data["fire__after__loops_T"][-1]).max())
    if loops != want:
        fails.append(f"accepted loops {loops}, JAX {want}")
    if gaps["T_rel"] > 1e-3:
        fails.append(f"|dT_rel| {gaps['T_rel']:.2e} > 1e-3")
    for f in ("pt_valid", "kf_mp"):
        if not np.array_equal(to_numpy(getattr(new, f)),
                              data[f"fire__out__{f}"]):
            fails.append(f"{f} differs from the JAX correction's")
    for f, tol in LOOP_CORR_TOL.items():
        if gaps[f] > tol:
            fails.append(f"{f} off by {gaps[f]:.2e} > {tol}")
    return gaps, fails


def loop_closer(cls, cfg, call: dict, **kw):
    """A `cls` (either package's LoopCloser) set up as the System's was
    before `call`."""
    lc = cls(cfg, consistency_needed=cfg.tracking.loop_consistency, **kw)
    lc._consistency = dict(call["consistency"])
    lc._last_fire_seq = call["last_fire_seq"]
    lc._accepted_loops = list(call["accepted_loops"])
    return lc


def save_fixture_map(data: dict, path: str, prefix: str = "map__") -> None:
    """Write the fixture's map (the "<prefix><field>" arrays) as a map file
    that either package's `load_map` reads."""
    np.savez_compressed(path, **{k[len(prefix):]: v for k, v in data.items()
                                 if k.startswith(prefix)})


def map_fingerprint(st: MapState) -> dict:
    """Sums over the fields tracking could change (tests/
    test_localization_mode.py's fingerprint): equal before and after
    means the map stayed frozen."""
    return {"n_kfs": int(st.n_kfs), "pt_valid": int(st.pt_valid.sum()),
            "pt_pos": float(st.pt_pos.double().sum()),
            "pt_found": int(st.pt_found.sum()),
            "pt_visible": int(st.pt_visible.sum()),
            "kf_pose": float(st.kf_pose.double().sum()),
            "pl_valid": int(st.pl_valid.sum())}


class SystemRun(NamedTuple):
    results: list        # TrackingResult per frame
    system: object       # the System, flushed
    ref_kf: list         # the tracker's reference keyframe after each frame
    launches: list       # matcher launches per frame
    ms: list             # wall ms per frame (synchronised per frame)
    reloc: list          # per frame: _relocalize ran (bool)
    fingerprints: tuple  # the map's fingerprint after load and at the end
    matcher_calls: list  # [(frame, wide: no scale gate, args)] in reloc


def run_system(data: dict, run: str, cfg, device, map_path: str,
               capture: bool = False) -> SystemRun:
    """Scenario `run` ("a" or "b") of the reloc fixture through the port's
    `System`: a fresh System loads the fixture's map from `map_path`
    (written by `save_fixture_map`) and takes the run's frames as the JAX
    System did (gray as float32, depth as d16 / depth_factor in float32, a
    black frame for -1), synchronised after each frame. Run "a" is
    localization mode with loop closing off, run "b" has loop closing on.
    With `capture`, the matcher's inputs inside relocalization are kept."""
    from dr_slam_torch.ops.match_cuda import gated_top2_hamming
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.system import System

    dev = torch.device(device)
    sysm = System(cfg, enable_loop_closing=run == "b", device=dev)
    sysm.load_map(map_path)
    if run == "a":
        sysm.activate_localization_mode()
    tr = sysm.tracker
    fp0 = map_fingerprint(tr.map_state)
    now = {"frame": None, "reloc": False, "inside": False}
    calls = []
    kernel, reloc = map_ops.gated_top2_hamming, tr._relocalize

    def watched_reloc(feats, ts):
        now["reloc"] = now["inside"] = True
        try:
            return reloc(feats, ts)
        finally:
            now["inside"] = False

    def watched_kernel(*a):
        if capture and now["inside"]:
            calls.append((now["frame"], not bool(a[8].any()),
                          tuple(x.clone() for x in a)))
        return kernel(*a)

    tr._relocalize = watched_reloc
    map_ops.gated_top2_hamming = watched_kernel
    results, ref_kf, launches, ms, relocs = [], [], [], [], []
    order = [int(i) for i in data[f"{run}__frame"]]
    first = int(data["first_frame"])
    try:
        for n, frame in enumerate(order):
            if frame < 0:
                g = np.zeros_like(data["gray"][0])
                d = np.zeros_like(data["depth"][0])
                ts = (order[n - 1] + 0.5) / 30.0
            else:
                g = data["gray"][frame - first]
                d = data["depth"][frame - first]
                ts = frame / 30.0
            gray = g.astype(np.float32)
            depth = (d / cfg.camera.depth_factor).astype(np.float32)
            now.update(frame=frame, reloc=False)
            before = gated_top2_hamming.launches
            t0 = time.perf_counter()
            results.append(sysm.track_rgbd(gray, depth, ts))
            sysm.block_until_ready()
            ms.append((time.perf_counter() - t0) * 1e3)
            relocs.append(now["reloc"])
            launches.append(gated_top2_hamming.launches - before)
            ref_kf.append(tr.ref_kf)
        tr.flush()
        sysm.block_until_ready()
    finally:
        map_ops.gated_top2_hamming = kernel
        tr._relocalize = reloc
    fp1 = map_fingerprint(tr.map_state)
    return SystemRun(results, sysm, ref_kf, launches, ms, relocs, (fp0, fp1),
                     calls)


def system_gaps(run: SystemRun, data: dict, prefix: str) -> tuple[dict, list]:
    """A System run's distances from the JAX outputs of the same scenario
    (`prefix` "a" or "b"), and the failed checks: states and reference
    keyframes exact, T_cw within TRACKER_T_TOL, counts within
    TRACKER_COUNT_TOL, the keyframe count exact; in scenario "a" the map
    unchanged."""
    res = run.results
    st = run.system.tracker.map_state
    dT = [float(np.abs(to_numpy(r.T_cw) - data[f"{prefix}__T_cw"][i]).max())
          for i, r in enumerate(res)]
    gaps = dict(max_dT=max(dT), n_kfs=int(st.n_kfs), n_pts=int(st.n_pts),
                n_planes=int(st.pl_valid.sum()),
                n_lines=int(st.ln_valid.sum()),
                reloc_frames=[int(data[f"{prefix}__frame"][i])
                              for i, r in enumerate(run.reloc) if r])
    fails = []
    states = [r.state.value for r in res]
    if states != data[f"{prefix}__state"].tolist():
        fails.append(f"states {states}, JAX {data[f'{prefix}__state'].tolist()}")
    if run.ref_kf != data[f"{prefix}__ref_kf"].tolist():
        fails.append(f"ref_kf {run.ref_kf}, JAX "
                     f"{data[f'{prefix}__ref_kf'].tolist()}")
    if gaps["max_dT"] > TRACKER_T_TOL:
        fails.append(f"|dT_cw| {gaps['max_dT']:.2e} > {TRACKER_T_TOL}")
    for i, r in enumerate(res):
        for name, got in (("n_inliers", r.n_inliers), ("n_matches", r.n_matches)):
            ref = int(data[f"{prefix}__{name}"][i])
            if abs(got - ref) > TRACKER_COUNT_TOL * max(ref, 1):
                fails.append(f"frame {i}: {name} {got}, JAX {ref}")
    if gaps["n_kfs"] != int(data[f"{prefix}__n_kfs"]):
        fails.append(f"n_kfs {gaps['n_kfs']}, JAX "
                     f"{int(data[f'{prefix}__n_kfs'])}")
    ref = int(data[f"{prefix}__n_pts"])
    if abs(gaps["n_pts"] - ref) > TRACKER_COUNT_TOL * ref:
        fails.append(f"n_pts {gaps['n_pts']}, JAX {ref}")
    if prefix == "a" and run.fingerprints[0] != run.fingerprints[1]:
        fails.append("localization mode changed the map")
    return gaps, fails


# --- the device-resident loop ------------------------------------------------

DEVICE_LOOP_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "data", "device_loop_corridor.npz")


class DeviceLoopRun(NamedTuple):
    flushed: dict        # DeviceLoopTracker.flush()
    tracker: object      # the DeviceLoopTracker
    launches: list       # matcher launches per frame
    ms: list             # wall ms per frame (the step reads back its flags)
    keyframes: list      # per insertion [(stage, device ms)]; cuda only
    verify_calls: list   # the matcher's inputs inside _reloc_attempt


def device_loop_frames(mdata: dict, order) -> list:
    """The mapping fixture's frames in `order` (-1: a black frame), as the
    camera gives them: [(gray uint8, depth uint16)]."""
    black = (np.zeros_like(mdata["gray"][0]), np.zeros_like(mdata["depth"][0]))
    return [(mdata["gray"][i], mdata["depth"][i]) if i >= 0 else black
            for i in order]


def run_device_loop(mdata: dict, order, cfg, device,
                    capture: bool = False) -> DeviceLoopRun:
    """The port's DeviceLoopTracker from an empty map over the mapping
    fixture's frames in `order`, frame n at timestamp n / 30. On the GPU
    each keyframe stage is timed with a pair of CUDA events. With
    `capture`, the matcher's inputs inside `_reloc_attempt` are kept."""
    from dr_slam_torch.ops.match_cuda import gated_top2_hamming
    from dr_slam_torch.slam import device_loop, map_ops

    dev = torch.device(device)
    cuda = dev.type == "cuda"
    tr = device_loop.DeviceLoopTracker(cfg, device=dev)
    if cuda:
        tr.stage_events = []
    kernel, reloc = map_ops.gated_top2_hamming, device_loop._reloc_attempt
    inside, calls = [False], []

    def watched_reloc(*a):
        inside[0] = True
        try:
            return reloc(*a)
        finally:
            inside[0] = False

    def watched_kernel(*a):
        if capture and inside[0]:
            calls.append(tuple(x.clone() for x in a))
        return kernel(*a)

    device_loop._reloc_attempt = watched_reloc
    map_ops.gated_top2_hamming = watched_kernel
    launches, ms = [], []
    try:
        for n, (g, d) in enumerate(device_loop_frames(mdata, order)):
            before = gated_top2_hamming.launches
            t0 = time.perf_counter()
            tr.track(g, d, n / 30.0)
            if cuda:
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            launches.append(gated_top2_hamming.launches - before)
    finally:
        map_ops.gated_top2_hamming = kernel
        device_loop._reloc_attempt = reloc
    keyframes = []
    if cuda:
        torch.cuda.synchronize()
        for name, a, b in tr.stage_events:
            if name == "kf.add":
                keyframes.append([])
            keyframes[-1].append((name, a.elapsed_time(b)))
    return DeviceLoopRun(tr.flush(), tr, launches, ms, keyframes, calls)


def expected_launches(states: list, relocs: list) -> list:
    """The matcher launches each device-loop frame must make: none while
    the map is uninitialized (the init branch), two per tracked frame
    (`track_step`), one more per relocalization attempt (the verify)."""
    out, inited = [], False
    for state, reloc in zip(states, relocs):
        out.append(2 + int(reloc) if inited else 0)
        inited = inited or state != "NOT_INITIALIZED"
    return out


# Records compared exactly: state, keyframe flag, reference keyframe slot
# and its insertion sequence.
DEVICE_LOOP_EXACT = {16: "state", 19: "is_kf", 20: "ref_kf", 21: "ref_seq"}


def device_loop_gaps(run: DeviceLoopRun, data: dict) -> tuple[dict, list]:
    """A DeviceLoopTracker run's distances from the JAX run of the
    device-loop fixture, and the failed checks: the exact record fields,
    T_cw within TRACKER_T_TOL, counts within TRACKER_COUNT_TOL, the
    keyframe count exact and the point count within TRACKER_COUNT_TOL."""
    got, want = run.flushed["records"], data["records"]
    st = run.tracker.map_state
    gaps = dict(max_dT=float(np.abs(got[:, :16] - want[:, :16]).max()),
                d_inliers=int(np.abs(got[:, 17] - want[:, 17]).max()),
                d_matches=int(np.abs(got[:, 18] - want[:, 18]).max()),
                n_keyframes=run.flushed["n_keyframes"], n_pts=int(st.n_pts),
                n_planes=int(st.pl_valid.sum()),
                n_lines=int(st.ln_valid.sum()))
    fails = []
    if got.shape != want.shape:
        return gaps, [f"records {got.shape}, JAX {want.shape}"]
    for k, name in DEVICE_LOOP_EXACT.items():
        if not np.array_equal(got[:, k], want[:, k]):
            fails.append(f"{name} {got[:, k].astype(int).tolist()}, JAX "
                         f"{want[:, k].astype(int).tolist()}")
    if gaps["max_dT"] > TRACKER_T_TOL:
        fails.append(f"|dT_cw| {gaps['max_dT']:.2e} > {TRACKER_T_TOL}")
    for k, name in ((17, "n_inliers"), (18, "n_matches")):
        bad = np.abs(got[:, k] - want[:, k]) > TRACKER_COUNT_TOL * np.maximum(
            want[:, k], 1)
        fails += [f"frame {n}: {name} {int(got[n, k])}, JAX {int(want[n, k])}"
                  for n in np.where(bad)[0]]
    if gaps["n_keyframes"] != int(data["n_keyframes"]):
        fails.append(f"n_keyframes {gaps['n_keyframes']}, JAX "
                     f"{int(data['n_keyframes'])}")
    ref = int(data["n_pts"])
    if abs(gaps["n_pts"] - ref) > TRACKER_COUNT_TOL * ref:
        fails.append(f"n_pts {gaps['n_pts']}, JAX {ref}")
    return gaps, fails


# --- the dataset runner and the streaming node --------------------------------

TUM_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "tum_corridor.npz")
TUM_T0 = 1000.0       # export_tum_sequence's first timestamp; 30 frames/s
NODE_FRAMES = 12      # frames 0-11 go through the streaming node


def export_fixture_sequence(export, out_dir: str, mdata: dict, poses,
                            depth_factor: float) -> str:
    """The mapping fixture's frames as a TUM sequence, written by `export`
    (either package's `export_tum_sequence`): gray as float32, depth as
    d16 / depth_factor in float32, so the PNGs hold the fixture's uint8 and
    uint16 values exactly."""
    def render(i):
        return (mdata["gray"][i].astype(np.float32),
                mdata["depth"][i].astype(np.float32) / np.float32(depth_factor))
    return export(out_dir, poses, render, depth_factor=depth_factor)


@contextlib.contextmanager
def track_rgbd_hook(hook):
    """Patch the port's `System.track_rgbd` for the block: after each frame
    it calls `hook(result, system)`. Drives the dataset runner and the
    streaming node unchanged, as the tests' `jax_system_lagged_by_one`
    drives the JAX ones."""
    from dr_slam_torch.slam.system import System

    track = System.track_rgbd

    def wrapped(self, *a, **kw):
        res = track(self, *a, **kw)
        hook(res, self)
        return res
    System.track_rgbd = wrapped
    try:
        yield
    finally:
        System.track_rgbd = track


def node_frames(mdata: dict, depth_factor: float, n: int = NODE_FRAMES):
    """[(stamp, rgb (H, W, 3) uint8, depth float32 metres)] of fixture frames
    0..n-1, as a ROS camera driver publishes them."""
    return [(TUM_T0 + i / 30.0,
             np.repeat(mdata["gray"][i][..., None], 3, axis=-1),
             mdata["depth"][i].astype(np.float32) / np.float32(depth_factor))
            for i in range(n)]


def node_session(tp, server, frames, map_path: str | None = None,
                 resolution: float = 0.05) -> dict:
    """One camera session against `server` (a SlamServer of either package;
    `tp` is that package's or the other's transport module, whose
    CameraClient speaks the same wire format): `server.serve_once()` on a
    thread of its own, the frames streamed one round trip each, then
    save_map (if `map_path`), save_occupancy and shutdown. -> dict of the
    odometry per frame, round-trip ms, the save_map status, the occupancy
    reply (keyframe odometry, grid, status) and the frames the server
    tracked. A failure on the server's thread is raised here."""
    done = {}

    def serve():
        try:
            done["n"] = server.serve_once()
        except BaseException as e:           # noqa: BLE001 (re-raised below)
            done["error"] = e

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    client = tp.CameraClient(server.address)

    def recv():
        msg = client.recv()
        if msg is None:
            th.join(timeout=60)
            raise RuntimeError(f"the node closed the session: "
                               f"{done.get('error')!r}") from done.get("error")
        return msg

    out = dict(odom=[], ms=[], saved=None, kf_odom=[], grid=None,
               occ_status=None)
    try:
        for stamp, rgb, depth in frames:
            t0 = time.perf_counter()
            client.publish_frame(stamp, rgb, depth)
            topic, _, data = recv()
            out["ms"].append((time.perf_counter() - t0) * 1e3)
            if topic != tp.TOPIC_ODOM:
                raise RuntimeError(f"expected odometry, got {topic}: {data}")
            out["odom"].append(data)
        if map_path:
            client.command(cmd="save_map", path=map_path)
            out["saved"] = recv()[2]
        client.command(cmd="save_occupancy", resolution=resolution)
        while True:
            topic, _, data = recv()
            if topic == tp.TOPIC_ODOM:
                out["kf_odom"].append(data)
            elif topic == tp.TOPIC_OCC:
                out["grid"] = data
            elif topic == tp.TOPIC_STATUS:
                out["occ_status"] = data
                break
        client.command(cmd="shutdown")
        recv()
    finally:
        client.close()
    th.join(timeout=60)
    if "error" in done:
        raise RuntimeError("the node failed") from done["error"]
    out["n_tracked"] = done.get("n")
    return out


def odom_arrays(odom: list) -> dict:
    """A node session's per-frame odometry as arrays: state codes
    (1 NOT_INITIALIZED, 2 OK, 3 LOST), keyframe flags, positions and
    quaternions."""
    codes = {"NOT_INITIALIZED": 1, "OK": 2, "LOST": 3}
    return dict(state=np.asarray([codes[o["state"]] for o in odom], np.int32),
                is_keyframe=np.asarray([o["is_keyframe"] for o in odom]),
                position=np.asarray([o["position"] for o in odom]),
                orientation=np.asarray([o["orientation"] for o in odom]))


def load_tum_fixture() -> dict:
    """The TUM fixture (made by scripts/make_torch_tum_fixture.py): the
    ground-truth poses of the mapping fixture's 24 frames and the JAX
    package's dataset runner, node session and mesh over them."""
    return load_npz(TUM_FIXTURE)


def read_tum_rows(path: str) -> np.ndarray:
    """A TUM trajectory file's rows as an (N, 8) float64 array."""
    with open(path) as f:
        rows = [[float(v) for v in line.split()] for line in f
                if line.strip() and not line.startswith("#")]
    return np.asarray(rows, np.float64).reshape(-1, 8)


# Bound of the node's occupancy grid against the JAX node's: the cells
# whose count differs, over the cells the JAX grid occupies. The points are
# placed by poses within TRACKER_T_TOL, so a point near a 5 cm cell border
# may change cells: on the CPU at 640x480, 10 of 299 cells (3.3%), with
# |dT_cw| 1.0e-3 on the runner and the same point count.
OCC_CELL_SHARE = 0.1


def node_gaps(out: dict, data: dict) -> tuple[dict, list]:
    """A node session against the JAX node's in the TUM fixture: states and
    keyframe flags exact, positions within TRACKER_T_TOL, quaternions
    within 2 * TRACKER_T_TOL (q and -q are one rotation: the sign is
    aligned with JAX's), every frame
    tracked, the occupancy reply's keyframe count exact and its grid within
    OCC_CELL_SHARE. -> (gaps, failed checks)."""
    got = odom_arrays(out["odom"])
    fails = []
    if got["state"].shape != data["node__state"].shape:
        return {}, [f"{len(out['odom'])} odometry replies, JAX "
                    f"{len(data['node__state'])}"]
    q, qj = got["orientation"], data["node__orientation"]
    q = q * np.where(np.sum(q * qj, -1, keepdims=True) < 0, -1.0, 1.0)
    grid, gj = out["grid"], data["occ__grid"]
    diff = int((grid != gj).sum()) if grid is not None and \
        grid.shape == gj.shape else -1
    occupied = max(int((gj > 0).sum()), 1)
    gaps = dict(
        d_position=float(np.abs(got["position"]
                                - data["node__position"]).max()),
        d_orientation=float(np.abs(q - qj).max()),
        kf_odom=len(out["kf_odom"]),
        occ_cells_differing=diff, occ_cells_jax=occupied,
        occ_sum=int(grid.sum()) if grid is not None else None,
        occ_sum_jax=int(gj.sum()),
        d_origin=float(np.abs(np.asarray(out["occ_status"]["origin"])
                              - data["occ__origin"]).max()))
    for name in ("state", "is_keyframe"):
        if not np.array_equal(got[name], data[f"node__{name}"]):
            fails.append(f"{name} {got[name].tolist()}, JAX "
                         f"{data[f'node__{name}'].tolist()}")
    if gaps["d_position"] > TRACKER_T_TOL:
        fails.append(f"positions off by {gaps['d_position']:.2e}")
    if gaps["d_orientation"] > 2 * TRACKER_T_TOL:
        fails.append(f"orientations off by {gaps['d_orientation']:.2e}")
    if out["n_tracked"] != len(out["odom"]):
        fails.append(f"the node tracked {out['n_tracked']} frames")
    if gaps["kf_odom"] != int(data["occ__keyframes"]) or \
            out["occ_status"]["keyframes"] != gaps["kf_odom"]:
        fails.append(f"occupancy over {gaps['kf_odom']} keyframes, JAX "
                     f"{int(data['occ__keyframes'])}")
    if diff < 0 or diff > OCC_CELL_SHARE * occupied:
        fails.append(f"occupancy grid: {diff} of {occupied} cells differ")
    return gaps, fails


# --- the detector, the cylinders and the viewers (phase 10) ------------------

DETECT_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "detect_corridor.npz")
SYNTH_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "yolox_synth.npz")
# Bound of the port's decoded candidates against the JAX ones: |d| <=
# CAND_TOL * max(|jax|, 1) in x1, y1, x2, y2 and score, the class equal
# wherever the JAX best class leads the second by CAND_TOL or more.
# Observed on the CPU at 640 with the random YOLOX-s: 3.5e-7 (float32
# convolutions summed in another order); a detection's box and score are
# held to the same bound.
CAND_TOL = 1e-4
# Bound of the cylinders' radius, centre and unit axis against the JAX ones
# (valid slots). The cells' normals come from a closed-form float32
# eigensolver that is ill-conditioned on cells whose two small eigenvalues
# are close; on the CPU the golden cells agree to 7e-7 and a depth render
# at 320x240 to 3.5e-3.
CYL_TOL = 1e-2


def load_detect_fixture() -> dict:
    """The detect fixture (made by scripts/make_torch_detect_fixture.py):
    the JAX System with YOLOX-s over the mapping fixture's frames, the
    trained weights over six synthetic scenes, and a cylinder depth map."""
    return load_npz(DETECT_FIXTURE)


def box_iou(a, b) -> float:
    x1, y1 = max(a[0], b[0]), max(a[1], b[1])
    x2, y2 = min(a[2], b[2]), min(a[3], b[3])
    inter = max(x2 - x1, 0) * max(y2 - y1, 0)
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) \
        - inter
    return inter / max(union, 1e-6)


def candidate_gaps(cand: np.ndarray, want: np.ndarray, margin: np.ndarray
                   ) -> tuple[dict, list]:
    """Decoded candidates (M, 6) against the JAX ones under CAND_TOL."""
    rel = np.abs(cand[:, :5] - want[:, :5]) / np.maximum(np.abs(want[:, :5]),
                                                         1.0)
    flipped = cand[:, 5] != want[:, 5]
    gaps = dict(max_rel=float(rel.max()), class_flips=int(flipped.sum()),
                class_flips_near_tie=int((flipped & (margin < CAND_TOL)).sum()))
    fails = []
    if cand.shape != want.shape:
        return gaps, [f"candidates {cand.shape}, JAX {want.shape}"]
    if gaps["max_rel"] > CAND_TOL:
        fails.append(f"candidates off by {gaps['max_rel']:.2e} (relative)")
    if gaps["class_flips"] != gaps["class_flips_near_tie"]:
        fails.append(f"{gaps['class_flips'] - gaps['class_flips_near_tie']} "
                     "candidates changed class away from a near-tie")
    return gaps, fails


def detection_gaps(det: dict, want: dict) -> tuple[dict, list]:
    """Valid detections against the JAX ones: the same count; each JAX
    detection matched by a port detection of its class with box and score
    within CAND_TOL (relative to max(|x|, 1)); a detection may change its
    place only with one whose JAX score is within CAND_TOL of its own."""
    n, nj = int(det["valid"].sum()), int(want["valid"].sum())
    fails = [] if n == nj else [f"{n} valid detections, JAX {nj}"]
    worst, free = 0.0, list(range(n))
    for i in range(min(n, nj)):
        gap = [max(np.abs(det["boxes"][j] - want["boxes"][i]).max()
                   / max(np.abs(want["boxes"][i]).max(), 1.0),
                   abs(det["scores"][j] - want["scores"][i]))
               if det["classes"][j] == want["classes"][i] else np.inf
               for j in free]
        k = int(np.argmin(gap))
        j = free.pop(k)
        worst = max(worst, float(gap[k]))
        if gap[k] > CAND_TOL:
            fails.append(f"JAX detection {i} has no match within {CAND_TOL}")
        elif j != i and abs(want["scores"][min(j, nj - 1)]
                            - want["scores"][i]) > CAND_TOL:
            fails.append(f"JAX detection {i} moved to place {j}")
    return dict(valid=n, valid_jax=nj, max_gap=worst), fails


def detections_numpy(d) -> dict:
    return {k: to_numpy(getattr(d, k))
            for k in ("boxes", "scores", "classes", "valid")}


def synth_gate(preds: list, gt: np.ndarray, n_gt: np.ndarray) -> dict:
    """tests/test_yolox_detect.py's gate over a few scenes: every
    ground-truth box found at IoU > 0.4 in at least 80% of cases, at most 2
    extra boxes per image. preds: per image the (k, 4) valid boxes."""
    hits = total = extras = 0
    for pred, boxes, n in zip(preds, gt, n_gt):
        total += int(n)
        hits += sum(any(box_iou(g, p) > 0.4 for p in pred) for g in boxes[:n])
        extras += max(len(pred) - int(n), 0)
    return dict(hits=hits, total=total, extras=extras,
                ok=hits / total >= 0.8 and extras <= 2 * len(preds))


CYL_FIELDS = ("axis", "center", "radius", "mse", "n_cells", "valid",
              "cell_mask")


def cylinder_gaps(seg, data: dict, prefix: str) -> tuple[dict, list]:
    """A CylinderSegmentation against the JAX one: valid and cell_mask
    exact, and the valid slots' n_cells exact with their radius, centre and
    axis within CYL_TOL. A slot that fails its gates reports the count of a
    rejected hypothesis over the cells left (in a depth render, mostly the
    ill-conditioned silhouette cells), which the order of float32 sums
    moves: the port's CPU run counts 60 or 56 there with 4 or 2 threads,
    so those counts are printed, not held."""
    got = {k: to_numpy(getattr(seg, k)) for k in CYL_FIELDS}
    want = {k: data[f"{prefix}__{k}"] for k in CYL_FIELDS}
    if not np.array_equal(got["valid"], want["valid"]):
        return {"valid": got["valid"].tolist()}, [
            f"valid {got['valid'].tolist()}, JAX {want['valid'].tolist()}"]
    ok = want["valid"]
    gaps = {k: float(np.abs(got[k][ok] - want[k][ok]).max()) if ok.any()
            else 0.0 for k in ("axis", "center", "radius")}
    gaps.update(valid=got["valid"].tolist(), n_cells=got["n_cells"].tolist(),
                cells=int(got["cell_mask"].sum()))
    fails = [f"{k} differs from JAX's" for k, a, b in (
        ("cell_mask", got["cell_mask"], want["cell_mask"]),
        ("valid slots' n_cells", got["n_cells"][ok], want["n_cells"][ok]))
        if not np.array_equal(a, b)]
    fails += [f"{k} off by {gaps[k]:.2e}" for k in ("axis", "center",
                                                     "radius")
              if gaps[k] > CYL_TOL]
    return gaps, fails


def yolox_macs(meta: dict, size: int) -> int:
    """Multiply-adds of one YOLOXNet forward at size x size, from the
    convolutions' shapes (each output pixel of a c_in -> c_out k x k
    convolution costs c_in * c_out * k * k)."""
    from dr_slam_torch.models.yolox import _layout

    stride = {"stem": 2, "down1": 4, "csp1": 4, "down2": 8, "csp2": 8,
              "down3": 16, "csp3": 16, "down4": 32, "spp": 32, "csp4": 32,
              "lat2": 32, "fpn2": 16, "lat1": 16, "fpn1": 8, "pan1": 16,
              "pan1c": 16, "pan2": 32, "pan2c": 32, "head0": 8, "head1": 16,
              "head2": 32}
    return sum((size // stride[name.split(".")[0]]) ** 2 * c_in * c_out * k * k
               for name, c_in, c_out, k in _layout(meta["widths"],
                                                   meta["depths"]))


SYNTH_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "synthetic_fixture.npz")
SYNTH_FRAME = 7          # the fixture scenes' frame (depth noise PRNGKey(7))
SYNTH_RUN_FRAMES = 24    # scripts/run_synthetic_torch.py --frames
TRAIN_STEPS = 20         # scripts/train_yolox_torch.py --steps
TRAIN_BATCH = 8
MAP_KFS = 240            # synthetic_map_state's keyframes (seed 3)


def synthetic_scenes(synthetic) -> list:
    """The fixture's two rendered scenes, built with either package's
    `io/synthetic` module (their numpy trajectories and clutter are the
    same): [(name, room, poses (40, 4, 4), boxes)], each rendered at frame
    SYNTH_FRAME with Kinect-like (quadratic) depth noise. The default room
    among office clutter on the loop, and scripts/train_vocab.py's
    small-room family."""
    small = synthetic.BoxRoom(xmax=2.6, ymax=2.2, zmax=3.4)
    return [
        ("clutter", synthetic.BoxRoom(), synthetic.loop_trajectory(40),
         synthetic.office_clutter(n_boxes=6, seed=3)),
        ("small_room", small,
         synthetic.corridor_trajectory(40, room=small, step=0.012),
         synthetic.office_clutter(small, n_boxes=4, seed=11)),
    ]


def quantize(gray, depth, depth_factor: float):
    """The fixtures' camera-native frames: uint8 gray, uint16 depth units
    (the JAX fixture scripts' expressions). Tensors -> numpy arrays."""
    g8 = torch.clamp(gray + 0.5, 0, 255).to(torch.uint8)
    d16 = torch.clamp(depth * depth_factor + 0.5, 0, 65535).to(torch.int32)
    return g8.cpu().numpy(), d16.cpu().numpy().astype(np.uint16)


def map_state_cfg(config):
    """tests/test_backend.py's realistic-capacity configuration (320x240,
    512 keypoint slots, 16384 points, 256 keyframes, 64 words), built from
    either package's `config` module."""
    return config.SlamConfig(
        camera=config.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                                   width=320, height=240, bf=20.0),
        orb=config.ORBConfig(n_features=400, n_levels=4, max_keypoints=512),
        line=config.LineConfig(max_lines=8),
        map=config.MapConfig(max_points=16384, max_lines=16, max_planes=8,
                             max_keyframes=256, vocab_words=64))


def state_checksums(fields: dict) -> dict:
    """name -> numpy array of a MapState's fields -> name -> checksum: for
    integer and bool tables the sum and an index-weighted sum (int64,
    exact), for float tables the float64 sum and sum of magnitudes."""
    out = {}
    for name, a in fields.items():
        a = np.asarray(a).reshape(-1)
        if a.dtype.kind in "biu":
            v = a.astype(np.int64)
            w = np.arange(v.size, dtype=np.int64) % 9973 + 1
            out[name] = np.asarray([v.sum(), (v * w).sum()], np.int64)
        else:
            v = a.astype(np.float64)
            out[name] = np.asarray([v.sum(), np.abs(v).sum()])
    return out


def load_synth_fixture() -> dict:
    return load_npz(SYNTH_FIXTURE)


# --- the closed-loop accuracy protocol (scripts/bench_accuracy.py) ---------

ACCURACY_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "data", "accuracy_loop.npz")
ACCURACY_LOOP_FRAMES = 200   # the circular path; then its first 70 again
ACCURACY_REVISIT = 70
ACCURACY_DRIFT_FRAME = 120   # drift is injected right after this frame
ACCURACY_VOCAB_FRAMES = tuple(range(0, ACCURACY_LOOP_FRAMES, 13))
ACCURACY_CHECK_FRAMES = (60, 121)   # the matcher held on these frames
# Bounds of phase 12 against the JAX run in the fixture, which tracks with
# the port's pose rule (each tracked rotation projected onto SO(3); see
# scripts/make_torch_accuracy_fixture.py). Exact over every frame: the
# states, keyframe flags and reference keyframes, the keyframes' frames,
# the LOST frames, and the loops closed (frame, keyframe slot, keyframe
# pair; at least one). The reference test's bound of at most
# ACCURACY_LOST_MAX frames LOST (tests/test_loop_closure.py:75-78) is
# printed beside them: the JAX run under the same pose rule loses four
# frames in the gauge seam, so the port is held to JAX's frames instead.
# The corrected ATE under ACCURACY_ATE_MAX, under the raw ATE by at least
# ACCURACY_ATE_GAIN (tests/test_loop_closure.py:87-112), and within
# ACCURACY_ATE_REL x JAX's + ACCURACY_ATE_ABS (phase 11's rule for ATE).
# T_cw is printed against TRACKER_T_TOL, not bounded: the card renders the
# frames itself, and its renders differ from JAX's in the last bits of the
# gray (tests/test_torch_accuracy.py holds T_cw on JAX's renders).
ACCURACY_LOST_MAX = 3
ACCURACY_ATE_MAX = 0.25
ACCURACY_ATE_GAIN = 0.02
ACCURACY_ATE_REL = 2.0
ACCURACY_ATE_ABS = 0.005


def accuracy_cfg():
    """scripts/bench_accuracy.py's configuration: the loop scenario's."""
    return loop_small_cfg()


def accuracy_poses() -> np.ndarray:
    """The protocol's 270 poses: the circular path, then its start again."""
    from dr_slam_torch.io.synthetic import loop_trajectory

    poses = loop_trajectory(ACCURACY_LOOP_FRAMES)
    return np.concatenate([poses, poses[:ACCURACY_REVISIT]], 0)


def accuracy_sequence(device=None):
    """The protocol's sequence, rendered at 320x240 on `device`."""
    from dr_slam_torch.io.synthetic import SyntheticSequence

    cam = accuracy_cfg().camera
    return SyntheticSequence(accuracy_poses(), K4=cam.K4, height=cam.height,
                             width=cam.width, device=device)


def train_accuracy_vocabulary(seq, cfg) -> np.ndarray:
    """The codebook the protocol trains on its own frames (ACCURACY_VOCAB_
    FRAMES, 6 k-means iterations): (W, 8) uint32 packed words."""
    from dr_slam_torch.associate.vocabulary import train_vocabulary
    from dr_slam_torch.frontend.frame import extract_frame

    descs = []
    for i in ACCURACY_VOCAB_FRAMES:
        gray, depth = seq.render(i)
        f = extract_frame(gray, depth, cfg, seq.device)
        descs.append(to_numpy(f.kp.desc)[to_numpy(f.kp.valid)])
    return train_vocabulary(np.concatenate(descs, 0),
                            n_words=cfg.map.vocab_words, n_iters=6)


def loop_events(records: list) -> list:
    """(frame, current keyframe slot) of each `loop_closed` event of a
    metrics log; the frame is counted from the "frame" events before it."""
    out, frame = [], -1
    for rec in records:
        if rec["event"] == "frame":
            frame += 1
        elif rec["event"] == "loop_closed":
            out.append((frame, int(rec["kf"])))
    return out


def accuracy_summary(poses, traj_raw, traj_corrected, loops: int) -> dict:
    """scripts/bench_accuracy.py's numbers, unrounded: the ATE of the
    corrected and of the raw camera centres against the poses' (Umeyama,
    fixed scale), the loops closed and the frames."""
    from dr_slam_torch.io.metrics import ate_rmse

    def centres(Ts):
        return np.asarray([np.linalg.inv(to_numpy(T).astype(np.float64))
                           [:3, 3] for T in Ts])

    gt = centres(poses)
    return {"ate_rmse_m": float(ate_rmse(centres(traj_corrected), gt)),
            "ate_rmse_raw_m": float(ate_rmse(centres(traj_raw), gt)),
            "loops_closed": int(loops), "frames": len(poses)}


def accuracy_gaps(run, data: dict) -> tuple[dict, list]:
    """Phase 12's comparison of an `accuracy_run` over all frames with the
    JAX run in the fixture. -> (numbers, failed checks)."""
    import json

    rec, summ = run.records, run.summary
    want = json.loads(str(data["summary"]))
    differ = {k: [int(i) for i in np.nonzero(rec[k] != data[k])[0]]
              for k in ("state", "is_keyframe", "ref_kf")}
    lost = [int(i) for i in np.nonzero(rec["state"] == 3)[0]]  # LOST
    jlost = [int(i) for i in np.nonzero(data["state"] == 3)[0]]
    jloops = [(int(f), int(k), tuple(int(x) for x in s)) for f, k, s in
              zip(data["loop_frame"], data["loop_kf"], data["loop_seq"])]
    jkf = [int(f) for f in data["kf_frames"]]
    dT = np.abs(rec["T_cw"] - data["T_cw"]).max(axis=(1, 2))
    ate_max = min(ACCURACY_ATE_MAX,
                  summ["ate_rmse_raw_m"] - ACCURACY_ATE_GAIN,
                  ACCURACY_ATE_REL * want["ate_rmse_m"] + ACCURACY_ATE_ABS)
    gaps = {"differ": differ, "lost": lost, "jax_lost": jlost,
            "loops": run.loops, "jax_loops": jloops, "jax_kf_frames": jkf,
            "ate_max": ate_max, "dT_max": float(dT.max()),
            "dT_over": [int(i) for i in np.nonzero(dT > TRACKER_T_TOL)[0]]}
    fails = [f"{k} differs from JAX's at frames {v}"
             for k, v in differ.items() if v]
    if run.kf_frames != jkf:
        fails.append(f"keyframes at frames {run.kf_frames}, JAX {jkf}")
    if lost != jlost:
        fails.append(f"LOST frames {lost}, JAX {jlost}")
    if not run.loops or run.loops != jloops \
            or summ["loops_closed"] != want["loops_closed"]:
        fails.append(f"loops {run.loops} ({summ['loops_closed']} closed), "
                     f"JAX {jloops}")
    if summ["ate_rmse_m"] >= ate_max:
        fails.append(f"corrected ATE {summ['ate_rmse_m']:.4f} >= "
                     f"{ate_max:.4f}")
    return gaps, fails


class AccuracyRun(NamedTuple):
    records: dict        # per frame (record=True): state, T_cw, ref_kf,
    #                      is_keyframe, n_inliers as arrays; else empty
    kf_frames: list      # the frame of each keyframe insertion
    loops: list          # per loop closed: (frame, keyframe slot,
    #                      (loop keyframe seq, current keyframe seq))
    summary: dict        # `accuracy_summary`
    trained_words: np.ndarray   # the codebook trained on the sequence
    codebook: str        # the codebook in effect: "trained" or "shipped"
    codebook_signs: np.ndarray  # its (W, 256) signs
    ms: list             # wall ms per frame (synchronised with record=True)
    mapped: list         # per frame: keyframes inserted during the call
    system: object       # the System, flushed


def accuracy_run(dev, frames: int | None = None,
                 record: bool = True) -> AccuracyRun:
    """scripts/bench_accuracy.py's protocol on the port, step by step: a
    codebook trained on the sequence and registered, `System(cfg,
    enable_loop_closing=True, metrics_path=...)` (which registers the
    shipped vocab512.npz over it, as the JAX `System` does), `track_rgbd`
    over the first `frames` frames (all 270 by default) with progressive
    drift injected right after ACCURACY_DRIFT_FRAME, `tracker.flush()`, the
    loops counted from the metrics file, and the raw and loop-corrected
    ATE. With `record`, each frame is synchronised (so the deferred
    decision lags by exactly one frame) and its result read back. The
    codebook registry is restored afterwards."""
    import json
    import tempfile

    from dr_slam_torch.associate import vocabulary as voc
    from dr_slam_torch.io.drift import inject_progressive_drift
    from dr_slam_torch.slam.system import System

    dev = torch.device(dev)
    cfg = accuracy_cfg()
    seq = accuracy_sequence(dev)
    n = len(seq) if frames is None else frames
    rec = {k: [] for k in ("state", "T_cw", "ref_kf", "is_keyframe",
                           "n_inliers")}
    ms, mapped = [], []
    with _restored_codebooks(), tempfile.TemporaryDirectory() as tmp:
        trained = train_accuracy_vocabulary(seq, cfg)
        voc.set_vocabulary(trained)
        mpath = os.path.join(tmp, "metrics.jsonl")
        sysm = System(cfg, enable_loop_closing=True, metrics_path=mpath,
                      device=dev)
        tr = sysm.tracker
        for i in range(n):
            gray, depth = seq.render(i)
            n_kf = len(tr.kf_log)
            t0 = time.perf_counter()
            res = sysm.track_rgbd(gray, depth, i / 30.0)
            if record:
                _sync(dev)
                rec["state"].append(res.state.value)
                rec["T_cw"].append(to_numpy(res.T_cw).astype(np.float32))
                rec["ref_kf"].append(tr.ref_kf)
                rec["is_keyframe"].append(bool(res.is_keyframe))
                rec["n_inliers"].append(int(res.n_inliers))
            ms.append((time.perf_counter() - t0) * 1e3)
            mapped.append(len(tr.kf_log) - n_kf)
            if i == ACCURACY_DRIFT_FRAME:
                inject_progressive_drift(tr)
        tr.flush()
        sysm.metrics.close()
        with open(mpath) as fh:
            events = [json.loads(line) for line in fh]
        signs = voc.get_codebook_signs(cfg.map.vocab_words).copy()
    n_loops = sum(1 for e in events if "loop_closed" in str(e))
    lc = sysm._loop_closer
    accepted = [(a, b) for a, b, _ in lc._accepted_loops] if lc else []
    loops = [(f, k, s) for (f, k), s in zip(loop_events(events), accepted)]
    summary = accuracy_summary(
        seq.poses_cw[:n], [T for _, T in tr.trajectory],
        [T for _, T in tr.corrected_trajectory()], n_loops)
    codebook = ("trained" if np.array_equal(signs, voc.words_to_signs(trained))
                else "shipped")
    return AccuracyRun(
        records={k: np.asarray(v) for k, v in rec.items()} if record else {},
        kf_frames=[int(round(ts * 30.0)) for ts, _ in tr.kf_log],
        loops=loops, summary=summary, trained_words=trained,
        codebook=codebook, codebook_signs=signs, ms=ms, mapped=mapped,
        system=sysm)


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def load_accuracy_fixture() -> dict:
    return load_npz(ACCURACY_FIXTURE)


# --- reference behaviours: the capacity wall and the office world -----------
BEHAVIOURS_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                  "data", "behaviours.npz")
WALL_KEYFRAMES = 12       # tests/test_long_run.py:20-46's keyframe slots
WALL_FRAMES = 70          # its frames at 320x240
WALL640_FRAMES = 48       # phase 13a's frames at 640x480 (~5 forced evictions)
# At 640x480 the keyframe culling keeps 8-10 of the 12 slots live to call 69
# (JAX's run), and the wall comes at call 70; phase 13a turns the culling
# pass off, and from the eleventh keyframe on every insertion evicts.
OFFICE_FRAMES = 40        # tests/test_transfer_validation.py:28-100
OFFICE_BLACK = 3          # black frames after them: LOST
OFFICE_REVISIT = 20       # then this frame again, up to OFFICE_TRIES times
OFFICE_TRIES = 3
OFFICE_ATE_MAX = 0.08     # the JAX tests' own acceptance
OFFICE_RELOC_MAX = 0.10
# the keyframe-insertion fields that `cull_one_keyframe` reads
CULL_FIELDS = ("kf_mp", "kf_kp_valid", "kf_valid", "kf_seq", "pt_valid")


def wall_cfg(cfg, culling: bool = True):
    """tests/test_long_run.py's keyframe policy on `cfg` (either package's):
    12 keyframe slots, a keyframe forced every 4 frames (min 3) and a
    reference ratio of 0.995, so the map runs into its capacity and culling
    must free slots; `culling=False` turns the culling pass off."""
    import dataclasses

    return cfg.replace(
        map=dataclasses.replace(cfg.map, max_keyframes=WALL_KEYFRAMES),
        tracking=dataclasses.replace(cfg.tracking, min_frames=3,
                                     max_frames=4, kf_ref_ratio=0.995,
                                     run_kf_culling=culling))


def wall_sequence(cfg, n: int, device=None):
    """The long-run corridor (2 cm per frame) at `cfg`'s camera."""
    from dr_slam_torch.io.synthetic import (SyntheticSequence,
                                            corridor_trajectory)
    cam = cfg.camera
    return SyntheticSequence(corridor_trajectory(n, step=0.02), K4=cam.K4,
                             height=cam.height, width=cam.width,
                             device=device)


def office_cfg(cfg=None):
    """tests/test_transfer_validation.py's camera on `cfg` (`small_cfg` by
    default; either package's): fx 262, fy 258, cx 157, cy 118."""
    import dataclasses

    cfg = small_cfg() if cfg is None else cfg
    return cfg.replace(camera=dataclasses.replace(
        cfg.camera, fx=262.0, fy=258.0, cx=157.0, cy=118.0))


def office_fixture_frames(data: dict, device=None):
    """The behaviours fixture's office frames (gray uint8, depth uint16) as
    the `System` takes them, float32 gray and depth in metres: numpy, or
    tensors on `device`. -> (render(i) -> (gray, depth), the black pair)."""
    gray = data["office_gray"].astype(np.float32)
    depth = (data["office_depth"].astype(np.float32)
             / np.float32(office_cfg().camera.depth_factor))
    if device is not None:
        gray, depth = (torch.from_numpy(x).to(device) for x in (gray, depth))
    black = (gray[0] * 0,) * 2
    return (lambda i: (gray[i], depth[i])), black


def _host(x) -> np.ndarray:
    return to_numpy(x) if isinstance(x, torch.Tensor) else np.asarray(x)


class BehaviourRecorder:
    """Per call of a `System` of either package: the state code, the
    keyframes inserted during the call, the reference keyframe slot, every
    slot's insertion sequence, T_cw, the inliers, the live points and the
    call's wall ms (synchronised with `sync`)."""

    KEYS = ("state", "kf", "ref_kf", "kf_seq", "T_cw", "n_inliers", "n_pts",
            "ms")

    def __init__(self, system, sync=lambda: None):
        self.system, self.sync = system, sync
        self.rec = {k: [] for k in self.KEYS}

    def track(self, gray, depth, ts: float, flush: bool = False):
        tr = self.system.tracker
        n_kf = len(tr.kf_log)
        t0 = time.perf_counter()
        res = self.system.track_rgbd(gray, depth, ts)
        if flush:
            tr.flush()
        self.sync()
        ms = (time.perf_counter() - t0) * 1e3
        st = tr.map_state
        for k, v in (("state", tr.state.value if flush else res.state.value),
                     ("kf", len(tr.kf_log) - n_kf), ("ref_kf", tr.ref_kf),
                     ("kf_seq", _host(st.kf_seq).copy()),
                     ("T_cw", _host(res.T_cw).astype(np.float32)),
                     ("n_inliers", int(res.n_inliers)),
                     ("n_pts", int(_host(st.n_pts))), ("ms", ms)):
            self.rec[k].append(v)
        return res

    def arrays(self, prefix: str = "") -> dict:
        return {prefix + k: np.asarray(v) for k, v in self.rec.items()}


def wall_run(system, render, n: int, sync=lambda: None) -> dict:
    """The capacity-wall scenario on a `System`: frames 0..n-1 of
    `render(i) -> (gray, depth)`. -> the recorder's arrays."""
    rec = BehaviourRecorder(system, sync)
    for i in range(n):
        rec.track(*render(i), i / 30.0)
    return rec.arrays()


def office_run(system, render, black, sync=lambda: None) -> dict:
    """tests/test_transfer_validation.py's office scenario on a `System`:
    OFFICE_FRAMES frames, a flush, OFFICE_BLACK black frames (`black`, a
    (gray, depth) pair) and a flush, then frame OFFICE_REVISIT again, each
    try flushed, until the tracker is OK or OFFICE_TRIES tries are spent.
    The flushed calls record the tracker's state after the flush. -> the
    recorder's arrays, with "reloc_call" the call that ended OK (-1:
    none)."""
    rec = BehaviourRecorder(system, sync)
    n = OFFICE_FRAMES
    for i in range(n):
        rec.track(*render(i), i / 30.0, flush=i == n - 1)
    for j in range(OFFICE_BLACK):
        rec.track(*black, (n + j) / 30.0, flush=j == OFFICE_BLACK - 1)
    reloc = -1
    gray, depth = render(OFFICE_REVISIT)
    for j in range(OFFICE_TRIES):
        rec.track(gray, depth, (n + 4 + j) / 30.0, flush=True)
        if rec.rec["state"][-1] == 2:     # OK
            reloc = len(rec.rec["state"]) - 1
            break
    out = rec.arrays()
    out["reloc_call"] = np.int32(reloc)
    return out


def centres(Ts) -> np.ndarray:
    return np.asarray([np.linalg.inv(np.asarray(T, np.float64))[:3, 3]
                       for T in Ts])


def trajectory_ate(T_cws, poses_cw) -> float:
    """ATE (Umeyama-aligned, fixed scale) of the camera centres of the
    poses `T_cws` against the first len(T_cws) true poses `poses_cw`."""
    from dr_slam_torch.io.metrics import ate_rmse

    return float(ate_rmse(centres(T_cws), centres(poses_cw[:len(T_cws)])))


def office_acceptance(out: dict, poses_cw: np.ndarray) -> dict:
    """The JAX office tests' numbers on a run: LOST frames and ATE over the
    tracked frames, whether the blackout ended LOST, and the relocalized
    pose's distance from the ground truth in the map's frame (camera 0's).
    """
    n, st = OFFICE_FRAMES, out["state"]
    ate = trajectory_ate(out["T_cw"][:n], poses_cw)
    call = int(out["reloc_call"])
    err = float("inf")
    if call >= 0:
        T_gt = poses_cw[OFFICE_REVISIT] @ np.linalg.inv(poses_cw[0])
        err = float(np.linalg.norm(centres([out["T_cw"][call]])[0]
                                   - centres([T_gt])[0]))
    return {"lost": int((st[:n] == 3).sum()), "ate": ate,
            "blackout_lost": bool(st[n + OFFICE_BLACK - 1] == 3),
            "reloc_try": call - n - OFFICE_BLACK if call >= 0 else -1,
            "reloc_err": err}


def behaviour_gaps(a: dict, b: dict,
                   unheld_count_calls: tuple = ()) -> tuple[dict, list]:
    """Run `b` against run `a` (both `BehaviourRecorder.arrays`): states,
    keyframes, reference keyframes and every slot's insertion sequence
    exact, T_cw within TRACKER_T_TOL per entry, inliers and live points
    within TRACKER_COUNT_TOL on every call but `unheld_count_calls`
    (measured there, not held). -> (numbers, failed checks)."""
    if len(a["state"]) != len(b["state"]):
        return {}, [f"{len(b['state'])} calls, want {len(a['state'])}"]
    differ = {k: [int(i) for i in np.nonzero(
        (a[k] != b[k]).reshape(len(a[k]), -1).any(1))[0]]
        for k in ("state", "kf", "ref_kf", "kf_seq")}
    dT = np.abs(a["T_cw"] - b["T_cw"]).max(axis=(1, 2))
    rel = {k: np.abs(a[k] - b[k]) / np.maximum(a[k], 1)
           for k in ("n_inliers", "n_pts")}
    gaps = {"differ": differ, "dT_max": float(dT.max()),
            "dT_over": [int(i) for i in np.nonzero(dT > TRACKER_T_TOL)[0]],
            "rel": {k: float(v.max()) for k, v in rel.items()},
            "count_over": {k: [[int(i), int(a[k][i]), int(b[k][i])]
                               for i in np.nonzero(v > TRACKER_COUNT_TOL)[0]]
                           for k, v in rel.items()}}
    fails = [f"{k} differs at calls {v}" for k, v in differ.items() if v]
    if gaps["dT_over"]:
        fails.append(f"|dT_cw| over {TRACKER_T_TOL} at calls "
                     f"{gaps['dT_over']} (max {gaps['dT_max']:.2e})")
    fails += [f"{k} off by more than {TRACKER_COUNT_TOL} at [call, want, "
              f"got] {held}" for k, v in gaps["count_over"].items()
              if (held := [x for x in v if x[0] not in unheld_count_calls])]
    return gaps, fails


def load_behaviours_fixture() -> dict:
    return load_npz(BEHAVIOURS_FIXTURE)


def fixture_evictions(data: dict, prefix: str, cfg, dev,
                      sync=lambda: None) -> tuple[list, list, list]:
    """Each forced eviction the behaviours fixture stored under `prefix`
    (JAX's map state compressed to `CULL_FIELDS`, on an empty state of
    `cfg`) through the port's `cull_one_keyframe(force=True)` on `dev`.
    -> (the slots it freed, JAX's, the ms of each call, synchronised with
    `sync`)."""
    from dr_slam_torch.io.map_io import from_jax_state
    from dr_slam_torch.slam import map_ops
    from dr_slam_torch.slam.state import make_empty_state

    empty = {k: to_numpy(v) for k, v in
             make_empty_state(cfg, "cpu")._asdict().items()}
    got, ms = [], []
    for e in range(len(data[f"{prefix}call"])):
        fields = dict(empty, **{f: data[f"{prefix}{f}"][e]
                                for f in CULL_FIELDS})
        fields["n_kfs"] = np.int32(fields["kf_valid"].sum())
        st = from_jax_state(fields, dev)
        sync()
        t0 = time.perf_counter()
        out = map_ops.cull_one_keyframe(st, force=True)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        got.append(np.nonzero(fields["kf_valid"]
                              & ~to_numpy(out.kf_valid))[0].tolist())
    return got, [[int(s)] for s in data[f"{prefix}slot"]], ms


# --- bench_torch.py's legs --------------------------------------------------

BENCH_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "data", "bench_runs.npz")


def load_bench_fixture() -> dict:
    """The JAX package's runs of bench.py's loops
    (scripts/make_torch_bench_fixture.py)."""
    return load_npz(BENCH_FIXTURE)


# Frames of bench_runs.npz's runs (the corridor at 640x480) whose inlier
# count the ORB pyramid's float32 rounding alone decides: near-tied
# keypoints there flip when a level moves by 1e-5 grey levels, and the JAX
# package's jitted pyramid lies up to 2.6e-3 from the port's, so on these
# frames the port's inliers sit 3.4-5.2% from JAX's, in both legs. Given
# JAX's pyramid the port holds there: from JAX's device-loop state before
# frame 27 its records equal JAX's, and its `System` from an empty map
# stays within TRACKER_COUNT_TOL on every frame
# (tests/test_torch_bench.py's witnesses). These counts are held by those
# witnesses, not by TRACKER_COUNT_TOL.
BENCH_PYRAMID_FRAMES = (27, 30, 33)


def bench_inliers_held(n: int, lag: int = 0) -> np.ndarray:
    """(n,) bool: the records whose inlier count TRACKER_COUNT_TOL holds
    against bench_runs.npz, all but those of BENCH_PYRAMID_FRAMES; record
    i is frame i - lag's (1 for the `System` leg, whose deferred decision
    returns the frame before's)."""
    held = np.ones(n, bool)
    held[[f + lag for f in BENCH_PYRAMID_FRAMES if f + lag < n]] = False
    return held


def bench_fixture_frames(data: dict, depth_factor: float) -> list:
    """The bench fixture's frames (JAX's renders as uint8 gray and uint16
    depth units) as `System.track_rgbd` takes them: float32 gray, float32
    depth in metres."""
    return [(g.astype(np.float32), d.astype(np.float32) / depth_factor)
            for g, d in zip(data["frames_gray"], data["frames_depth"])]
