"""Shared pieces of the port's GPU smoke run (`chip_smoke.py`), its frame
profiler (`scripts/profile_torch_frame.py`) and its CUDA and full-size
tests: the card's name line, the smoke fixture, the pipelined frame loop,
matcher inputs at the main path's shapes, and the mapping fixture with the
Tracker run over it."""

from __future__ import annotations

import os
import subprocess
import time
from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.io.map_io import from_jax_state
from dr_slam_torch.slam.state import MapState
from dr_slam_torch.slam.track_step import extract_and_track

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "smoke_corridor.npz")
MAPPING_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "data", "mapping_corridor.npz")


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


def tracker_gaps(run: TrackerRun, data: dict) -> tuple[dict, list]:
    """The run's distances from the JAX outputs, and the failed checks."""
    res, st = run.results, run.tracker.map_state
    dT = [float(np.abs((r.T_cw.cpu().numpy() if isinstance(r.T_cw, torch.Tensor)
                        else np.asarray(r.T_cw)) - data["T_cw"][i]).max())
          for i, r in enumerate(res)]
    kf_frames = [int(round(ts * 30.0)) for ts, _ in run.tracker.kf_log]
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
