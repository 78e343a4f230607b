"""Shared pieces of the port's GPU smoke run (`chip_smoke.py`), its frame
profiler (`scripts/profile_torch_frame.py`) and its CUDA tests: the card's
name line, the smoke fixture, the pipelined frame loop, and matcher inputs
at the main path's shapes."""

from __future__ import annotations

import os
import subprocess
from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.io.map_io import from_jax_state
from dr_slam_torch.slam.state import MapState
from dr_slam_torch.slam.track_step import extract_and_track

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "smoke_corridor.npz")


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
