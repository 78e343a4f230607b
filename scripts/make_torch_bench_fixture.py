"""Build the fixture that `chip_smoke.py` phase 14 holds the legs of
`bench_torch.py` against: the JAX package driven through the loops of
`bench.py`, with the port's two rules.

The rules (tests/torch_parity.py): after each frame the JAX `System` waits
for its pending frames' bundles (`wait_pending`), so its deferred decision
lags by exactly one frame, as the port's does when each frame's upload
waits for the stream; and each tracked rotation is projected onto SO(3)
after the second pose solve (`projected_tracked_pose`), as the port's
`slam/track_step.py` does. Everything else is the JAX package's own, its
jitted ORB pyramid included: where that pyramid's float32 rounding alone
moves the device loop's inlier count (frames 27, 30 and 33), the port is
held by a witness instead (`dr_slam_torch._smoke.BENCH_PYRAMID_FRAMES`).

- "odo_": `bench_odometry`'s map, `System(tum_freiburg3(),
  enable_loop_closing=False)` over frames 0-11 of the mapping fixture
  (dr_slam_torch/data/mapping_corridor.npz: JAX's renders as uint8 gray and
  uint16 depth, fed as float32 gray and depth in metres), saved unflushed
  as bench.py saves it and loaded back: the live keyframes, their poses
  and the live points. (dr_slam_torch/data/smoke_corridor.npz's map comes
  from the same frames' float renders without the lag rule: its keyframe
  decision at frame 10 resolved later, and it holds 1126 points to the
  lagged run's 985.)
- "frames_": JAX's renders of the 60 frames of `corridor_trajectory(60)`
  as a camera gives them (uint8 gray, uint16 depth units, quantised as
  bench.py quantises them). On the port's own float renders the tracking
  leg's T_cw moves 4.3e-3 from the JAX run's on JAX's float renders, and
  four frames' inliers 2-4.5%; on JAX's it holds
  (scripts/parity_bench_torch.py). So the card's tracking leg is fed
  these, as phase 13b is fed the office's.
- "trk_": `bench_tracking`'s loop, `System(tum_freiburg3())` (loop closing
  on, as bench.py has it) over those frames (float32 gray, depth in
  metres): per frame the state code, the keyframe flag, the reference
  keyframe, T_cw, the inliers and matches; the keyframes' frames; the
  live keyframe and point counts at the end.
- "dl_": `bench_interactive_device`'s loop, the `DeviceLoopTracker` over
  the 120 frames of `corridor_trajectory(120)` quantised as bench.py
  quantises them (uint8 gray, uint16 depth), with the shipped codebooks
  registered (as a `System` registers them): its records and the live
  keyframe and point counts.
- "fe_": `bench_frontend`'s loop, `extract_orb` with its defaults over the
  30 frames of `corridor_trajectory(30)`: the valid keypoints per frame.

No timings are stored; the device-loop and front-end legs render their own
frames (on the CPU the port's renders hold there as JAX's do), and the
ground-truth poses are `corridor_trajectory`'s.

Run from the repository root (several minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_bench_fixture.py

Writes dr_slam_torch/data/bench_runs.npz."""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

MAP_FRAMES = 12          # bench.py: bench_odometry's map, frames 0-11
TRACKING_FRAMES = 60     # bench.py: bench_tracking(n_frames=60)
DEVICE_FRAMES = 120      # bench.py: bench_interactive_device(n_frames=120)
FRONTEND_FRAMES = 30     # bench.py: bench_frontend(n_frames=30)


def jax_odometry_map(cfg, frames) -> dict:
    """The JAX `System(cfg, enable_loop_closing=False)` over `frames`
    [(gray, depth in metres)], each call followed by `wait_pending`, its map
    saved unflushed and loaded back. -> the live keyframes, their poses and
    the live point count."""
    import tempfile

    from dr_slam_tpu.io.map_io import load_map
    from dr_slam_tpu.slam.system import System
    from torch_parity import wait_pending

    sysm = System(cfg, enable_loop_closing=False)
    for i, (g, d) in enumerate(frames):
        sysm.track_rgbd(g, d, i / 30.0)
        wait_pending(sysm)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        sysm.save_map(path)
        st = load_map(path, cfg)
    return {"kf_valid": np.asarray(st.kf_valid),
            "kf_pose": np.asarray(st.kf_pose, np.float32),
            "n_pts": np.int32(int(np.asarray(st.pt_valid).sum()))}


def jax_tracking_run(cfg, frames) -> dict:
    """The JAX `System(cfg)` over `frames` [(gray, depth in metres)], frame
    i at i / 30, each call followed by `wait_pending`. -> the per-frame
    record `bench_torch.bench_tracking` keeps (numpy arrays)."""
    from dr_slam_tpu.slam.system import System
    from torch_parity import wait_pending

    sysm = System(cfg)
    tr = sysm.tracker
    rec = {k: [] for k in ("state", "is_keyframe", "ref_kf", "T_cw",
                           "n_inliers", "n_matches")}
    for i, (g, d) in enumerate(frames):
        res = sysm.track_rgbd(g, d, i / 30.0)
        wait_pending(sysm)
        rec["state"].append(res.state.value)
        rec["is_keyframe"].append(bool(res.is_keyframe))
        rec["ref_kf"].append(int(tr.ref_kf))
        rec["T_cw"].append(np.asarray(res.T_cw, np.float32))
        rec["n_inliers"].append(int(res.n_inliers))
        rec["n_matches"].append(int(res.n_matches))
    out = {k: np.asarray(v) for k, v in rec.items()}
    out["kf_frames"] = np.asarray([int(round(ts * 30.0)) for ts, _ in
                                   tr.kf_log], np.int32)
    st = tr.map_state
    out["n_kfs"] = np.int32(int(np.asarray(st.kf_valid).sum()))
    out["n_pts"] = np.int32(int(np.asarray(st.n_pts)))
    return out


def jax_device_loop_run(cfg, frames) -> dict:
    """The JAX `DeviceLoopTracker(cfg)` over `frames` [(gray uint8, depth
    uint16)], frame i at i / 30. -> its records and counts."""
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker

    jt = DeviceLoopTracker(cfg)
    for i, (g, d) in enumerate(frames):
        jt.track(g, d, i / 30.0)
    f = jt.flush()
    st = jt.carry.map_state
    return {"records": f["records"],
            "n_keyframes": np.int32(f["n_keyframes"]),
            "n_pts": np.int32(int(np.asarray(st.n_pts)))}


def jax_frontend_counts(grays) -> np.ndarray:
    """`extract_orb` with its defaults on each gray image: valid keypoints."""
    import jax.numpy as jnp

    from dr_slam_tpu.ops import orb

    return np.asarray([int(orb.extract_orb(jnp.asarray(g)).valid.sum())
                       for g in grays], np.int32)


def quantize(gray, depth, depth_factor: float):
    """bench.py's camera-native staging of a float render."""
    g = np.asarray(gray, np.float32)
    d = np.asarray(depth, np.float32)
    return (np.clip(g + 0.5, 0, 255).astype(np.uint8),
            np.clip(d * depth_factor + 0.5, 0, 65535).astype(np.uint16))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "bench_runs.npz"))
    args = ap.parse_args()

    import jax

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.io import synthetic
    from dr_slam_torch._smoke import bench_fixture_frames
    from torch_parity import (numpy_frames, projected_tracked_pose,
                              shipped_codebooks)

    jax.config.update("jax_default_matmul_precision", "float32")
    cfg = tum_freiburg3()

    def sequence(n):
        return synthetic.SyntheticSequence(synthetic.corridor_trajectory(n),
                                           K4=cfg.camera.K4)

    df = cfg.camera.depth_factor
    frames = [quantize(g, d, df) for g, d in
              numpy_frames(sequence(DEVICE_FRAMES), DEVICE_FRAMES)]
    out = {"frames_gray": np.stack([g for g, _ in frames[:TRACKING_FRAMES]]),
           "frames_depth": np.stack([d for _, d in
                                     frames[:TRACKING_FRAMES]])}
    with projected_tracked_pose():
        t0 = time.perf_counter()
        with np.load(os.path.join(ROOT, "dr_slam_torch", "data",
                                  "mapping_corridor.npz")) as m:
            mapped = [(m["gray"][i].astype(np.float32),
                       m["depth"][i].astype(np.float32) / df)
                      for i in range(MAP_FRAMES)]
        run = jax_odometry_map(cfg, mapped)
        out.update({f"odo_{k}": v for k, v in run.items()})
        print(f"odometry map: {time.perf_counter() - t0:.1f} s, keyframes "
              f"{np.nonzero(run['kf_valid'])[0].tolist()}, "
              f"{int(run['n_pts'])} points", flush=True)
        t0 = time.perf_counter()
        run = jax_tracking_run(cfg, bench_fixture_frames(out, df))
        out.update({f"trk_{k}": v for k, v in run.items()})
        print(f"tracking: {time.perf_counter() - t0:.1f} s, states "
              f"{run['state'].tolist()}, keyframes at "
              f"{run['kf_frames'].tolist()}", flush=True)
        t0 = time.perf_counter()
        with shipped_codebooks():
            run = jax_device_loop_run(cfg, frames)
        out.update({f"dl_{k}": v for k, v in run.items()})
        print(f"device loop: {time.perf_counter() - t0:.1f} s, keyframes at "
              f"{np.nonzero(run['records'][:, 19])[0].tolist()}", flush=True)
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(FRONTEND_FRAMES))
    out["fe_n_valid"] = jax_frontend_counts(
        [np.asarray(seq.render(i)[0]) for i in range(FRONTEND_FRAMES)])
    print(f"frontend: valid keypoints {out['fe_n_valid'].tolist()}",
          flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)",
          flush=True)


if __name__ == "__main__":
    main()
