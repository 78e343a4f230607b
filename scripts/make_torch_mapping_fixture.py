"""Build the fixture that `chip_smoke.py` phase 4 drives the port's Tracker
with: a map built from empty over 24 frames.

The JAX package's `System` tracker (`tum_freiburg3()` preset, loop closing
off, the default deferred mode) tracks frames 0-23 of the synthetic
corridor on the CPU, from an empty map. After every frame the script waits
for each pending frame's bundle (`jax.block_until_ready`), so the deferred
decision lags by exactly one frame. The fixture holds the frames in
camera-native types (uint8 gray, uint16 depth sensor units), and the
tracker's outputs: per frame T_cw, the state code (1 NOT_INITIALIZED, 2 OK,
3 LOST), n_inliers, n_matches and is_keyframe; the frames whose keyframes
were inserted (from `kf_log`) with their poses; and, after `flush()`, the
live keyframe, point, plane and line counts. Both packages are fed the
gray image as float32 and the depth as `d16 / depth_factor` in float32.

Run from the repository root (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_mapping_fixture.py

Writes dr_slam_torch/data/mapping_corridor.npz."""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N_FRAMES = 24


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "dr_slam_torch", "data", "mapping_corridor.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.io import synthetic
    from dr_slam_tpu.slam.system import System

    cfg = tum_freiburg3()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(N_FRAMES), K4=cfg.camera.K4)
    tracker = System(cfg, enable_loop_closing=False).tracker
    grays, depths, Ts, states, n_inl, n_match, is_kf = [], [], [], [], [], [], []
    for i in range(N_FRAMES):
        g, d = seq.render(i)
        g8 = np.asarray(jnp.clip(g + 0.5, 0, 255).astype(jnp.uint8))
        d16 = np.asarray(jnp.clip(d * cfg.camera.depth_factor + 0.5, 0,
                                  65535).astype(jnp.uint16))
        r = tracker.process_frame(g8.astype(np.float32),
                                  (d16 / cfg.camera.depth_factor
                                   ).astype(np.float32), i / 30.0)
        for entry in tracker._pending:
            jax.block_until_ready(entry[2].bundle)
        grays.append(g8)
        depths.append(d16)
        Ts.append(np.asarray(r.T_cw, np.float32))
        states.append(r.state.value)
        n_inl.append(r.n_inliers)
        n_match.append(r.n_matches)
        is_kf.append(r.is_keyframe)
        print(f"frame {i}: {r.state.name} n_inliers {r.n_inliers} "
              f"n_matches {r.n_matches} keyframes {len(tracker.kf_log)}",
              flush=True)
    tracker.flush()
    st = tracker.map_state
    kf_frames = [int(round(ts * 30.0)) for ts, _ in tracker.kf_log]
    np.savez_compressed(
        args.out, gray=np.stack(grays), depth=np.stack(depths),
        T_cw=np.stack(Ts), state=np.asarray(states, np.int32),
        n_inliers=np.asarray(n_inl, np.int32),
        n_matches=np.asarray(n_match, np.int32),
        is_keyframe=np.asarray(is_kf, bool),
        kf_frames=np.asarray(kf_frames, np.int32),
        kf_T=np.stack([np.asarray(T, np.float32) for _, T in tracker.kf_log]),
        n_kfs=np.int32(st.n_kfs), n_pts=np.int32(st.n_pts),
        n_planes=np.int32(jnp.sum(st.pl_valid)),
        n_lines=np.int32(jnp.sum(st.ln_valid)))
    print(f"keyframes at frames {kf_frames}; n_kfs {int(st.n_kfs)} n_pts "
          f"{int(st.n_pts)}")
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
