"""Build the fixture that `chip_smoke.py` drives the PyTorch port with.

The JAX package builds a map the way `bench.py` (bench_odometry) does: a
`System` with the `tum_freiburg3()` preset tracks the first 12 frames of the
synthetic corridor on the CPU. The fixture holds that map, frames 12-15 in
camera-native types (uint8 gray, uint16 depth sensor units, cast as
bench.py stages them), the tracker's state after frame 11, and the JAX
`extract_and_track` outputs for frames 12-15 chained from that state
(T_cw, n_matches, n_inliers, mp_idx). The port is then held against them.

Run from the repository root (takes a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_smoke_fixture.py

Writes dr_slam_torch/data/smoke_corridor.npz. The map fields are stored
under "map__<field>" in the layout of dr_slam_tpu/io/map_io.py."""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

FIRST, N_FRAMES, N_MAP = 12, 4, 12


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "dr_slam_torch", "data", "smoke_corridor.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.io import synthetic
    from dr_slam_tpu.slam.system import System
    from dr_slam_tpu.slam.track_step import extract_and_track

    cfg = tum_freiburg3()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(16), K4=cfg.camera.K4)
    sysm = System(cfg, enable_loop_closing=False)
    for i in range(N_MAP):
        g, d = seq.render(i)
        sysm.track_rgbd(g, d, i / 30.0)
        print(f"map frame {i}", flush=True)
    sysm.tracker.flush()
    tr = sysm.tracker
    state = tr.map_state
    out = {f"map__{k}": np.asarray(v) for k, v in state._asdict().items()}
    T, vel, R, ref = tr.T_cw, tr.velocity, tr.R_cm, int(tr.ref_kf)
    out.update(T_last=np.asarray(T, np.float32),
               velocity=np.asarray(vel, np.float32),
               R_cm=np.asarray(R, np.float32), ref_kf=np.int32(ref))

    grays, depths, Ts, n_match, n_inl, mp_idx = [], [], [], [], [], []
    for i in range(FIRST, FIRST + N_FRAMES):
        g, d = seq.render(i)
        g8 = np.asarray(jnp.clip(g + 0.5, 0, 255).astype(jnp.uint8))
        d16 = np.asarray(jnp.clip(d * cfg.camera.depth_factor + 0.5, 0,
                                  65535).astype(jnp.uint16))
        _, o = extract_and_track(jnp.asarray(g8), jnp.asarray(d16), state,
                                 T, vel, R, jnp.asarray(ref), cfg)
        state, T, vel, R = o.new_map_state, o.T_cw, o.velocity, o.R_cm
        grays.append(g8)
        depths.append(d16)
        Ts.append(np.asarray(o.T_cw))
        n_match.append(int(o.n_matches))
        n_inl.append(int(o.n_inliers))
        mp_idx.append(np.asarray(o.mp_idx))
        print(f"frame {i}: n_matches {n_match[-1]} n_inliers {n_inl[-1]}",
              flush=True)
    out.update(gray=np.stack(grays), depth=np.stack(depths),
               T_cw=np.stack(Ts).astype(np.float32),
               n_matches=np.asarray(n_match, np.int32),
               n_inliers=np.asarray(n_inl, np.int32),
               mp_idx=np.stack(mp_idx).astype(np.int32))
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
