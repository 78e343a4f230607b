"""Build the fixture that `chip_smoke.py` phase 5 drives the port's `System`
with: a saved map to relocalize into, and the JAX `System`'s outputs there.

The JAX package's `System` (`tum_freiburg3()` preset, 640x480, loop closing
off, the default deferred mode) tracks frames 0-23 of the synthetic
corridor on the CPU from an empty map, waiting for each pending frame's
bundle after every frame (as scripts/make_torch_mapping_fixture.py does, and
over the same frames: the trajectory does not depend on its length). Its map
is saved under "map__<field>". Then two runs start from a fresh `System`
that loads that map, and so begins LOST:

- A: localization mode (the map stays frozen), frames 18-29;
- B: loop closing on, frames 24, 25, a black frame, 26-29: it relocalizes,
  tracks, is lost again, and relocalizes in a map that it now extends.

For each frame of each run the fixture holds the state code (1
NOT_INITIALIZED, 2 OK, 3 LOST), T_cw, n_inliers, n_matches and the tracker's
reference keyframe, and after each run (flushed) the live keyframe, point,
plane and line counts. Frames 18-29 are stored in camera-native types (uint8
gray, uint16 depth); both packages are fed the gray image as float32 and the
depth as `d16 / depth_factor` in float32.

Run from the repository root (several minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_reloc_fixture.py

Writes dr_slam_torch/data/reloc_corridor.npz."""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N_MAP = 24
FIRST, LAST = 18, 29          # the frames stored
RUN_A = list(range(18, 30))
RUN_B = [24, 25, -1, 26, 27, 28, 29]    # -1: a black frame


def _run(sysm, frames, order, cfg) -> dict:
    out = {k: [] for k in ("frame", "state", "T_cw", "n_inliers",
                           "n_matches", "ref_kf")}
    for n, i in enumerate(order):
        if i < 0:
            g8 = np.zeros_like(frames[0][0])
            d16 = np.zeros_like(frames[0][1])
        else:
            g8, d16 = frames[i - FIRST]
        r = sysm.track_rgbd(g8.astype(np.float32),
                            (d16 / cfg.camera.depth_factor).astype(np.float32),
                            (i if i >= 0 else order[n - 1] + 0.5) / 30.0)
        for entry in sysm.tracker._pending:
            jax.block_until_ready(entry[2].bundle)
        out["frame"].append(i)
        out["state"].append(r.state.value)
        out["T_cw"].append(np.asarray(r.T_cw, np.float32))
        out["n_inliers"].append(r.n_inliers)
        out["n_matches"].append(r.n_matches)
        out["ref_kf"].append(sysm.tracker.ref_kf)
        print(f"  frame {i}: {r.state.name} n_inliers {r.n_inliers} "
              f"n_matches {r.n_matches} ref_kf {sysm.tracker.ref_kf}",
              flush=True)
    sysm.tracker.flush()
    st = sysm.tracker.map_state
    res = {k: np.asarray(v) for k, v in out.items()}
    res.update(n_kfs=np.int32(st.n_kfs), n_pts=np.int32(st.n_pts),
               n_planes=np.int32(jnp.sum(st.pl_valid)),
               n_lines=np.int32(jnp.sum(st.ln_valid)),
               final_state=np.int32(sysm.tracker.state.value))
    return res


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "dr_slam_torch", "data", "reloc_corridor.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.io import synthetic
    from dr_slam_tpu.slam.system import System

    cfg = tum_freiburg3()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(LAST + 1), K4=cfg.camera.K4)

    def camera(i):
        g, d = seq.render(i)
        g8 = np.asarray(jnp.clip(g + 0.5, 0, 255).astype(jnp.uint8))
        d16 = np.asarray(jnp.clip(d * cfg.camera.depth_factor + 0.5, 0,
                                  65535).astype(jnp.uint16))
        return g8, d16

    sysm = System(cfg, enable_loop_closing=False)
    tracker = sysm.tracker
    for i in range(N_MAP):
        g8, d16 = camera(i)
        r = tracker.process_frame(g8.astype(np.float32),
                                  (d16 / cfg.camera.depth_factor
                                   ).astype(np.float32), i / 30.0)
        for entry in tracker._pending:
            jax.block_until_ready(entry[2].bundle)
        print(f"map frame {i}: {r.state.name} n_inliers {r.n_inliers} "
              f"keyframes {len(tracker.kf_log)}", flush=True)
    tracker.flush()
    st = tracker.map_state
    out = {f"map__{k}": np.asarray(v) for k, v in st._asdict().items()}
    print(f"map: n_kfs {int(st.n_kfs)} n_pts {int(st.n_pts)}", flush=True)

    frames = [camera(i) for i in range(FIRST, LAST + 1)]
    out["first_frame"] = np.int32(FIRST)
    out["gray"] = np.stack([g for g, _ in frames])
    out["depth"] = np.stack([d for _, d in frames])

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        sysm.save_map(path)
        print("run A: localization mode, frames 18-29", flush=True)
        sa = System(cfg, enable_loop_closing=False)
        sa.load_map(path)
        sa.activate_localization_mode()
        for k, v in _run(sa, frames, RUN_A, cfg).items():
            out[f"a__{k}"] = v
        print("run B: loop closing on, frames 24, 25, black, 26-29",
              flush=True)
        sb = System(cfg, enable_loop_closing=True)
        sb.load_map(path)
        for k, v in _run(sb, frames, RUN_B, cfg).items():
            out[f"b__{k}"] = v
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
