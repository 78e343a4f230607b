"""Build the fixture that `chip_smoke.py` phase 9 holds the port's dataset
runner and streaming node to: the JAX package's own runner and node over
the mapping fixture's frames.

The 24 frames of dr_slam_torch/data/mapping_corridor.npz (uint8 gray,
uint16 depth; the synthetic corridor `corridor_trajectory(24)`) are written
as a TUM sequence by the JAX package's `export_tum_sequence` (first
timestamp 1000, 30 frames/s, those poses as groundtruth.txt), and
scripts/run_tum.py runs over it on the CPU (`tum_freiburg3()`, the
default deferred mode, loop closing on). Then a JAX `SlamServer` over a
fresh `System` serves a `CameraClient` frames 0-11, streamed as 3-channel
uint8 and float32 metres, followed by a save_occupancy command. After every
frame the script waits for each pending frame's bundle
(`jax.block_until_ready`), so the deferred decision lags by exactly one
frame, as on the card, where phase 9 synchronises after each frame
(`tests/torch_parity.py: jax_system_lagged_by_one`).

The fixture holds no frames. It holds the ground-truth poses; the runner's
summary JSON, its CameraTrajectory.txt and KeyFrameTrajectory.txt rows
and its per-frame outputs (T_cw, state code, n_inliers, n_matches,
is_keyframe, ref_kf), the frames of its keyframes and the final counts;
the node's per-frame odometry and its save_occupancy reply (keyframe
odometry, grid, origin); and `plane_meshes`' vertex and face counts on the
runner's final map.

Run from the repository root (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_tum_fixture.py

Writes dr_slam_torch/data/tum_corridor.npz."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import numpy as np  # noqa: E402

N_FRAMES = 24


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "tum_corridor.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.io import synthetic, transport
    from dr_slam_tpu.io.mesh_export import plane_meshes
    from dr_slam_tpu.io.tum import export_tum_sequence
    from dr_slam_tpu.slam.system import System
    from dr_slam_torch._smoke import (TUM_T0, export_fixture_sequence,
                                      load_mapping_fixture, node_frames,
                                      node_session, odom_arrays,
                                      read_tum_rows)
    from torch_parity import jax_system_lagged_by_one, load_script

    cfg = tum_freiburg3()
    factor = cfg.camera.depth_factor
    mdata = load_mapping_fixture()
    poses = np.stack([np.asarray(T, np.float32)
                      for T in synthetic.corridor_trajectory(N_FRAMES)])
    out = {"gt_T_cw": poses}
    with tempfile.TemporaryDirectory() as tmp, \
            jax_system_lagged_by_one() as calls:
        seq = export_fixture_sequence(export_tum_sequence,
                                      os.path.join(tmp, "seq"), mdata,
                                      poses, factor)
        run_tum = load_script("run_tum")
        run_out = os.path.join(tmp, "out")
        argv, sys.argv = sys.argv, ["run_tum.py", seq, "--out", run_out]
        printed = io.StringIO()
        try:
            with contextlib.redirect_stdout(printed):
                run_tum.main()
        finally:
            sys.argv = argv
        summary = json.loads(printed.getvalue().strip().splitlines()[-1])
        print(f"run_tum.py: {summary}", flush=True)
        res = [c[0] for c in calls]
        system = calls[-1][2]
        tr = system.tracker
        st = tr.map_state
        out.update({
            "run__summary": np.asarray(json.dumps(summary)),
            "run__camera_traj": read_tum_rows(
                os.path.join(run_out, "CameraTrajectory.txt")),
            "run__kf_traj": read_tum_rows(
                os.path.join(run_out, "KeyFrameTrajectory.txt")),
            "run__T_cw": np.stack([np.asarray(r.T_cw, np.float32)
                                   for r in res]),
            "run__state": np.asarray([r.state.value for r in res], np.int32),
            "run__n_inliers": np.asarray([r.n_inliers for r in res],
                                         np.int32),
            "run__n_matches": np.asarray([r.n_matches for r in res],
                                         np.int32),
            "run__is_keyframe": np.asarray([r.is_keyframe for r in res]),
            "run__ref_kf": np.asarray([c[1] for c in calls], np.int32),
            "run__kf_frames": np.asarray(
                [int(round((ts - TUM_T0) * 30.0)) for ts, _ in tr.kf_log],
                np.int32),
            "run__n_kfs": np.int32(st.n_kfs), "run__n_pts": np.int32(st.n_pts),
            "run__n_planes": np.int32(np.asarray(st.pl_valid).sum()),
            "run__n_lines": np.int32(np.asarray(st.ln_valid).sum())})
        v, f, _ = plane_meshes(st)
        out["mesh__n_verts"], out["mesh__n_faces"] = np.int32(len(v)), \
            np.int32(len(f))
        print(f"runner: keyframes at {out['run__kf_frames'].tolist()}, "
              f"states {out['run__state'].tolist()}; mesh {len(v)} vertices "
              f"{len(f)} faces", flush=True)

        calls.clear()
        server = transport.SlamServer(System(cfg))
        try:
            sess = node_session(transport, server, node_frames(mdata, factor),
                                map_path=os.path.join(tmp, "node_map.npz"))
        finally:
            server.close()
    odom = odom_arrays(sess["odom"])
    out.update({f"node__{k}": v for k, v in odom.items()})
    out.update({
        "occ__keyframes": np.int32(sess["occ_status"]["keyframes"]),
        "occ__kf_position": np.asarray([o["position"]
                                        for o in sess["kf_odom"]]),
        "occ__kf_orientation": np.asarray([o["orientation"]
                                           for o in sess["kf_odom"]]),
        "occ__grid": sess["grid"],
        "occ__origin": np.asarray(sess["occ_status"]["origin"])})
    print(f"node: states {odom['state'].tolist()}, keyframes "
          f"{np.where(odom['is_keyframe'])[0].tolist()}, occupancy over "
          f"{int(out['occ__keyframes'])} keyframes, grid sum "
          f"{int(sess['grid'].sum())}", flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.3f} MB)")


if __name__ == "__main__":
    main()
