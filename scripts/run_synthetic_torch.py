#!/usr/bin/env python
"""End-to-end SLAM run of the PyTorch port on a synthetic Manhattan
sequence, with ATE scoring: the twin of scripts/run_synthetic.py (the
stand-in for the reference's run.sh + evo_ape protocol while real TUM data
is unavailable). Renders an exactly-posed RGB-D sequence on the device with
`dr_slam_torch.io.synthetic`, tracks it with `System.track_rgbd` and scores
ATE-RMSE and RPE internally.

    python scripts/run_synthetic_torch.py [--frames 80]
        [--trajectory corridor|loop] [--out /tmp/drslam_out] [--depth-noise]
        [--viewer] [--live PORT] [--profile-dir DIR] [--device cuda|cpu]

Prints one JSON line, the summary of scripts/run_synthetic.py: frames, fps,
ate_rmse_m, rpe_trans_m, rpe_rot_rad, lost_frames and the map summary.
--profile-dir writes a torch.profiler trace (chrome JSON) there."""

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--trajectory", choices=["corridor", "loop"],
                    default="corridor")
    ap.add_argument("--out", default="/tmp/drslam_out")
    ap.add_argument("--depth-noise", action="store_true")
    ap.add_argument("--viewer", action="store_true")
    ap.add_argument("--live", type=int, default=None, metavar="PORT",
                    help="serve the live browser viewer on this port "
                         "(0 = any free port; printed at startup)")
    ap.add_argument("--profile-dir", default=None,
                    help="write a torch.profiler trace here")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sequence; returns the summary it prints."""
    args = parse_args(argv)

    from dr_slam_torch import to_numpy
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.io import synthetic
    from dr_slam_torch.io.metrics import ate_rmse, rpe
    from dr_slam_torch.slam.system import System

    cfg = tum_freiburg3()
    make = (synthetic.corridor_trajectory if args.trajectory == "corridor"
            else synthetic.loop_trajectory)
    seq = synthetic.SyntheticSequence(make(args.frames), K4=cfg.camera.K4,
                                      depth_noise=args.depth_noise,
                                      device=args.device)
    sysm = System(cfg, use_viewer=args.viewer,
                  live_viewer=args.live is not None,
                  live_viewer_port=args.live or 0, device=args.device)
    if sysm._live is not None:
        print(f"live viewer: http://127.0.0.1:{sysm._live.port}/",
              file=sys.stderr)

    prof = contextlib.nullcontext()
    if args.profile_dir:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU]
                       + [ProfilerActivity.CUDA] * (seq.device.type == "cuda"))
    t_start = time.perf_counter()
    states = []
    with prof:
        for i in range(len(seq)):
            gray, depth = seq.render(i)
            res = sysm.track_rgbd(gray, depth, i / seq.fps)
            states.append(res.state.name)
            print(f"frame {i:4d} state={res.state.name} "
                  f"inliers={res.n_inliers} matches={res.n_matches} "
                  f"manhattan={res.manhattan_ok}", file=sys.stderr)
        sysm.block_until_ready()
    wall = time.perf_counter() - t_start
    if args.profile_dir:
        os.makedirs(args.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(args.profile_dir, "trace.json"))

    est_T = np.asarray([np.linalg.inv(to_numpy(T))
                        for _, T in sysm.tracker.trajectory])
    gt_Twc = np.asarray([np.linalg.inv(p) for p in seq.poses_cw])
    n = min(len(est_T), len(gt_Twc))
    ate = ate_rmse(est_T[:n, :3, 3], gt_Twc[:n, :3, 3])
    t_rpe, r_rpe = rpe(est_T[:n], gt_Twc[:n])

    os.makedirs(args.out, exist_ok=True)
    sysm.shutdown(save_dir=args.out)
    summary = {
        "frames": len(seq),
        "fps": round(len(seq) / wall, 2),
        "ate_rmse_m": round(float(ate), 4),
        "rpe_trans_m": round(float(t_rpe), 5),
        "rpe_rot_rad": round(float(r_rpe), 5),
        "lost_frames": states.count("LOST"),
        **sysm.map_summary(),
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
