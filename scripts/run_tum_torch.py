#!/usr/bin/env python
"""Run the PyTorch port of DR-SLAM on a TUM RGB-D sequence (the reference's
dataset runner, Examples/RGB-D/main.cc and run_tum.sh): track every frame
with `System.track_rgbd`, save the TUM-format trajectories, and score the
ATE against groundtruth.txt when the sequence has one. The flags and the
summary JSON are scripts/run_tum.py's, plus --device.

    python scripts/run_tum_torch.py SEQUENCE_DIR [--device cuda|cpu]
        [--config TUM3.yaml] [--out ./output] [--frames N] [--native-loader]
        [--localization-only] [--load-map MAP.npz] [--save-map MAP.npz]

Prints one JSON line: frames, fps, the map summary and ate_rmse_m."""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sequence", help="TUM sequence directory")
    ap.add_argument("--config", default=None, help="reference-style YAML")
    ap.add_argument("--out", default="./output")
    ap.add_argument("--frames", type=int, default=0, help="limit (0=all)")
    ap.add_argument("--native-loader", action="store_true")
    ap.add_argument("--localization-only", action="store_true")
    ap.add_argument("--load-map", default=None)
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Run the sequence; returns the summary it prints."""
    args = parse_args(argv)

    from dr_slam_torch import to_numpy
    from dr_slam_torch.config import load_config, tum_freiburg3
    from dr_slam_torch.io.metrics import ate_rmse
    from dr_slam_torch.io.tum import TUMDataset, load_groundtruth
    from dr_slam_torch.slam.system import System

    cfg = load_config(args.config) if args.config else tum_freiburg3()
    ds = TUMDataset(args.sequence, depth_factor=cfg.camera.depth_factor)
    n = min(len(ds), args.frames) if args.frames else len(ds)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
    sysm = System(cfg, metrics_path=os.path.join(args.out, "metrics.jsonl")
                  if args.out else None, device=args.device)
    if args.load_map:
        sysm.load_map(args.load_map)
    if args.localization_only:
        sysm.activate_localization_mode()

    def track(i, gray, depth, ts):
        res = sysm.track_rgbd(gray, depth, ts)
        if i % 50 == 0:
            print(f"frame {i} {res.state.name} inliers={res.n_inliers}",
                  file=sys.stderr)

    t0 = time.perf_counter()
    if args.native_loader:
        from dr_slam_torch.io.native_loader import NativeTUMLoader
        loader = NativeTUMLoader(ds)
        try:
            for idx, ts, gray, depth in loader:
                if idx >= n:
                    break
                track(idx, gray, depth, ts)
        finally:
            loader.close()
    else:
        for i in range(n):
            fr = ds[i]
            track(i, fr.gray, fr.depth, fr.timestamp)
    sysm.block_until_ready()
    wall = time.perf_counter() - t0

    sysm.shutdown(save_dir=args.out)
    if args.save_map:
        sysm.save_map(args.save_map)

    summary = {"frames": n, "fps": round(n / wall, 2), **sysm.map_summary()}
    gt_path = os.path.join(args.sequence, "groundtruth.txt")
    if os.path.exists(gt_path):
        ts_gt, poses_gt = load_groundtruth(gt_path)
        est_ts = np.asarray([t for t, _ in sysm.tracker.trajectory])
        est = np.asarray([np.linalg.inv(to_numpy(T))[:3, 3]
                          for _, T in sysm.tracker.trajectory])
        # associate by nearest timestamp (the evo_ape tum protocol)
        gt_assoc = [poses_gt[int(np.argmin(np.abs(ts_gt - t))), :3]
                    for t in est_ts]
        summary["ate_rmse_m"] = round(ate_rmse(est, np.asarray(gt_assoc)), 4)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
