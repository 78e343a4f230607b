#!/usr/bin/env python
"""The PyTorch port's streaming node pair (the reference's ROS deployment,
Examples/RGB-D/main_ros.cc, without ROS); the twin of
scripts/stream_node.py, speaking the same wire format and topics, so either
package's camera drives either package's node.

Server role, the SLAM node (main_ros.cc:73-135):
    python scripts/stream_node_torch.py serve --port 7007 [--device cuda]
        [--config TUM3.yaml] [--once]
accepts a camera client, tracks every synchronized RGB-D pair, answers with
odometry per frame, and serves save_map / save_occupancy / shutdown
commands.

Camera role, the driver (publishes what a ROS camera driver would):
    python scripts/stream_node_torch.py camera --connect HOST:PORT SEQUENCE_DIR
streams a TUM sequence directory over the two image topics and prints the
odometry; at the end it asks the node to save its map (--save-map) and
shuts the node's session down. The camera role uses no device.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def serve(args):
    from dr_slam_torch.config import load_config, tum_freiburg3
    from dr_slam_torch.io.transport import SlamServer
    from dr_slam_torch.slam.system import System

    cfg = load_config(args.config) if args.config else tum_freiburg3()
    server = SlamServer(System(cfg, device=args.device), host=args.host,
                        port=args.port, slop=args.slop)
    print(f"[serve] listening on {server.address}", flush=True)
    try:
        while True:
            n = server.serve_once()
            print(f"[serve] client session done: {n} frames tracked",
                  flush=True)
            if args.once:
                break
    finally:
        server.close()


def camera(args):
    from dr_slam_torch.io.transport import CameraClient
    from dr_slam_torch.io.tum import TUMDataset

    host, port = args.connect.rsplit(":", 1)
    client = CameraClient((host, int(port)))
    ds = TUMDataset(args.sequence, depth_factor=args.depth_factor)
    n = min(len(ds), args.frames) if args.frames else len(ds)
    for i in range(n):
        f = ds[i]
        client.publish_frame(f.timestamp, np.asarray(f.gray, np.uint8),
                             np.asarray(f.depth, np.float32))
        msg = client.recv()
        if msg is None:
            break
        _, ts, odom = msg
        print(f"[camera] {ts:.3f} {odom['state']:>5} "
              f"pos={np.round(odom['position'], 3).tolist()}", flush=True)
    if args.save_map:
        client.command(cmd="save_map", path=args.save_map)
        print("[camera] save_map ->", client.recv()[2], flush=True)
    client.command(cmd="shutdown")
    client.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="role", required=True)

    s = sub.add_parser("serve", help="run the SLAM node")
    s.add_argument("--host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=7007)
    s.add_argument("--config", default=None, help="reference-style YAML")
    s.add_argument("--slop", type=float, default=0.02,
                   help="ApproximateTime sync window (s)")
    s.add_argument("--once", action="store_true",
                   help="exit after the first client session")
    s.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    s.set_defaults(fn=serve)

    c = sub.add_parser("camera", help="stream a TUM sequence to the node")
    c.add_argument("sequence", help="TUM sequence directory")
    c.add_argument("--connect", default="127.0.0.1:7007")
    c.add_argument("--frames", type=int, default=0, help="limit (0=all)")
    c.add_argument("--depth-factor", type=float, default=5000.0)
    c.add_argument("--save-map", default=None)
    c.set_defaults(fn=camera)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
