"""The device-loop leg of bench_torch.py on the card, fed the port's corridor
renders made on the CPU and made on the card, against the JAX run in
dr_slam_torch/data/bench_runs.npz (`chip_smoke.py` phase 14c's hold): for
each, the inliers on `_smoke.BENCH_PYRAMID_FRAMES` (frame, port, JAX) and
the largest relative inlier gap with its frame; and, on those frames, how
many pixels of the quantised renders (uint8 gray, uint16 depth units) differ
between the two devices.

    python scripts/device_loop_renders_torch.py [--frames 48] [--warm 25]

Needs a card; prints one JSON line (about 2 minutes on an H100)."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--warm", type=int, default=25)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    import bench_torch
    from dr_slam_torch import _smoke
    from dr_slam_torch.config import tum_freiburg3

    if not torch.cuda.is_available():
        raise SystemExit("needs a GPU: torch.cuda.is_available() is false")
    cfg = tum_freiburg3()
    n, df = args.frames, cfg.camera.depth_factor
    renders = {}
    for dev in ("cpu", "cuda"):
        seq = bench_torch._sequence(cfg, n, torch.device(dev))
        renders[dev] = [tuple(x.cpu().numpy() for x in seq.render(i))
                        for i in range(n)]
    want = _smoke.load_bench_fixture()["dl_records"][:n, 17]
    line = {"frames": n, "warm": args.warm, "renders_differ": {}}
    for f in _smoke.BENCH_PYRAMID_FRAMES:
        (gc, dc), (gg, dg) = (bench_torch._quantize(*renders[d][f], df)
                              for d in ("cpu", "cuda"))
        line["renders_differ"][int(f)] = {"gray_px": int((gc != gg).sum()),
                                         "depth_px": int((dc != dg).sum())}
    for dev in ("cpu", "cuda"):
        rec = bench_torch.bench_interactive_device(
            n, args.warm, cfg, "cuda", renders[dev]).record["records"]
        got = rec[:, 17]
        gaps = _smoke.count_gaps(got, want)
        line[f"{dev}_renders"] = {
            "inliers": [[int(f), int(got[f]), int(want[f])]
                        for f in _smoke.BENCH_PYRAMID_FRAMES],
            "max_gap": float(gaps.max()), "at": int(np.argmax(gaps))}
    line["card"] = _smoke.card_line()
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
