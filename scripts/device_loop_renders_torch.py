"""The device-loop leg of bench_torch.py on the card, fed the port's corridor
renders made on the CPU and made on the card, against the JAX run in
dr_slam_torch/data/bench_runs.npz (`chip_smoke.py` phase 14c's hold): for
each, the inliers on frames 27, 30 and 33 (frame, port, JAX), where the
card's renders once moved the count 5%, and the largest relative inlier
gap with its frame; and how many float pixels of the two devices' renders
differ in their bits, and how many of the quantised ones (uint8 gray,
uint16 depth units) differ from the fixture's JAX renders.

    python scripts/device_loop_renders_torch.py [--frames 48] [--warm 25]

Needs a card; prints one JSON line (about 2 minutes on an H100)."""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHOWN = (27, 30, 33)


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
    data = _smoke.load_bench_fixture()
    want = data["dl_records"][:n, 17]
    line = {"frames": n, "warm": args.warm,
            "float_bits_differ": {"gray_px": 0, "depth_px": 0},
            "quantised_differ_from_jax": {"gray_px": 0, "depth_px": 0}}
    n_jax = min(n, len(data["frames_gray"]))
    for f in range(n):
        (gc, dc), (gg, dg) = renders["cpu"][f], renders["cuda"][f]
        line["float_bits_differ"]["gray_px"] += int(
            (gc.view(np.int32) != gg.view(np.int32)).sum())
        line["float_bits_differ"]["depth_px"] += int(
            (dc.view(np.int32) != dg.view(np.int32)).sum())
        if f < n_jax:
            g8, d16 = bench_torch._quantize(gg, dg, df)
            diff = line["quantised_differ_from_jax"]
            diff["gray_px"] += int((g8 != data["frames_gray"][f]).sum())
            diff["depth_px"] += int((d16 != data["frames_depth"][f]).sum())
    for dev in ("cpu", "cuda"):
        rec = bench_torch.bench_interactive_device(
            n, args.warm, cfg, "cuda", renders[dev]).record["records"]
        got = rec[:, 17]
        gaps = _smoke.count_gaps(got, want)
        line[f"{dev}_renders"] = {
            "inliers": [[f, int(got[f]), int(want[f])]
                        for f in SHOWN if f < n],
            "max_gap": float(gaps.max()), "at": int(np.argmax(gaps))}
    line["card"] = _smoke.card_line()
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
