#!/usr/bin/env python
"""Convert an official YOLOX .pth checkpoint into the detector's .npz layout
with the PyTorch port (the twin of scripts/convert_yolox.py; the output is
the same file, and loads in either package).

    python scripts/convert_yolox_torch.py yolox_s.pth yolox_s.npz
    python scripts/convert_yolox_torch.py yolox_m.pth yolox_m.npz --depth 0.67 --width 0.75

The output loads via dr_slam_torch.models.yolox.YOLOX(weights=<npz>). This is
the counterpart of the reference's TensorRT engine build (the reference
consumes an engine serialized from these same official checkpoints,
include/YOLOX.h:54)."""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("pth")
    ap.add_argument("npz")
    ap.add_argument("--depth", type=float, default=0.33,
                    help="depth multiplier (s=0.33, m=0.67, l=1.0)")
    ap.add_argument("--width", type=float, default=0.50,
                    help="width multiplier (s=0.50, m=0.75, l=1.0)")
    args = ap.parse_args(argv)

    from dr_slam_torch.models.yolox_convert import convert_checkpoint
    params = convert_checkpoint(args.pth, args.npz, args.depth, args.width)
    n = sum(v["w"].size + v["b"].size for k, v in params.items()
            if k != "meta")
    print(f"wrote {args.npz}: {len(params) - 1} modules, {n / 1e6:.2f}M params")
    return params


if __name__ == "__main__":
    main()
