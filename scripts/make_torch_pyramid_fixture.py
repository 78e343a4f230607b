"""Build the fixture that `chip_smoke.py` phase 3 holds the port's image
pyramid against on the card.

The JAX package's jitted `build_pyramid` (8 levels, factor 1.2, as every
preset's ORB extractor calls it) on the first frame of
dr_slam_torch/data/smoke_corridor.npz (corridor frame 12, 640x480 uint8 gray
as float32), computed on the CPU. The fixture holds the 8 levels as float32
under "level_0" ... "level_7", about 4 MB.

Run from the repository root (a few seconds on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_pyramid_fixture.py

Writes dr_slam_torch/data/pyramid_corridor.npz."""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

N_LEVELS, SCALE = 8, 1.2


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "pyramid_corridor.npz"))
    args = ap.parse_args()

    from dr_slam_tpu.ops.image import build_pyramid

    with np.load(os.path.join(ROOT, "dr_slam_torch", "data",
                              "smoke_corridor.npz")) as fx:
        gray = fx["gray"][0].astype(np.float32)
    levels = build_pyramid(jnp.asarray(gray), n_levels=N_LEVELS, scale=SCALE)
    out = {f"level_{l}": np.asarray(x, np.float32)
           for l, x in enumerate(levels)}
    np.savez(args.out, **out)
    print(f"wrote {args.out}: "
          + ", ".join(f"{k} {v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
