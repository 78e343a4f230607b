"""Build the fixture that `chip_smoke.py` phase 7 holds the port's
`DeviceLoopTracker` to: the JAX package's `DeviceLoopTracker` at full width.

The `tum_freiburg3()` preset (640x480), from an empty map, on the CPU, over
the 24 frames of dr_slam_torch/data/mapping_corridor.npz in camera-native
types (uint8 gray, uint16 depth sensor units), then 2 black frames, then
frames 6-11 again: a teleport back along the corridor. Frame n of the run
has the timestamp n / 30. The JAX package uses a seeded random codebook
where none is registered and the port its shipped one, so the shipped
dr_slam_tpu/data/vocab.npz (4096 words) is registered first.

The fixture holds the frame order ("frame", -1 for a black frame), the 32
records (REC_SIZE floats each: pose, state, counts, keyframe flag,
reference keyframe and its insertion sequence and pose, Manhattan flag,
frame id) and, after the run, the live keyframe, point, plane and line
counts. The frames themselves stay in mapping_corridor.npz.

Run from the repository root (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_device_loop_fixture.py

Writes dr_slam_torch/data/device_loop_corridor.npz."""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

ORDER = list(range(24)) + [-1, -1] + list(range(6, 12))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "device_loop_corridor.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.associate import vocabulary as voc
    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker

    cfg = tum_freiburg3()
    voc.load_vocabulary(os.path.join(ROOT, "dr_slam_tpu", "data", "vocab.npz"))
    with np.load(os.path.join(ROOT, "dr_slam_torch", "data",
                              "mapping_corridor.npz")) as fx:
        gray, depth = fx["gray"], fx["depth"]
    tr = DeviceLoopTracker(cfg)
    for n, i in enumerate(ORDER):
        g = gray[i] if i >= 0 else np.zeros_like(gray[0])
        d = depth[i] if i >= 0 else np.zeros_like(depth[0])
        tr.track(g, d, n / 30.0)
        r = np.asarray(tr._records[-1])
        print(f"step {n} (frame {i}): state {int(r[16])} n_inliers "
              f"{int(r[17])} n_matches {int(r[18])} kf {int(r[19])} ref "
              f"{int(r[20])}", flush=True)
    f = tr.flush()
    st = tr.map_state
    np.savez_compressed(
        args.out, frame=np.asarray(ORDER, np.int32), records=f["records"],
        n_keyframes=np.int32(f["n_keyframes"]), n_kfs=np.int32(st.n_kfs),
        n_pts=np.int32(st.n_pts), n_planes=np.int32(jnp.sum(st.pl_valid)),
        n_lines=np.int32(jnp.sum(st.ln_valid)))
    print(f"states {f['states']}; keyframes {f['n_keyframes']}, points "
          f"{int(st.n_pts)}")
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
