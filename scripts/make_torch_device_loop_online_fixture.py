"""Build the fixture that tests/test_torch_device_loop_online.py drives the
port's `DeviceLoopTracker.loop_closing_epoch` with.

The scenario is the JAX package's online loop-closing test,
tests/test_device_loop.py::test_device_loop_online_loop_closing, run as
that test runs it: the small config (320x240, 4096 map points, 32
keyframes, 512 words) with keyframe culling off, 15 / 6 px match windows
and a loop consistency of 1; a circular trajectory of 120 frames and then
its first 40 again; a codebook trained on the sequence and registered; the
device loop's progressive drift injected at frame 70; and from frame 121 on
a loop-closing epoch every 12 frames until one fires.

The fixture holds, for the firing epoch, the carry before it
("in__map__<field>", "in__<field>", the layout of tests/torch_parity.py:
carry_arrays), the loop closer's state before it (consistency, last fire,
accepted loops), the carry after it ("out__...") and the loops accepted
by then ("out__loops_seq", insertion-sequence pairs), the trained codebook
("words"), the frame after which it fired and the epoch calls before it.

Run from the repository root (a minute or two on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_device_loop_online_fixture.py

Writes dr_slam_torch/data/device_loop_online.npz."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "device_loop_online.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.associate import vocabulary as voc
    from dr_slam_tpu.frontend.frame import extract_frame
    from dr_slam_tpu.io import synthetic
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker
    from dr_slam_tpu.slam.loop_closing import LoopCloser
    from tests.test_device_loop import _inject_device_drift
    from tests.test_tracking_e2e import small_cfg
    from torch_parity import carry_arrays

    cfg0 = small_cfg()
    cfg = cfg0.replace(tracking=dataclasses.replace(
        cfg0.tracking, run_kf_culling=False, motion_search_radius=15.0,
        local_search_radius=6.0, loop_consistency=1))
    poses = synthetic.loop_trajectory(120)
    poses = np.concatenate([poses, poses[:40]], 0)
    seq = synthetic.SyntheticSequence(poses, K4=cfg.camera.K4, height=240,
                                      width=320)
    descs = []
    for i in range(0, 120, 11):
        g_, d_ = seq.render(i)
        f_ = extract_frame(jnp.asarray(g_, jnp.float32),
                           jnp.asarray(d_, jnp.float32), cfg)
        descs.append(np.asarray(f_.kp.desc)[np.asarray(f_.kp.valid)])
    words = voc.train_vocabulary(np.concatenate(descs, 0),
                                 n_words=cfg.map.vocab_words, n_iters=6)
    voc.set_vocabulary(words)
    out = {"words": np.asarray(words, np.uint32)}
    try:
        tr = DeviceLoopTracker(cfg)
        tr._loop_closer = LoopCloser(
            cfg, consistency_needed=cfg.tracking.loop_consistency,
            gba_async=False)
        lc = tr._loop_closer
        epochs = 0
        for i in range(len(poses)):
            g, d = seq.render(i)
            tr.track(g, np.asarray(d), i / 30.0)
            if i == 70:
                _inject_device_drift(tr)
            if i > 120 and i % 12 == 0:
                before = carry_arrays(tr.carry, "in__")
                closer = {
                    "in__consistency": np.asarray(
                        sorted(lc._consistency.items()),
                        np.int64).reshape(-1, 2),
                    "in__last_fire_seq": np.int64(lc._last_fire_seq),
                    "in__loops_seq": np.asarray(
                        [(a, b) for a, b, _ in lc._accepted_loops],
                        np.int64).reshape(-1, 2),
                    "in__loops_T": np.asarray(
                        [T for _, _, T in lc._accepted_loops],
                        np.float32).reshape(-1, 4, 4)}
                fired = tr.loop_closing_epoch()
                print(f"frame {i}: epoch {epochs} fired {fired}", flush=True)
                if fired:
                    out.update(before)
                    out.update(closer)
                    out.update(carry_arrays(tr.carry, "out__"))
                    out["out__loops_seq"] = np.asarray(
                        [(a, b) for a, b, _ in lc._accepted_loops],
                        np.int64).reshape(-1, 2)
                    out["fire_frame"] = np.int64(i)
                    out["epochs_before"] = np.int64(epochs)
                    break
                epochs += 1
    finally:
        voc._trained_signs.clear()
    if "fire_frame" not in out:
        raise SystemExit("no epoch fired")
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
