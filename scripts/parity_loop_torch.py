"""The closed-loop accuracy protocol (scripts/bench_accuracy.py's) on the
port, fed JAX's renders, over all 270 frames against the JAX run in
dr_slam_torch/data/accuracy_loop.npz (JAX tracking with the port's pose
rule; scripts/make_torch_accuracy_fixture.py). The port runs on the CPU
through `_smoke.accuracy_run`, each frame synchronised; the sequence it
renders is swapped for JAX's renders of the same poses
(tests/torch_parity.py: `JaxRenders`), so the comparison holds the
tracking and not the renderer. tests/test_torch_accuracy.py holds the
first 125 frames in Tier-1; the loop closes at frame 190.

Prints one JSON line: the first frame where the states, the reference
keyframes, the keyframe flags, the keyframes' frames or the loops closed
differ (null: none), the largest |T_cw - T_cw_jax| entry, the frames over
3e-3 (each as [frame, gap, the port's inliers, JAX's]), and the ATE of
both runs.

    JAX_PLATFORMS=cpu python scripts/parity_loop_torch.py [--threads 4]

About 8 minutes at 4 threads on an idle 8-core host."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402


def first_difference(run, data, n: int) -> int | None:
    """The first frame where the port's run and the fixture's differ in
    state, reference keyframe, keyframe flag, keyframe insertion or loop
    closed; None if none does."""
    rec = run.records
    frames = [int(i) for k in ("state", "ref_kf", "is_keyframe")
              for i in np.nonzero(rec[k] != data[k][:n])[0]]
    kf_p = set(run.kf_frames)
    kf_j = {int(f) for f in data["kf_frames"] if f < n}
    frames += list(kf_p ^ kf_j)
    loops_p = {(f, k, tuple(s)) for f, k, s in run.loops}
    loops_j = {(int(f), int(k), tuple(int(x) for x in s)) for f, k, s in
               zip(data["loop_frame"], data["loop_kf"], data["loop_seq"])
               if f < n}
    frames += [f for f, _, _ in loops_p ^ loops_j]
    return min(frames) if frames else None


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from dr_slam_torch import _smoke
    from torch_parity import JaxRenders

    torch.set_num_threads(args.threads)
    data = _smoke.load_accuracy_fixture()
    n = len(data["state"])
    port_sequence = _smoke.accuracy_sequence
    _smoke.accuracy_sequence = JaxRenders
    t0 = time.perf_counter()
    try:
        run = _smoke.accuracy_run("cpu")
    finally:
        _smoke.accuracy_sequence = port_sequence
    seconds = time.perf_counter() - t0
    dT = np.abs(run.records["T_cw"] - data["T_cw"][:n]).max(axis=(1, 2))
    want = json.loads(str(data["summary"]))
    line = {"frames": n, "first_difference": first_difference(run, data, n),
            "dT_max": float(dT.max()), "dT_max_frame": int(dT.argmax()),
            "frames_over_3e-3": [
                [int(i), float(dT[i]), int(run.records["n_inliers"][i]),
                 int(data["n_inliers"][i])]
                for i in np.nonzero(dT > _smoke.TRACKER_T_TOL)[0]],
            "loops": [[f, k, list(s)] for f, k, s in run.loops],
            "lost": [int(i) for i in
                     np.nonzero(run.records["state"] == 3)[0]],
            "ate_rmse_m": run.summary["ate_rmse_m"],
            "jax_ate_rmse_m": want["ate_rmse_m"],
            "threads": args.threads, "seconds": round(seconds, 1)}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
