"""Build the fixture that tests/test_torch_accuracy.py and `chip_smoke.py`
phase 12 hold the port's closed-loop accuracy protocol against.

It runs `main()` of scripts/bench_accuracy.py with two rules added, the
port's own: after each frame the JAX `System` waits for its pending
frames' bundles (tests/torch_parity.py: `jax_system_lagged_by_one`), so the
deferred decision lags by exactly one frame, as the port's does when each
frame is synchronised; and the tracked pose's rotation is projected onto
SO(3) after the second pose solve (`projected_tracked_pose` of
tests/torch_parity.py), as the port's `slam/track_step.py` does. The script itself, without either rule, runs
beside it in its own process; the fixture keeps its line too. The protocol: the loop configuration at 320x240, a
circular path of 200 frames and then its first 70 again, a codebook
trained on frames 0, 13, ..., 195 and registered, a `System` with loop
closing on, progressive drift injected after frame 120, the raw and the
loop-corrected trajectories scored by ATE. `System.__init__` registers the
shipped vocab512.npz over the trained codebook, so the run uses the
shipped one: the fixture stores both.

The fixture holds the 270 poses; per frame the state code, T_cw, the
reference keyframe, the keyframe flag and the inlier count; the keyframes'
frames; the loop events (frame, current keyframe slot, the accepted loop's
keyframe sequences); the raw and corrected trajectories; the script's
summary line, and the line of the script run without the two rules; and
both codebooks.

Run from the repository root (several minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_accuracy_fixture.py

Writes dr_slam_torch/data/accuracy_loop.npz."""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "accuracy_loop.npz"))
    args = ap.parse_args()

    from dr_slam_tpu.associate import vocabulary as voc
    from dr_slam_tpu.io import synthetic
    from dr_slam_torch._smoke import loop_events
    from torch_parity import (jax_system_lagged_by_one, load_script,
                              projected_tracked_pose)

    bench = load_script("bench_accuracy")
    registered = []
    set_vocabulary = voc.set_vocabulary

    def recording(words):
        registered.append(np.asarray(words))
        set_vocabulary(words)

    script = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "scripts", "bench_accuracy.py")],
        stdout=subprocess.PIPE, text=True)
    voc.set_vocabulary = recording
    line = io.StringIO()
    try:
        with jax_system_lagged_by_one() as calls, projected_tracked_pose(), \
                contextlib.redirect_stdout(line):
            bench.main()
    finally:
        voc.set_vocabulary = set_vocabulary
    summary = json.loads(line.getvalue().strip().splitlines()[-1])
    print(json.dumps(summary), flush=True)
    script_out, _ = script.communicate()
    assert script.returncode == 0, script.returncode
    summary_script = json.loads(script_out.strip().splitlines()[-1])
    print("scripts/bench_accuracy.py:", json.dumps(summary_script))

    res = [c[0] for c in calls]
    sysm = calls[-1][2]
    tr = sysm.tracker
    poses = synthetic.loop_trajectory(200)
    poses = np.concatenate([poses, poses[:70]], 0)
    events = loop_events(sysm.metrics.records)
    loops = sysm._loop_closer._accepted_loops if sysm._loop_closer else []
    assert len(loops) == len(events) == summary["loops_closed"], \
        (loops, events, summary)
    out = {
        "poses": poses.astype(np.float64),
        "state": np.asarray([r.state.value for r in res], np.int32),
        "T_cw": np.stack([np.asarray(r.T_cw, np.float32) for r in res]),
        "ref_kf": np.asarray([c[1] for c in calls], np.int32),
        "is_keyframe": np.asarray([r.is_keyframe for r in res]),
        "n_inliers": np.asarray([r.n_inliers for r in res], np.int32),
        "kf_frames": np.asarray([int(round(ts * 30.0)) for ts, _ in tr.kf_log],
                                np.int32),
        "loop_frame": np.asarray([f for f, _ in events], np.int32),
        "loop_kf": np.asarray([k for _, k in events], np.int32),
        "loop_seq": np.asarray([(a, b) for a, b, _ in loops],
                               np.int64).reshape(-1, 2),
        "traj_raw": np.stack([np.asarray(T, np.float32)
                              for _, T in tr.trajectory]),
        "traj_corrected": np.stack([np.asarray(T, np.float32)
                                    for _, T in tr.corrected_trajectory()]),
        "summary": np.asarray(json.dumps(summary)),
        "summary_script": np.asarray(json.dumps(summary_script)),
        "vocab_trained": registered[0],
        "vocab_in_effect": registered[-1],
        "codebook_signs": np.asarray(voc.get_codebook_signs(512)),
    }
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB); "
          f"loops at frames {out['loop_frame'].tolist()}, keyframe sequences "
          f"{out['loop_seq'].tolist()}", flush=True)


if __name__ == "__main__":
    main()
