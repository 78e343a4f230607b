"""Build the fixture that tests/test_torch_loop_closing.py and
`chip_smoke.py` phase 6 drive the port's `LoopCloser` with.

The scenario is the JAX package's loop test, tests/test_loop_closure.py, run
as that test runs it: the small config (320x240, 4096 map points, 32
keyframes, 512 words) with keyframe culling off, 15 / 6 px match windows and
a loop consistency of 1; a circular trajectory of 200 frames and then its
first 70 again; a codebook trained on the sequence and registered; a
`System` with loop closing on; progressive drift injected at frame 120.
`System.__init__` registers the shipped vocab512.npz over the trained
codebook, so the run uses the shipped one: the fixture stores the codebook
in effect.

Every call of `LoopCloser.process` is watched. The run stops after the
first call that corrects the map. The fixture holds, for that call
("fire__") and for the call just before it ("prev__"), the inputs (the map
state under "<call>map__<field>", the current keyframe, the odometry table
as arrays, the closer's `_consistency`, `_last_fire_seq` and
`_accepted_loops`) and the outputs (the flag, the closer's state after the
call, and for the firing call the corrected map under "fire__out__").
"gba__" holds the global bundle adjustment that `System` then dispatches,
resolved blocking on the corrected map.

Run from the repository root (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_loop_fixture.py

Writes dr_slam_torch/data/loop_small.npz."""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


class _Fired(Exception):
    pass


def loop_cfg():
    """tests/test_loop_closure.py's configuration."""
    from dr_slam_tpu.config import (CameraConfig, LineConfig, MapConfig,
                                    ORBConfig, SlamConfig)
    cfg0 = SlamConfig(
        camera=CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                            width=320, height=240, bf=20.0),
        orb=ORBConfig(n_features=400, n_levels=4, max_keypoints=512),
        line=LineConfig(max_lines=32),
        map=MapConfig(max_points=4096, max_lines=512, max_planes=32,
                      max_keyframes=32, vocab_words=512))
    return cfg0.replace(tracking=dataclasses.replace(
        cfg0.tracking, run_kf_culling=False, motion_search_radius=15.0,
        local_search_radius=6.0, loop_consistency=1))


def _closer_arrays(lc, prefix: str) -> dict:
    cons = sorted(lc._consistency.items())
    loops = lc._accepted_loops
    return {
        f"{prefix}consistency": np.asarray(cons, np.int64).reshape(-1, 2),
        f"{prefix}last_fire_seq": np.int64(lc._last_fire_seq),
        f"{prefix}loops_seq": np.asarray([(a, b) for a, b, _ in loops],
                                         np.int64).reshape(-1, 2),
        f"{prefix}loops_T": np.asarray([T for _, _, T in loops],
                                       np.float32).reshape(-1, 4, 4),
    }


def _call_inputs(lc, state, cur_kf, odom, prefix: str) -> dict:
    out = {f"{prefix}map__{k}": np.asarray(v)
           for k, v in state._asdict().items()}
    items = sorted(odom.items())
    out[f"{prefix}cur_kf"] = np.int64(cur_kf)
    out[f"{prefix}odom_seq"] = np.asarray([s for s, _ in items], np.int64)
    out[f"{prefix}odom_prev"] = np.asarray([r[0] for _, r in items], np.int64)
    out[f"{prefix}odom_T"] = np.asarray([r[1] for _, r in items],
                                        np.float64).reshape(-1, 4, 4)
    out.update(_closer_arrays(lc, f"{prefix}in__"))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "dr_slam_torch", "data", "loop_small.npz"))
    args = ap.parse_args()
    # the precision tests/conftest.py sets for the JAX package's tests
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.associate import vocabulary as voc
    from dr_slam_tpu.frontend.frame import extract_frame
    from dr_slam_tpu.io import synthetic
    from dr_slam_tpu.io.drift import inject_progressive_drift
    from dr_slam_tpu.slam import loop_closing
    from dr_slam_tpu.slam.system import System

    cfg = loop_cfg()
    poses = synthetic.loop_trajectory(200)
    poses = np.concatenate([poses, poses[:70]], 0)
    seq = synthetic.SyntheticSequence(poses, K4=cfg.camera.K4,
                                      height=240, width=320)
    descs = []
    for i in range(0, 200, 13):
        g_, d_ = seq.render(i)
        f_ = extract_frame(jnp.asarray(g_, jnp.float32),
                           jnp.asarray(d_, jnp.float32), cfg)
        descs.append(np.asarray(f_.kp.desc)[np.asarray(f_.kp.valid)])
    voc.set_vocabulary(voc.train_vocabulary(
        np.concatenate(descs, 0), n_words=cfg.map.vocab_words, n_iters=6))

    out = {}
    calls = {"n": 0, "prev": None}
    orig = loop_closing.LoopCloser.process

    def watched(self, state, cur_kf, odom=None):
        snap = _call_inputs(self, state, cur_kf, odom or {}, "")
        new_state, corrected = orig(self, state, cur_kf, odom)
        calls["n"] += 1
        print(f"  process #{calls['n']}: kf {cur_kf} corrected {corrected} "
              f"consistency {self._consistency}", flush=True)
        snap.update(_closer_arrays(self, "after__"))
        snap["corrected"] = np.bool_(corrected)
        if not corrected:
            calls["prev"] = snap
            return new_state, corrected
        out.update({f"fire__{k}": v for k, v in snap.items()})
        out.update({f"fire__out__{k}": np.asarray(v)
                    for k, v in new_state._asdict().items()})
        if calls["prev"] is not None:
            out.update({f"prev__{k}": v for k, v in calls["prev"].items()})
        gba = loop_closing.LoopCloser(cfg)
        gba.dispatch_gba(new_state, guard_gen=0)
        merged = gba.resolve_gba(new_state, guard_gen=0, block=True)
        for k in ("kf_pose", "pt_pos", "pl_coef", "ln_ep"):
            out[f"gba__{k}"] = np.asarray(getattr(merged, k))
        raise _Fired

    loop_closing.LoopCloser.process = watched
    sysm = System(cfg, enable_loop_closing=True)
    out["codebook_signs"] = voc.get_codebook_signs(cfg.map.vocab_words)
    frame = -1
    try:
        for i in range(len(poses)):
            frame = i
            gray, depth = seq.render(i)
            r = sysm.track_rgbd(gray, np.asarray(depth), i / 30.0)
            if i % 10 == 0:
                print(f"frame {i}: {r.state.name} keyframes "
                      f"{len(sysm.tracker.kf_log)}", flush=True)
            if i == 120:
                inject_progressive_drift(sysm.tracker)
    except _Fired:
        print(f"loop closed at frame {frame}", flush=True)
    finally:
        loop_closing.LoopCloser.process = orig
        voc._trained_signs.clear()
    if "fire__corrected" not in out:
        raise SystemExit("the loop never closed")
    out["fire_frame"] = np.int64(frame)
    out["process_calls"] = np.int64(calls["n"])
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
