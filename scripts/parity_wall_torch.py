"""The capacity wall of tests/test_long_run.py:20-46 (12 keyframe slots, a
keyframe forced every 4 frames, 70 frames of the 2 cm corridor at 320x240)
in the port against the JAX package, on the CPU, on JAX's renders, with the
port's two rules on the JAX side (the deferred decision lagged by exactly
one frame, each tracked rotation projected onto SO(3);
tests/torch_parity.py).

Two runs of each package, from an empty map: the `System`s, then the
`DeviceLoopTracker`s (the shipped codebooks registered in both). For each
it prints the first call where the states, the keyframes, the reference
keyframes or any slot's insertion sequence differ (null: none) and the
largest |T_cw - T_cw_jax| entry before it and over the run. Then the
witness of the gap's cause: JAX's whole state just before that call (the
tracker's, or the loop's carry) goes into the port, which runs on to the
end; it prints the first call that differs after the carry. For the device
loop it also checks, on every step before the first difference, that the
live keyframe count is JAX's and that the port's wall branch (its second
readback) runs exactly where JAX's `sum(kf_valid)` test sends a wanted
keyframe into the wall. For the `System`s it prints tests/test_long_run.py's
acceptance too, on both runs from an empty map and on the carried port's:
no call LOST, ATE under 0.05 m, fewer live keyframes than slots, culling
having freed slots (the insertion sequence past the live count) and every
dead slot's observations cleared.

    JAX_PLATFORMS=cpu python scripts/parity_wall_torch.py [--threads 4]

Prints one JSON line; about 10 minutes at 4 threads on an idle 8-core
host."""

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

LONG_RUN_ATE_MAX = 0.05     # tests/test_long_run.py's bound


def _first(differ: dict) -> int | None:
    calls = [c for v in differ.values() for c in v]
    return min(calls) if calls else None


def _dT(a, b) -> float:
    return float(np.abs(a - b).max()) if len(a) else 0.0


def long_run_acceptance(system, poses_cw, states) -> dict:
    """tests/test_long_run.py's acceptance on a `System` of either package
    after the run: LOST calls (0), the ATE of its trajectory (< 0.05 m),
    the live keyframes (under the slots), the insertion sequence (over the
    live keyframes: culling freed slots) and whether every dead slot's
    observations are cleared."""
    from dr_slam_torch import _smoke
    from dr_slam_torch.io.metrics import ate_rmse

    st = system.tracker.map_state
    n_kfs, next_seq = int(_smoke._host(st.n_kfs)), int(
        _smoke._host(st.kf_next_seq))
    dead = ~_smoke._host(st.kf_valid).astype(bool)
    ate = ate_rmse(_smoke.centres([T for _, T in system.tracker.trajectory]),
                   _smoke.centres(poses_cw))
    out = {"lost": int((np.asarray(states) == 3).sum()), "ate_m": ate,
           "n_kfs": n_kfs, "kf_next_seq": next_seq,
           "dead_slots_cleared": bool((_smoke._host(st.kf_mp)[dead]
                                       == -1).all())}
    out["holds"] = (out["lost"] == 0 and ate < LONG_RUN_ATE_MAX
                    and n_kfs < _smoke.WALL_KEYFRAMES and next_seq > n_kfs
                    and out["dead_slots_cleared"])
    return out


def system_runs(cfg, frames, poses_cw) -> dict:
    """Both `System`s from an empty map, then the port from JAX's tracker
    just before the first call that differs, each with the long-run
    test's acceptance."""
    from dr_slam_torch import _smoke
    from dr_slam_torch.slam.system import System as TSystem
    from dr_slam_tpu.slam.system import System
    from torch_parity import (jax_system_lagged_by_one,
                              projected_tracked_pose, run_both_systems,
                              to_port, tracker_to_port)

    j, p, jsys, psys = run_both_systems(cfg, frames)
    gaps, _ = _smoke.behaviour_gaps(j, p)
    first = _first(gaps["differ"])
    out = {"first_difference": first, "dT_max": gaps["dT_max"],
           "dT_max_before": _dT(j["T_cw"][:first], p["T_cw"][:first]),
           "acceptance": long_run_acceptance(psys, poses_cw, p["state"]),
           "jax_acceptance": long_run_acceptance(jsys, poses_cw, j["state"])}
    if first is None:
        return out
    with projected_tracked_pose(), jax_system_lagged_by_one():
        js = System(cfg, enable_loop_closing=False)
        jrec = _smoke.BehaviourRecorder(js)
        for i in range(first):
            jrec.track(*frames[i], i / 30.0)
        ts = TSystem(to_port(cfg), enable_loop_closing=False, device="cpu")
        tracker_to_port(js.tracker, ts.tracker)
        prec = _smoke.BehaviourRecorder(ts)
        for i in range(first, len(frames)):
            jrec.track(*frames[i], i / 30.0)
            prec.track(*frames[i], i / 30.0)
    j2 = {k: v[first:] for k, v in jrec.arrays().items()}
    gaps, _ = _smoke.behaviour_gaps(j2, prec.arrays())
    after = _first(gaps["differ"])
    out["carried_after_call"] = first - 1
    out["carried_first_difference"] = None if after is None else first + after
    out["carried_dT_max"] = gaps["dT_max"]
    out["carried_acceptance"] = long_run_acceptance(
        ts, poses_cw, np.concatenate([j["state"][:first],
                                      prec.arrays()["state"]]))
    return out


def device_loop_runs(cfg, frames) -> dict:
    from dr_slam_torch._smoke import DEVICE_LOOP_EXACT
    from dr_slam_torch.slam.device_loop import DeviceLoopTracker
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker
    from torch_parity import (carry_arrays, carry_to_port,
                              projected_tracked_pose, shipped_codebooks,
                              to_port)

    nk = cfg.map.max_keyframes
    with shipped_codebooks(), projected_tracked_pose():
        jt, carries, jn = JTracker(cfg), [], []
        for i, (g, d) in enumerate(frames):
            carries.append(carry_arrays(jt.carry))
            jn.append(int(carries[-1]["map__kf_valid"].sum()))
            jt.track(g, d, i / 30.0)
        jrec = jt.flush()["records"]
        pt, pn = DeviceLoopTracker(to_port(cfg), device="cpu"), []
        for i, (g, d) in enumerate(frames):
            pn.append(int(pt.carry.map_state.kf_valid.sum()))
            pt.track(g, d, i / 30.0)
        prec = pt.flush()["records"]

        def differ(a, b, start=0):
            rows = [start + int(i) for k in DEVICE_LOOP_EXACT
                    for i in np.nonzero(a[:, k] != b[:, k])[0]]
            return min(rows) if rows else None

        first = differ(jrec, prec)
        upto = len(frames) if first is None else first
        wall = [int(jn[i] >= nk - 1 and jrec[i, 19] > 0.5)
                for i in range(upto)]
        out = {"first_difference": first,
               "dT_max": _dT(jrec[:, :16], prec[:, :16]),
               "dT_max_before": _dT(jrec[:upto, :16], prec[:upto, :16]),
               "wall_steps": [i for i in range(upto) if wall[i]],
               "n_kfs_before_equal": jn[:upto] == pn[:upto],
               "wall_branch_where_jax_hits_the_wall":
                   pt.readbacks[:upto] == [1 + w for w in wall]}
        if first is None:
            return out
        pt2 = DeviceLoopTracker(to_port(cfg), device="cpu")
        pt2.carry = carry_to_port(carries[first])
        pt2._initialized = True
        for i in range(first, len(frames)):
            pt2.track(*frames[i], i / 30.0)
        rec2 = pt2.flush()["records"]
        out["carried_before_step"] = first
        out["carried_first_difference"] = differ(jrec[first:], rec2, first)
        out["carried_dT_max"] = _dT(jrec[first:, :16], rec2[:, :16])
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)

    import torch

    from dr_slam_torch import _smoke
    from torch_parity import jax_wall_sequence, numpy_frames, small_cfg

    torch.set_num_threads(args.threads)
    n = _smoke.WALL_FRAMES
    cfg = _smoke.wall_cfg(small_cfg())
    seq = jax_wall_sequence(cfg, n)
    frames = numpy_frames(seq, n)
    t0 = time.perf_counter()
    line = {"frames": n, "system": system_runs(cfg, frames, seq.poses_cw),
            "device_loop": device_loop_runs(cfg, frames),
            "threads": args.threads}
    line["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
