"""Build the fixture that `chip_smoke.py` phase 13 holds the port's
reference behaviours against: the capacity wall at full width and the office
world with its relocalization, each run by the JAX package.

Six JAX runs, each with the port's two rules (tests/torch_parity.py): the
`System`'s deferred decision lags by exactly one frame
(`jax_system_lagged_by_one`), and each tracked rotation is projected onto
SO(3) (`projected_tracked_pose`).

- "wall_": `System` at `tum_freiburg3()` (640x480, 1024 keypoints, 32768
  map points) under tests/test_long_run.py's keyframe policy
  (`_smoke.wall_cfg`: 12 slots, a keyframe forced every 4 frames) with the
  keyframe culling pass off, over `_smoke.WALL640_FRAMES` frames of the
  corridor at 2 cm per frame. With culling on, the wall comes only at call
  70 at this width ("cev_").
- "dl_": the `DeviceLoopTracker` over the same frames, with the shipped
  codebooks registered (as the `System` registers them).
- "cev_": the forced evictions of the same `System` with the culling pass
  on, over `CULLING_FRAMES` frames.
- "lrev_", "lrdlev_": the forced evictions of the same two trackers over
  tests/test_long_run.py's own run (320x240, 70 frames, culling on).
- "office_": `System` over tests/test_transfer_validation.py's office world
  at its own size (320x240, fx 262): 40 frames, three black frames, then
  frame 20 again until it relocalizes (`_smoke.office_run`). Its frames
  are stored as a TUM camera gives them (gray uint8, depth uint16 at the
  depth factor), JAX's renders rounded, and the run is fed those, so the
  port can be held to it on the same inputs anywhere; the true poses too.

Per call it stores what `_smoke.BehaviourRecorder` records (state code,
keyframes inserted, reference keyframe, every slot's insertion sequence,
T_cw, inliers, live points). The device loop stores its records and the
live keyframe count before each step. Before every forced eviction ("ev_"
for the `System`, "dlev_" for the device loop) it stores the map state
compressed to the fields `cull_one_keyframe` reads (`_smoke.CULL_FIELDS`)
and the slot JAX evicted.

Run from the repository root (several minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_behaviours_fixture.py

Writes dr_slam_torch/data/behaviours.npz."""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

import numpy as np  # noqa: E402

# With the culling pass on, the 640x480 wall run keeps 8-10 of the 12 slots
# live to call 69 and first forces an eviction at call 73; 90 frames hold six.
CULLING_FRAMES = 90


def _evictions(events: list, prefix: str) -> dict:
    """Stack (call, input fields, evicted slot) per forced eviction."""
    from dr_slam_torch._smoke import CULL_FIELDS

    out = {f"{prefix}call": np.asarray([e[0] for e in events], np.int32),
           f"{prefix}slot": np.asarray([e[2] for e in events], np.int32)}
    for f in CULL_FIELDS:
        out[f"{prefix}{f}"] = np.stack([e[1][f] for e in events])
    return out


def _cull_fields(st) -> dict:
    from dr_slam_torch._smoke import CULL_FIELDS

    return {f: np.array(getattr(st, f)) for f in CULL_FIELDS}


def wall_run(cfg, frames, prefix: str = "wall_",
             ev_prefix: str = "ev_") -> dict:
    """The JAX `System` over the wall frames, recording each forced
    eviction's input and the slot it freed."""
    from dr_slam_tpu.slam import map_ops as jm
    from dr_slam_tpu.slam.system import System
    from dr_slam_torch import _smoke
    from torch_parity import jax_system_lagged_by_one

    cull, events, call = jm.cull_one_keyframe, [], [0]

    def recording(state, *a, force=False, **kw):
        if not force:
            return cull(state, *a, force=force, **kw)
        before = _cull_fields(state)
        out = cull(state, *a, force=force, **kw)
        freed = np.nonzero(before["kf_valid"] & ~np.asarray(out.kf_valid))[0]
        events.append((call[0], before, int(freed[0]) if len(freed) else -1))
        return out

    jm.cull_one_keyframe = recording
    try:
        with jax_system_lagged_by_one():
            rec = _smoke.BehaviourRecorder(System(cfg,
                                                  enable_loop_closing=False))
            for i, (g, d) in enumerate(frames):
                call[0] = i
                rec.track(g, d, i / 30.0)
    finally:
        jm.cull_one_keyframe = cull
    out = rec.arrays(prefix)
    out.update(_evictions(events, ev_prefix))
    return out


def device_loop_run(cfg, frames, prefix: str = "dl_",
                    ev_prefix: str = "dlev_") -> dict:
    """The JAX `DeviceLoopTracker` over the wall frames. A wall step is one
    that starts with every slot but one live and inserts a keyframe; the
    slot it freed is the live slot whose insertion sequence changed."""
    from dr_slam_tpu.slam import map_ops as jm
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker

    nk = cfg.map.max_keyframes
    jt = DeviceLoopTracker(cfg)
    n_before, events = [], []
    for i, (g, d) in enumerate(frames):
        st = jt.carry.map_state
        before = _cull_fields(st)
        n_before.append(int(before["kf_valid"].sum()))
        rec = np.asarray(jt.track(g, d, i / 30.0))
        if n_before[-1] >= nk - 1 and rec[19] > 0.5:
            seq = np.asarray(jt.carry.map_state.kf_seq)
            freed = np.nonzero(before["kf_valid"]
                               & (seq != before["kf_seq"]))[0]
            # JAX's own choice from the same fields, outside the jitted step
            direct = jm.cull_one_keyframe(_with_fields(cfg, before),
                                          force=True)
            slot = int(np.nonzero(before["kf_valid"]
                                  & ~np.asarray(direct.kf_valid))[0][0])
            assert list(freed) == [slot], (i, freed, slot)
            events.append((i, before, slot))
    f = jt.flush()
    out = {f"{prefix}records": f["records"],
           f"{prefix}n_kfs_before": np.asarray(n_before, np.int32),
           f"{prefix}n_keyframes": np.int32(f["n_keyframes"])}
    out.update(_evictions(events, ev_prefix))
    return out


def _with_fields(cfg, fields: dict):
    """An empty JAX map state of `cfg` with the fields of `fields`."""
    import jax.numpy as jnp

    from dr_slam_tpu.slam.state import make_empty_state

    st = make_empty_state(cfg)
    return st._replace(**{k: jnp.asarray(v) for k, v in fields.items()},
                       n_kfs=jnp.asarray(int(fields["kf_valid"].sum()),
                                         jnp.int32))


def office_frames(cfg, seq) -> dict:
    """JAX's renders of the office frames as a TUM camera gives them: gray
    rounded to uint8, depth to uint16 at the depth factor (the runs are fed
    these, `_smoke.office_fixture_frames`), with the true poses."""
    gray, depth = zip(*(seq.render(i) for i in range(len(seq.poses_cw))))
    return {"office_gray": np.clip(np.rint(np.asarray(gray)), 0,
                                   255).astype(np.uint8),
            "office_depth": np.rint(np.asarray(depth)
                                    * cfg.camera.depth_factor
                                    ).astype(np.uint16),
            "office_poses_cw": np.asarray(seq.poses_cw, np.float32)}


def office_run(cfg, frames: dict) -> dict:
    from dr_slam_tpu.slam.system import System
    from dr_slam_torch import _smoke
    from torch_parity import jax_system_lagged_by_one

    render, black = _smoke.office_fixture_frames(frames)
    with jax_system_lagged_by_one():
        out = _smoke.office_run(System(cfg, enable_loop_closing=False),
                                render, black)
    return {f"office_{k}": v for k, v in out.items()}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "behaviours.npz"))
    args = ap.parse_args()

    import jax

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_torch import _smoke
    from torch_parity import (jax_office_sequence, jax_wall_sequence,
                              numpy_frames, projected_tracked_pose,
                              shipped_codebooks, small_cfg)

    jax.config.update("jax_default_matmul_precision", "float32")
    cfg = _smoke.wall_cfg(tum_freiburg3(), culling=False)
    frames = numpy_frames(jax_wall_sequence(cfg, _smoke.WALL640_FRAMES),
                          _smoke.WALL640_FRAMES)
    lcfg = _smoke.wall_cfg(small_cfg())
    lframes = numpy_frames(jax_wall_sequence(lcfg, _smoke.WALL_FRAMES),
                           _smoke.WALL_FRAMES)
    out = {}
    with projected_tracked_pose():
        t0 = time.perf_counter()
        out.update(wall_run(cfg, frames))
        print(f"wall: {time.perf_counter() - t0:.1f} s, forced evictions at "
              f"calls {out['ev_call'].tolist()}, slots "
              f"{out['ev_slot'].tolist()}", flush=True)
        t0 = time.perf_counter()
        with shipped_codebooks():
            out.update(device_loop_run(cfg, frames))
        print(f"device loop: {time.perf_counter() - t0:.1f} s, wall steps "
              f"{out['dlev_call'].tolist()}, slots "
              f"{out['dlev_slot'].tolist()}", flush=True)
        t0 = time.perf_counter()
        ccfg = _smoke.wall_cfg(tum_freiburg3())
        culled = wall_run(ccfg, numpy_frames(
            jax_wall_sequence(ccfg, CULLING_FRAMES), CULLING_FRAMES),
            "cw_", "cev_")
        out.update({k: v for k, v in culled.items() if k.startswith("cev_")})
        live = (culled["cw_kf_seq"] >= 0).sum(axis=1)
        print(f"wall with culling: {time.perf_counter() - t0:.1f} s, live "
              f"slots per call {live.tolist()}, forced evictions at calls "
              f"{out['cev_call'].tolist()}, slots "
              f"{out['cev_slot'].tolist()}", flush=True)
        t0 = time.perf_counter()
        long_run = wall_run(lcfg, lframes, "lr_", "lrev_")
        with shipped_codebooks():
            long_run.update(device_loop_run(lcfg, lframes, "lrdl_",
                                            "lrdlev_"))
        out.update({k: v for k, v in long_run.items()
                    if k.startswith(("lrev_", "lrdlev_"))})
        print(f"long run: {time.perf_counter() - t0:.1f} s, forced evictions "
              f"at calls {out['lrev_call'].tolist()}, device loop wall steps "
              f"{out['lrdlev_call'].tolist()}", flush=True)
        t0 = time.perf_counter()
        ocfg = _smoke.office_cfg(small_cfg())
        out.update(office_frames(ocfg, jax_office_sequence()))
        out.update(office_run(ocfg, out))
        print(f"office: {time.perf_counter() - t0:.1f} s, states "
              f"{out['office_state'].tolist()}", flush=True)
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.2f} MB)",
          flush=True)


if __name__ == "__main__":
    main()
