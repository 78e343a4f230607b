"""Where the legs of bench_torch.py part from the JAX package's runs in
dr_slam_torch/data/bench_runs.npz (made by
scripts/make_torch_bench_fixture.py), at full width (`tum_freiburg3()`,
640x480) on the CPU, and why.

1. Renders: the tracking leg (`System`, 60 frames) of the port on the
   port's own float renders of the corridor and on JAX's, against the JAX
   `System` on JAX's float renders, run here with the fixture's two rules
   (tests/torch_parity.py; bench.py's leg is fed float renders); and on
   the fixture's frames (JAX's renders as uint8 gray and uint16 depth)
   against the fixture's run on them. The device-loop leg over all its
   120 frames (25 warm; it quantises its frames as bench.py does) on the
   port's renders and on JAX's, against the fixture's run. For each: the
   exact records equal or not, the first frame where the run parts from
   JAX's (an exact field differs, T_cw beyond TRACKER_T_TOL or a count
   beyond TRACKER_COUNT_TOL; for the device loop also leaving aside the
   inliers of `_smoke.BENCH_PYRAMID_FRAMES`), the largest |T_cw -
   T_cw_jax| entry and the frames over the bound, the largest relative
   count gap and the frames over the bound, and the keyframes' frames.
2. The pyramid: the JAX `DeviceLoopTracker` on JAX's renders (quantised)
   with its own jitted pyramid, from an empty map over frames 0-34; its
   carry before step 27 goes into the port, which runs on to step 34 with
   its own pyramid, with JAX's jitted pyramid swapped in
   (tests/test_torch_fixture_parity.py's and tests/test_torch_bench.py's
   witness). For each: the frames whose inliers differ from JAX's and the
   largest T_cw gap.
3. The pyramid's rounding, on frames BENCH_PYRAMID_FRAMES of JAX's
   quantised renders: the largest gap of the JAX package's jitted pyramid
   (over its 8 levels and at level 1) from the port's, and from JAX's
   resize weights evaluated as XLA compiles them for the CPU (its HLO
   computes the sample position `(i + 0.5) * inv_scale - 0.5` as one fused
   multiply-add) with float32 contractions; and the port's gap from that.

    JAX_PLATFORMS=cpu python scripts/parity_bench_torch.py [--threads 4] \
        [--part all|renders|witness|rounding]

Prints one JSON line; about 9 minutes at 4 threads on an idle 8-core
host (the rounding part alone: seconds)."""

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

from dr_slam_torch._smoke import (DEVICE_LOOP_EXACT,  # noqa: E402
                                  TRACKER_COUNT_TOL, TRACKER_T_TOL,
                                  bench_inliers_held, count_gaps)

DEVICE_FRAMES, DEVICE_WARM = 120, 25
CARRY, LAST = 27, 34      # the witness: JAX's carry before step 27


def _first(mask):
    at = np.nonzero(mask)[0]
    return int(at[0]) if len(at) else None


def _gaps(T, want_T, counts, want_counts, exact, want_exact) -> dict:
    """T (n, 16), counts (n, k) and exact fields (n, m) against JAX's."""
    n = len(T)
    dT = np.abs(np.asarray(T).reshape(n, -1)
                - np.asarray(want_T).reshape(n, -1)).max(1)
    rel = count_gaps(counts, want_counts).reshape(n, -1).max(1)
    differ = (np.asarray(exact).reshape(n, -1)
              != np.asarray(want_exact).reshape(n, -1)).any(1)
    return {"exact_equal": not differ.any(),
            "first_apart": _first(differ | (dT > TRACKER_T_TOL)
                                  | (rel > TRACKER_COUNT_TOL)),
            "dT_max": float(dT.max()),
            "dT_over": np.nonzero(dT > TRACKER_T_TOL)[0].tolist(),
            "counts_rel_max": float(rel.max()),
            "counts_over": np.nonzero(rel > TRACKER_COUNT_TOL)[0].tolist()}


def jax_renders(cfg, n: int) -> list:
    """JAX's float renders of the corridor's first n frames."""
    from dr_slam_tpu.io import synthetic
    from torch_parity import numpy_frames

    return numpy_frames(synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(n), K4=cfg.camera.K4), n)


def _tracking_gaps(r: dict, want: dict) -> dict:
    keys = ("state", "is_keyframe", "ref_kf")
    out = _gaps(r["T_cw"], want["T_cw"],
                np.stack([r["n_inliers"], r["n_matches"]], 1),
                np.stack([want["n_inliers"], want["n_matches"]], 1),
                np.stack([r[k] for k in keys], 1),
                np.stack([want[k] for k in keys], 1))
    out["kf_frames"] = [r["kf_frames"].tolist(), want["kf_frames"].tolist()]
    return out


def _device_loop_gaps(rec, want) -> dict:
    cols = list(DEVICE_LOOP_EXACT)
    out = _gaps(rec[:, :16], want[:, :16], rec[:, 17:19], want[:, 17:19],
                rec[:, cols], want[:, cols])
    held = bench_inliers_held(len(rec))
    rel = np.where(held, count_gaps(rec[:, 17], want[:, 17]), 0.0)
    rel = np.maximum(rel, count_gaps(rec[:, 18], want[:, 18]))
    dT = np.abs(rec[:, :16] - want[:, :16]).max(1)
    out["first_apart_but_pyramid_frames"] = _first(
        (rec[:, cols] != want[:, cols]).any(1) | (dT > TRACKER_T_TOL)
        | (rel > TRACKER_COUNT_TOL))
    out["pyramid_frames_inliers"] = [
        [int(f), int(rec[f, 17]), int(want[f, 17])]
        for f in np.nonzero(~held)[0]]
    out["kf_frames"] = [np.nonzero(r[:, 19])[0].tolist()
                        for r in (rec, want)]
    return out


def render_gaps(data: dict, cfg, tcfg) -> dict:
    import bench_torch
    from dr_slam_torch import _smoke
    from dr_slam_torch.io import synthetic
    from torch_parity import load_script, projected_tracked_pose

    n = len(data["trk_state"])
    m = len(data["dl_records"])
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(m),
                                      K4=tcfg.camera.K4, device="cpu")
    own = [tuple(x.numpy() for x in seq.render(i)) for i in range(m)]
    theirs = jax_renders(cfg, m)
    with projected_tracked_pose():
        floats = load_script("make_torch_bench_fixture").jax_tracking_run(
            cfg, theirs[:n])
    stored = {k[4:]: v for k, v in data.items() if k.startswith("trk_")}
    out = {}
    for name, frames, want in (
            ("port_renders", own, floats), ("jax_renders", theirs, floats),
            ("fixture_frames", _smoke.bench_fixture_frames(
                data, tcfg.camera.depth_factor), stored)):
        t0 = time.perf_counter()
        out[name] = {"tracking": _tracking_gaps(bench_torch.bench_tracking(
            n, tcfg, "cpu", frames[:n]).record, want)}
        if name != "fixture_frames":
            rec = bench_torch.bench_interactive_device(
                DEVICE_FRAMES, DEVICE_WARM, tcfg, "cpu",
                frames[:DEVICE_FRAMES]).record["records"]
            out[name]["device_loop"] = _device_loop_gaps(
                rec, data["dl_records"][:DEVICE_FRAMES])
        out[name]["seconds"] = round(time.perf_counter() - t0, 1)
        print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def pyramid_witness(cfg, tcfg) -> dict:
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker
    from dr_slam_torch.ops import image as timage
    from dr_slam_torch.slam.device_loop import DeviceLoopTracker
    from torch_parity import (carry_arrays, carry_to_port, jax_pyramid,
                              projected_tracked_pose, shipped_codebooks)

    import bench_torch

    frames = [bench_torch._quantize(g, d, cfg.camera.depth_factor)
              for g, d in jax_renders(cfg, LAST + 1)]

    out = {}
    with shipped_codebooks(), projected_tracked_pose():
        jt = JTracker(cfg)
        for i, (g, d) in enumerate(frames):
            if i == CARRY:
                carried = carry_arrays(jt.carry)
            jt.track(g, d, i / 30.0)
        want = jt.flush()["records"][CARRY:]
        own = timage.build_pyramid
        for name, pyramid in (("port_pyramid", own),
                              ("jax_pyramid", jax_pyramid)):
            timage.build_pyramid = pyramid
            try:
                pt = DeviceLoopTracker(tcfg, device="cpu")
                pt.carry = carry_to_port(carried)
                pt._initialized = True
                for i in range(CARRY, LAST + 1):
                    pt.track(*frames[i], i / 30.0)
                got = pt.flush()["records"]
            finally:
                timage.build_pyramid = own
            out[name] = {
                "inliers_differ": [[CARRY + int(i), int(got[i, 17]),
                                    int(want[i, 17])] for i in
                                   np.nonzero(got[:, 17] != want[:, 17])[0]],
                "dT_max": float(np.abs(got[:, :16] - want[:, :16]).max())}
            print(f"{name}: {json.dumps(out[name])}", flush=True)
    return out


def fma_resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """jax.image.resize's bilinear weights along one axis with the sample
    position one fused multiply-add (the float32 product is exact in
    float64, so the float64 sum rounds once), as XLA compiles them for the
    CPU; float32 otherwise."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    recip = f32(1.0) / max(inv_scale, f32(1.0))
    centre = np.arange(n_out, dtype=f32) + f32(0.5)
    sample = (centre.astype(np.float64) * np.float64(inv_scale)
              - 0.5).astype(f32)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]) * recip
    w = np.maximum(f32(1.0) - x, f32(0.0))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def pyramid_rounding(cfg) -> dict:
    import jax.numpy as jnp
    import torch

    from dr_slam_torch._smoke import BENCH_PYRAMID_FRAMES
    from dr_slam_torch.ops import image as timage
    from dr_slam_tpu.ops import image as jimage

    import bench_torch

    def gap(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max())

    frames = jax_renders(cfg, max(BENCH_PYRAMID_FRAMES) + 1)
    out = {}
    for f in BENCH_PYRAMID_FRAMES:
        g = bench_torch._quantize(*frames[f], cfg.camera.depth_factor)[0]
        g = g.astype(np.float32)
        jax_levels = jimage.build_pyramid(jnp.asarray(g))
        port = timage.build_pyramid(torch.from_numpy(g))
        x, fma = g, [g]
        for oh, ow in jimage.pyramid_shapes(*g.shape, 8, 1.2)[1:]:
            x = (fma_resize_weights(x.shape[0], oh).T @ x
                 @ fma_resize_weights(x.shape[1], ow)).astype(np.float32)
            fma.append(x)
        out[int(f)] = {
            "jax_port": max(gap(a, b) for a, b in zip(jax_levels, port)),
            "jax_port_level1": gap(jax_levels[1], port[1]),
            "jax_fma": max(gap(a, b) for a, b in zip(jax_levels, fma)),
            "jax_fma_level1": gap(jax_levels[1], fma[1]),
            "port_fma": max(gap(a, b) for a, b in zip(port, fma))}
    print(f"rounding: {json.dumps(out)}", flush=True)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--part", default="all",
                    choices=("all", "renders", "witness", "rounding"))
    args = ap.parse_args(argv)

    import jax
    import torch

    from dr_slam_torch import _smoke
    from dr_slam_tpu.config import tum_freiburg3
    from torch_parity import to_port

    jax.config.update("jax_default_matmul_precision", "float32")
    torch.set_num_threads(args.threads)
    t0 = time.perf_counter()
    data = _smoke.load_bench_fixture()
    cfg = tum_freiburg3()
    line = {}
    if args.part in ("all", "renders"):
        line["renders"] = render_gaps(data, cfg, to_port(cfg))
    if args.part in ("all", "witness"):
        line["pyramid_from_jax_carry"] = pyramid_witness(cfg, to_port(cfg))
    if args.part in ("all", "rounding"):
        line["pyramid_rounding"] = pyramid_rounding(cfg)
    line["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
