"""The controls of the correctness check: runs that have to come out as not
correct, for setting and proving the limits in `limits/<cell>.json`. The
benchmark's own runs never run them.

    python3 slam_bench/control.py --workload CELL --seeds N [N ...]
        (--seconds S | --fixed-frames N [--paths P ...])

For each seed, one run of the cell (as `run.py` makes it) and then, on
that run's own true poses, the reference put in the program's place at
lower precision: the true poses in the map's frame rounded to TF32 (10
explicit mantissa bits) and to bfloat16, judged by the same arithmetic as
the program's poses. (Rounding the result is the least error a computation
in that precision could make, so these readings are the controls' lowest.)
In localization mode, the saved map rounded to the same precision against
the map saved. And the faults, planted in the true poses put in the
program's place (`fault_readings`). `--fixed-frames N --paths P [P ...]`
instead runs the program over the seed's first N frames once per path: as
the configuration states (`f32`), with TF32 allowed (`tf32`), with its
matrix products and convolutions on bfloat16 operands (`bf16`,
`Bf16Operands`), and prints how far the poses part and each path's
readings (`fixed_frame_runs`).
Prints one JSON line per seed: the program's readings and each control's."""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from slam_bench import reference, run  # noqa: E402


def round_mantissa(x: np.ndarray, bits: int) -> np.ndarray:
    """float32 values rounded to nearest-even with `bits` explicit mantissa
    bits (7: bfloat16, 10: TF32)."""
    a = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    drop = 23 - bits
    half = (1 << (drop - 1)) - 1 + ((a >> drop) & 1)
    r = ((a + half) >> drop) << drop
    return (r.astype(np.uint32)).view(np.float32).astype(np.float64)


def _readings(keep: dict, frames_in, kf_in) -> dict:
    """The check's numbers with frames_in (N, 4, 4) and kf_in (K, 4, 4) in
    the program's place."""
    out = reference.frame_readings(frames_in, keep["true"])
    if "kf_frame" in keep:
        out = reference.with_keyframes(out, kf_in,
                                       keep["true_all"][keep["kf_frame"]])
    return out


def _true_kf(keep: dict):
    return keep["true_all"][keep["kf_frame"]] if "kf_frame" in keep else None


def fault_readings(keep: dict) -> dict:
    """The check's numbers with the faults planted in the reference put in
    the program's place: `stale`, every frame handed the pose the system
    had before the window (a step that returns its state unchanged);
    `moved`, one frame's
    pose, and one keyframe's, altered by 5 cm where it is produced."""
    true, kf = keep["true"], _true_kf(keep)
    stale = np.repeat(true[:1], len(true), axis=0)
    moved = true.copy()
    moved[len(true) // 2, :3, 3] += [0.05, 0.0, 0.0]
    kf_moved = None
    if kf is not None:
        kf_moved = kf.copy()
        kf_moved[len(kf) // 2, :3, 3] += [0.05, 0.0, 0.0]
    return {"stale": _readings(keep, stale, kf),
            "moved": _readings(keep, moved, kf_moved)}


def lowered_readings(keep: dict, bits: int) -> dict:
    """The numbers the check compares, with the true poses rounded to
    `bits` mantissa bits in the program's place."""
    kf = _true_kf(keep)
    out = _readings(keep, round_mantissa(keep["true"], bits),
                    None if kf is None else round_mantissa(kf, bits))
    if "saved_map" in keep:
        saved = keep["saved_map"]
        low = {k: (round_mantissa(v, bits).astype(np.float32)
                   if v.dtype == np.float32 else v) for k, v in saved.items()}
        out["map_diff"] = reference.map_diff(saved, low)
    return out


class TF32:
    """Context manager: TF32 allowed for matrix products and convolutions
    while open (the program turns it off at import)."""

    def __enter__(self):
        self._set(True)
        return self

    def __exit__(self, *exc):
        self._set(False)
        return False

    @staticmethod
    def _set(on: bool) -> None:
        torch.backends.cuda.matmul.allow_tf32 = on
        torch.backends.cudnn.allow_tf32 = on


def _bf16(x):
    if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
        return x.to(torch.bfloat16).to(torch.float32)
    return x


class Bf16Operands:
    """Context manager: while open, the program's matrix products, einsums
    and convolutions take their float32 operands rounded to bfloat16 and
    accumulate in float32, as bfloat16 tensor cores compute. (Autocast
    to bfloat16 would do the same, but hands bfloat16 tensors on to code
    that mixes them with float32, and the program raises.)"""

    PATCHED = [(torch, "matmul"), (torch, "mm"), (torch, "bmm"),
               (torch, "einsum"), (torch.Tensor, "__matmul__"),
               (torch.Tensor, "__rmatmul__"),
               (torch.nn.functional, "conv2d")]

    def __enter__(self):
        self._orig = [getattr(owner, name) for owner, name in self.PATCHED]
        for (owner, name), fn in zip(self.PATCHED, self._orig):
            def lowered(*args, _fn=fn, **kw):
                args = [[_bf16(a) for a in x] if isinstance(x, (list, tuple))
                        else _bf16(x) for x in args]
                return _fn(*args, **{k: _bf16(v) for k, v in kw.items()})
            setattr(owner, name, lowered)
        return self

    def __exit__(self, *exc):
        for (owner, name), fn in zip(self.PATCHED, self._orig):
            setattr(owner, name, fn)
        return False


PATHS = {"f32": contextlib.nullcontext, "tf32": TF32,
         "bf16": Bf16Operands}


def fixed_frame_runs(cell: dict, seed: int, n: int, paths=("f32", "tf32"),
                     device="cuda") -> dict:
    """Runs of the program over the cell's first `n` frames of the seed (a
    run's warm-up and window: the window hands its frames in one after
    another at any speed under the camera's rate), one per entry of
    `paths` (`PATHS`: as the configuration states, TF32 allowed, bfloat16
    operands): how far each run's poses part from the first run's, and
    each run's readings against the true path."""
    from dr_slam_torch.slam.system import System

    conf, mix = cell["config"], cell["traffic"]
    if conf["mode"] != "slam":
        raise SystemExit("the fixed-frame runs drive the mapping System")
    dev = torch.device(device)
    cfg = run.make_config(conf)
    rate, warm = float(mix["rate_hz"]), int(mix["warm_frames"])
    if n <= warm:
        raise SystemExit(f"the fixed-frame runs need more than the "
                         f"warm-up's {warm} frames")
    poses, anchor, _, gray, depth = run.cell_frames(cell, cfg, seed, n, dev)
    true = reference.in_map_frame(poses, anchor)
    runs = {}
    for i, path in enumerate(paths):
        with PATHS[path]():
            system = System(cfg, enable_loop_closing=bool(
                conf["loop_closing"]), device=dev)
            est = np.empty((n, 4, 4))
            for g in range(n):
                gr, de = run.frames.decode(gray[g], depth[g],
                                           cfg.camera.depth_factor)
                est[g] = run._host_pose(
                    system.track_rgbd(gr, de, g / rate).T_cw)
            system.tracker.flush()
            kf_frame, kf_est = run.keyframe_poses(system.tracker, rate)
            system.shutdown()
        r = reference.frame_readings(est[warm - 1:], true[warm - 1:])
        runs[f"{i}_{path}"] = {
            "est": est, "kf_frame": kf_frame, "kf_est": kf_est,
            "readings": reference.with_keyframes(r, kf_est, true[kf_frame])}
    base = next(iter(runs.values()))
    out = {}
    for label, r in runs.items():
        same_kf = np.array_equal(r["kf_frame"], base["kf_frame"])
        out[label] = {
            "frames_differing": int(np.count_nonzero(
                (r["est"] != base["est"]).any(axis=(1, 2)))),
            "first_differing": next((int(i) for i in range(n) if (
                r["est"][i] != base["est"][i]).any()), None),
            "pose_max_abs": float(np.abs(r["est"] - base["est"]).max()),
            "centre_max_mm": float(np.abs(
                reference.centres(r["est"])
                - reference.centres(base["est"])).max() * 1e3),
            "kf_same_frames": bool(same_kf),
            "kf_max_abs": (float(np.abs(r["kf_est"] - base["kf_est"]).max())
                           if same_kf else None),
            "readings": r["readings"],
            "correct": reference.judge(r["readings"], cell["limits"])[0]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float,
                    help="the window of each run with the faults")
    ap.add_argument("--fixed-frames", type=int, default=0,
                    help="instead: fixed_frame_runs over this many frames")
    ap.add_argument("--paths", nargs="+", default=["f32", "tf32"],
                    choices=sorted(PATHS))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = run.load_cell(args.workload)
    if args.fixed_frames:
        for seed in args.seeds:
            line = fixed_frame_runs(cell, seed, args.fixed_frames,
                                    args.paths, args.device)
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "frames": args.fixed_frames, **line}),
                  flush=True)
        return 0
    if not args.seconds:
        ap.error("--seconds or --fixed-frames is needed")
    for seed in args.seeds:
        keep = {}
        out = run.run_cell(cell, seed, args.seconds, False,
                           device=args.device, keep=keep)
        line = {"workload": args.workload, "seed": seed,
                "correct": out["correct"], "failed": out["failed"],
                "program": keep["readings"],
                "tf32": lowered_readings(keep, 10),
                "bf16": lowered_readings(keep, 7),
                **fault_readings(keep)}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
