"""The per-frame detector of `tum_freiburg3_yolox()` held to the plain
reference on the card, over the corridor frames of its cell
`tum3_yolox.corridor` (those of `tum3_slam.corridor`). The cell's
`correct` in `run.py` judges poses only, and detections never feed the
poses, so this script is what holds the detector to the reference.

    python3 slam_bench/detector_check.py --seeds N [N ...] [--frames 48]
        [--out PATH]

For each seed, the cell's corridor frames (`run.cell_frames`) go through
`System(tum_freiburg3_yolox())` as `run.py` hands them in, recording what
the timed path computed on the detector's stream: each frame's resized
input, head tensors and decoded rows, and the detections resolved.
Then, per frame:

- the head tensors and decoded rows against `yolox_reference.py` (plain
  `torch.nn.functional`, float32, TF32 off) on the same input and weights,
  within `TOL`; and, as the control, the same network with TF32 allowed,
  which has to fail at least one of them;
- the detections kept (`select` at the configuration's thresholds and at a
  threshold under the seeded network's scores, where boxes are kept) on the
  program's rows and on the reference's rows: equal wherever no score lies
  within the tolerance of the threshold or of another candidate's and no
  IoU of two candidates of one class lies within it of the IoU threshold;
- the detections the System resolved, one frame late, against `select` on
  that frame's decoded rows, bit for bit.

And the poses against `System(tum_freiburg3())` (the cell's program) on
the same frames, beside two runs of that program, the
run-to-run spread. Prints one JSON line per seed, writes every number,
each frame's too, to `--out`, and exits 1 where a check fails."""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import torch  # noqa: E402

from slam_bench import control, frames, run  # noqa: E402
from slam_bench import yolox_reference as plain  # noqa: E402

# the gaps allowed between the program and the reference: head tensors
# (absolute, in logits), decoded boxes (px at 640), scores. On an H100 over
# 96 frames of two seeds float32 reads at most 9.7e-8, 1.2e-4 px, 8.9e-8,
# and the network with TF32 allowed at least 7.9e-5, 5.1e-4 px, 9.3e-6
TOL = {"heads": 1e-6, "boxes_px": 2.5e-4, "scores": 1e-6}
# the low threshold: in the widest gap between two of a frame's best
# scores, from this many-th to that
LOW_RANKS = (16, 64)


def _system_run(cfg, cell, gray, depth, n, dev, record=None) -> np.ndarray:
    """Poses (n, 4, 4) of a System over the first n frames; `record`
    installs the detector's recording hooks on the System."""
    from dr_slam_torch.slam.system import System

    conf, mix = cell["config"], cell["traffic"]
    rate = float(mix["rate_hz"])
    system = System(cfg, enable_loop_closing=bool(conf["loop_closing"]),
                    device=dev)
    if record is not None:
        record(system)
    est = np.empty((n, 4, 4))
    for g in range(n):
        gr, de = frames.decode(gray[g], depth[g], cfg.camera.depth_factor)
        est[g] = run._host_pose(system.track_rgbd(gr, de, g / rate).T_cw)
    system.shutdown()
    return est


def _recorder(store: dict):
    """Hooks on the System's detector: each launch's input, heads and
    decoded rows, and each detection it resolves."""
    from dr_slam_torch.models import yolox

    decode = yolox.decode

    def install(system):
        det = system.detector
        store["det"] = det
        heads, resolve = det.heads, det.resolve

        def rec_heads(img):
            outs = heads(img)
            store["launch"].append({"img": img, "heads": outs})
            return outs

        def rec_decode(outs):
            rows = decode(outs)
            store["launch"][-1]["rows"] = rows
            return rows

        def rec_resolve(pending):
            out = resolve(pending)
            store["resolved"].append(out)
            return out

        det.heads, det.resolve = rec_heads, rec_resolve
        yolox.decode = rec_decode

        def restore():
            det.heads, det.resolve = heads, resolve
            yolox.decode = decode
        store["restore"] = restore

    store.update(launch=[], resolved=[])
    return install


def _gap(a, b) -> float:
    return float((a - b).abs().max())


def _head_gaps(got, want) -> dict:
    out = {}
    for k, part in enumerate(("reg", "obj", "cls")):
        out[part] = max(_gap(g[k], w[k]) for g, w in zip(got, want))
    out["heads"] = max(out.values())
    out["scale"] = max(float(w[k].abs().max()) for w in want for k in
                       range(3))
    return out


def _class_margin(outs) -> torch.Tensor:
    """Per decoded row, how far the best class probability leads the
    second."""
    p = torch.cat([torch.sigmoid(c[0].flatten(1).T) for _, _, c in outs])
    top2 = p.topk(2, 1).values
    return top2[:, 0] - top2[:, 1]


def _row_gaps(rows, ref, clear) -> dict:
    """The decoded rows' gaps; labels compared where the reference's best
    class leads the second by more than the score tolerance (`clear`)."""
    return {"boxes_px": _gap(rows[:, :4], ref[:, :4]),
            "scores": _gap(rows[:, 4], ref[:, 4]),
            "labels_differing": int((rows[clear, 5] != ref[clear, 5]).sum()),
            "labels_unclear": int((~clear).sum())}


def _margins(rows, lead, score_th: float, iou_th: float, yolox) -> dict:
    """How close the decisions of `select` on these rows come to turning:
    scores to the threshold, the last candidate's to the first left out,
    two candidates' that suppress one another, an IoU of two candidates of
    one class to the IoU threshold, and a candidate's best class to its
    second (`lead`)."""
    s = torch.where(rows[:, 4] >= score_th, rows[:, 4],
                    torch.zeros_like(rows[:, 4]))
    k = 4 * yolox.MAX_DET
    top, idx = torch.topk(s, k + 1)
    first_out = top[k]
    cand, top, idx = rows[idx[:k]], top[:k], idx[:k]
    alive = top > 0
    iou = yolox.iou_matrix(cand[:, :4])
    pair = (cand[:, None, 5] == cand[None, :, 5]) & alive[:, None] \
        & alive[None, :]
    pair.fill_diagonal_(False)
    out = {"score": float((rows[:, 4] - score_th).abs().min()),
           "boundary": (float(top[-1] - first_out) if bool(alive[-1])
                        else float("inf")),
           "iou": float("inf"), "order": float("inf"),
           "class": float(lead[idx[alive]].min()) if bool(alive.any())
           else float("inf")}
    if bool(pair.any()):
        out["iou"] = float((iou[pair] - iou_th).abs().min())
        touch = pair & (iou > iou_th - 1e-3)
        if bool(touch.any()):
            out["order"] = float((top[:, None] - top[None, :]).abs()[touch]
                                 .min())
    return out


def _clear(m: dict) -> bool:
    return (min(m["score"], m["boundary"], m["order"], m["class"])
            > TOL["scores"] and m["iou"] > 1e-4)


def _kept_equal(a, b) -> bool:
    if not torch.equal(a.valid, b.valid):
        return False
    v = a.valid
    return (torch.equal(a.classes[v], b.classes[v])
            and (not bool(v.any())
                 or (_gap(a.boxes[v], b.boxes[v]) <= TOL["boxes_px"]
                     and _gap(a.scores[v], b.scores[v]) <= TOL["scores"])))


def check_seed(seed: int, n: int, dev) -> dict:
    from dr_slam_torch.config import tum_freiburg3_yolox
    from dr_slam_torch.models import yolox

    cell = run.load_cell("tum3_slam.corridor")
    base_cfg = run.make_config(cell["config"])
    # the cell's sizes, which the configuration file states, with YOLOX-s
    cfg = tum_freiburg3_yolox()
    run.check_config(cell["config"], cfg)
    _, _, _, gray, depth = run.cell_frames(cell, cfg, seed, n, dev)
    store = {}
    try:
        est = _system_run(cfg, cell, gray, depth, n, dev, _recorder(store))
    finally:
        store.get("restore", lambda: None)()
    run._sync(dev)
    det = store["det"]
    sd = det.net.state_dict()
    d = cfg.detector
    gaps, tf32, kept, late = [], [], [], []
    for i, rec in enumerate(store["launch"]):
        ref = plain.heads(sd, rec["img"][None], d.depth_mul)
        ref_rows = plain.decode(ref)
        lead = _class_margin(ref)
        g = _head_gaps(rec["heads"], ref)
        g.update(_row_gaps(rec["rows"], ref_rows, lead > TOL["scores"]))
        gaps.append(g)
        if i % 8 == 0:
            with control.TF32():
                outs = det.heads(rec["img"])
            t = _head_gaps(outs, ref)
            t.update(_row_gaps(yolox.decode(outs), ref_rows,
                               lead > TOL["scores"]))
            tf32.append(t)
        best = torch.sort(ref_rows[:, 4], descending=True).values[
            LOW_RANKS[0]:LOW_RANKS[1] + 1]
        j = int(torch.argmax(best[:-1] - best[1:]))
        low = float(best[j] + best[j + 1]) / 2
        for th in (d.score_th, low):
            m = _margins(ref_rows, lead, th, d.iou_th, yolox)
            clear = _clear(m)
            a = yolox.select(rec["rows"], th, d.iou_th)
            b = yolox.select(ref_rows, th, d.iou_th)
            kept.append({"frame": i, "score_th": th, "clear": clear,
                         "n_kept": int(a.valid.sum()), "margins": m,
                         "equal": _kept_equal(a, b)})
    for i, out in enumerate(store["resolved"]):
        want = yolox.select(store["launch"][i]["rows"], d.score_th, d.iou_th)
        late.append(all(torch.equal(getattr(out, f), getattr(want, f))
                        for f in out._fields))
    base_est = [_system_run(base_cfg, cell, gray, depth, n, dev)
                for _ in range(2)]

    def parts(a, b) -> dict:
        return {"frames_differing": int(np.count_nonzero(
                    (a != b).any(axis=(1, 2)))),
                "max_abs": float(np.abs(a - b).max())}

    worst = {k: max(g[k] for g in gaps) for k in gaps[0]}
    tf32_worst = {k: max(g[k] for g in tf32) for k in tf32[0]}
    fails = [k for k in TOL if worst[k] > TOL[k]]
    if worst["labels_differing"]:
        fails.append("labels")
    if not any(tf32_worst[k] > TOL[k] for k in TOL):
        fails.append("the TF32 control passes every tolerance")
    if not all(k["equal"] for k in kept if k["clear"]):
        fails.append("kept detections")
    if not all(late) or len(late) != n or det.launches != n:
        fails.append("resolved detections")
    poses = parts(est, base_est[0])
    spread = parts(base_est[1], base_est[0])
    if poses["max_abs"] > spread["max_abs"]:
        fails.append("poses")
    return {"seed": seed, "frames": n, "launches": det.launches,
            "gaps": worst, "tf32": tf32_worst, "tol": TOL,
            "kept": {"checked": sum(k["clear"] for k in kept),
                     "within_margin": sum(not k["clear"] for k in kept),
                     "equal": sum(k["equal"] for k in kept if k["clear"]),
                     "kept_at_low": [k["n_kept"] for k in kept[1::2]],
                     "kept_at_th": [k["n_kept"] for k in kept[::2]],
                     "margins_at_low": [k["margins"] for k in kept[1::2]]},
            "resolved_equal": sum(late),
            "poses_vs_tum3_slam": poses, "tum3_slam_run_to_run": spread,
            "per_frame": gaps, "fails": fails}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="a JSON file for every number")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    out = []
    for seed in args.seeds:
        r = check_seed(seed, args.frames, dev)
        out.append(r)
        print(json.dumps({k: v for k, v in r.items() if k != "per_frame"}),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": run.card_line(), "runs": out}, f)
    return 1 if any(r["fails"] for r in out) else 0


if __name__ == "__main__":
    sys.exit(main())
