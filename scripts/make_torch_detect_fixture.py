"""Build the fixture that `chip_smoke.py` phase 10 holds the port's detector,
cylinders and viewers to: the JAX package's own runs on the CPU.

10a. A JAX `System(tum_freiburg3(), detector=YOLOX(input_size=640))` (the
     YOLOX-s random init, `init_params()`; loop closing on) over the 24
     frames of dr_slam_torch/data/mapping_corridor.npz, fed as phase 9's
     runner decodes them (gray as float32, depth as d16 / depth_factor in
     float32, timestamps 1000 + i / 30). After every frame the script waits
     for each pending frame's bundle, so the deferred decision lags by
     exactly one frame, as on the card. Kept: the per-frame outputs (T_cw,
     state code, n_inliers, n_matches, is_keyframe, ref_kf), the keyframes'
     frames and the final counts; at each detector call, the frame, the
     decoded candidates (M x 6, before the top-k), each candidate's margin
     between its best and second class probabilities, the detections; and
     `_select` on those candidates at score 0.255 and IoU 0.2 (the random
     network's scores lie near 0.25, so this threshold keeps some hundreds
     and the NMS suppresses across levels).
10b. The shipped trained weights (dr_slam_tpu/data/yolox_synth.npz) at 256,
     score threshold 0.4, over six `render_scene` images drawn with
     `RandomState(123)` (tests/test_yolox_detect.py), stored as uint8 (the
     detector is run on those uint8 values) with their ground-truth boxes.
10c. A ray-cast cylinder before a wall (tests/test_cylinders.py's
     generator) at 640x480 with tum_freiburg3()'s intrinsics: radius
     0.12 m, axis 1.6 m away, the wall 5 cm behind it. `segment_planes`'
     block labels, `segment_cylinders` and `extract_frame` with
     `detect_cylinders=True` on it. (The test's own geometry, radius 0.3 m
     at 2.2 m before a wall at 4 m, gives no cylinder at 640x480: the plane
     segmentation claims the body, whose neighbouring cells' normals differ
     by less than the merge angle at this resolution.)

Run from the repository root (a few minutes on the CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_detect_fixture.py

Writes dr_slam_torch/data/detect_corridor.npz."""

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

N_FRAMES = 24
LOW_TH = (0.255, 0.2)      # (score_th, iou_th) of the second select
SYNTH_IMAGES = 6
CYL_SCENE = {"X0": 0.2, "Z0": 1.6, "R": 0.12, "zwall": 1.77}


def detections(d) -> dict:
    return {"boxes": np.asarray(d.boxes), "scores": np.asarray(d.scores),
            "classes": np.asarray(d.classes), "valid": np.asarray(d.valid)}


def stacked(prefix: str, rows: list) -> dict:
    return {f"{prefix}__{k}": np.stack([r[k] for r in rows]) for k in rows[0]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "dr_slam_torch", "data", "detect_corridor.npz"))
    args = ap.parse_args()
    jax.config.update("jax_default_matmul_precision", "float32")

    from dr_slam_tpu.config import tum_freiburg3
    from dr_slam_tpu.frontend.frame import extract_frame
    from dr_slam_tpu.models import yolox
    from dr_slam_tpu.ops.cylinders import segment_cylinders
    from dr_slam_tpu.ops.planes import segment_planes
    from dr_slam_tpu.slam.system import System
    from dr_slam_torch._smoke import TUM_T0, load_mapping_fixture
    from test_cylinders import _render_cylinder_depth
    from torch_parity import jax_system_lagged_by_one, load_script

    cfg = tum_freiburg3()
    mdata = load_mapping_fixture()
    out = {"low_th": np.asarray(LOW_TH, np.float32)}

    # --- 10a: the System with YOLOX-s at 640 ---------------------------------
    calls = []

    class RecordingYOLOX(yolox.YOLOX):
        def __init__(self, **kw):
            super().__init__(**kw)
            self._candidates = jax.jit(self._decoded)

        def _decoded(self, img):
            """(candidates, each one's margin between its best and second
            class probabilities)."""
            outs = yolox._forward(self.params, img[None] / 255.0)
            probs = jnp.concatenate([jax.nn.sigmoid(c[0]).reshape(-1, 80)
                                     for _, _, c in outs])
            top2 = jax.lax.top_k(probs, 2)[0]
            return (yolox._decode(outs, self.input_size),
                    top2[:, 0] - top2[:, 1])

        def detect(self, rgb):
            s = self.input_size
            cand, margin = self._candidates(jax.image.resize(
                jnp.asarray(rgb, jnp.float32), (s, s, 3), "bilinear"))
            det = super().detect(rgb)
            low = yolox._select(cand, *LOW_TH)
            calls.append((len(frames), np.asarray(cand), np.asarray(margin),
                          detections(det), detections(low)))
            return det

    system = System(cfg, detector=RecordingYOLOX(input_size=640))
    factor = np.float32(cfg.camera.depth_factor)
    with jax_system_lagged_by_one() as frames:
        for i in range(N_FRAMES):
            system.track_rgbd(mdata["gray"][i].astype(np.float32),
                              mdata["depth"][i].astype(np.float32) / factor,
                              TUM_T0 + i / 30.0)
        res = [c[0] for c in frames]
        ref_kf = [c[1] for c in frames]
    tr = system.tracker
    tr.flush()
    st = tr.map_state
    out.update({
        "run__T_cw": np.stack([np.asarray(r.T_cw, np.float32) for r in res]),
        "run__state": np.asarray([r.state.value for r in res], np.int32),
        "run__n_inliers": np.asarray([r.n_inliers for r in res], np.int32),
        "run__n_matches": np.asarray([r.n_matches for r in res], np.int32),
        "run__is_keyframe": np.asarray([r.is_keyframe for r in res]),
        "run__ref_kf": np.asarray(ref_kf, np.int32),
        "run__kf_frames": np.asarray(
            [int(round((ts - TUM_T0) * 30.0)) for ts, _ in tr.kf_log],
            np.int32),
        "run__n_kfs": np.int32(st.n_kfs), "run__n_pts": np.int32(st.n_pts)})
    out["det__frame"] = np.asarray([c[0] for c in calls], np.int32)
    out["det__cand"] = np.stack([c[1] for c in calls])
    out["det__class_margin"] = np.stack([c[2] for c in calls])
    out.update(stacked("det", [c[3] for c in calls]))
    out.update(stacked("low", [c[4] for c in calls]))
    print(f"10a: keyframes at {out['run__kf_frames'].tolist()}, detector "
          f"calls at frames {out['det__frame'].tolist()}, valid detections "
          f"{out['det__valid'].sum(1).tolist()}, kept at {LOW_TH} "
          f"{out['low__valid'].sum(1).tolist()}", flush=True)

    # --- 10b: the shipped trained weights at 256 -----------------------------
    ty = load_script("train_yolox")
    det = yolox.YOLOX(weights=os.path.join(ROOT, "dr_slam_tpu", "data",
                                           "yolox_synth.npz"),
                      input_size=ty.SIZE, score_th=0.4)
    rng = np.random.RandomState(123)
    scenes = [ty.render_scene(rng) for _ in range(SYNTH_IMAGES)]
    imgs = np.stack([np.round(img * 255.0).astype(np.uint8)
                     for img, _, _ in scenes])
    out["synth__img"] = imgs
    out["synth__gt"] = np.stack([b for _, b, _ in scenes])
    out["synth__n"] = np.asarray([n for _, _, n in scenes], np.int32)
    out.update(stacked("synth", [detections(det.detect(img.astype(np.float32)))
                                 for img in imgs]))
    print(f"10b: valid detections {out['synth__valid'].sum(1).tolist()}, "
          f"ground truth {out['synth__n'].tolist()}", flush=True)

    # --- 10c: cylinders at 640x480 --------------------------------------------
    K4 = cfg.camera.K4
    depth = _render_cylinder_depth(K4, cfg.camera.height, cfg.camera.width,
                                   **CYL_SCENE)
    gray = np.tile(np.linspace(0, 255, cfg.camera.width, dtype=np.float32),
                   (cfg.camera.height, 1))
    out.update({"cyl__depth": depth, "cyl__gray": gray,
                "cyl__scene": np.asarray([CYL_SCENE[k] for k in
                                          ("X0", "Z0", "R", "zwall")],
                                         np.float32)})
    planes = segment_planes(jnp.asarray(depth), K4)
    out["cyl__block_label"] = np.asarray(planes.block_label)
    seg = segment_cylinders(jnp.asarray(depth), K4, planes.block_label)
    out.update({f"cyl__{k}": np.asarray(v) for k, v in seg._asdict().items()})
    ccfg = cfg.replace(plane=dataclasses.replace(cfg.plane,
                                                 detect_cylinders=True))
    feats = extract_frame(jnp.asarray(gray), jnp.asarray(depth), ccfg)
    out.update({f"cylf__{k}": np.asarray(v)
                for k, v in feats.cylinders._asdict().items()})
    print(f"10c: cylinders valid {out['cyl__valid'].tolist()}, n_cells "
          f"{out['cyl__n_cells'].tolist()}, radius "
          f"{out['cyl__radius'].tolist()}; extract_frame valid "
          f"{out['cylf__valid'].tolist()}", flush=True)

    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out} ({os.path.getsize(args.out) / 1e6:.3f} MB)")


if __name__ == "__main__":
    main()
