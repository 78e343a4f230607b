"""System facade: the public API of the reference's System class.

Counterpart of the JAX package's `slam/system.py` (include/System.h:70-80,
src/System.cc): construct with settings, feed frames with `track_rgbd`
(System.cc:284), switch localization-only mode (:338), save trajectories
(:379-562), save and load the map, shut down. Local mapping runs inside the
Tracker at each keyframe, and loop closing is a detection step after each
keyframe, with the global BA that a correction starts running on a side
CUDA stream until a later keyframe merges it.

`System(cfg, device=...)` runs on cuda unless `device="cpu"` is passed, and
raises without a GPU. An object detector (`models.yolox.YOLOX`, or any
object with `.detect(rgb)`) runs at each keyframe event for the 2D overlay,
never in the pose math; the offline viewer (`viz/viewer.py`) and the live
browser viewer (`viz/live.py`) attach on request."""

from __future__ import annotations

import os

import numpy as np
import torch

from dr_slam_torch import resolve_device, to_numpy
from dr_slam_torch.associate import vocabulary as voc
from dr_slam_torch.config import SlamConfig, load_config
from dr_slam_torch.frontend.frame import extract_frame
from dr_slam_torch.io import map_io
from dr_slam_torch.io.metrics import MetricsLogger
from dr_slam_torch.io.trajectory import (save_keyframe_trajectory_tum,
                                         save_trajectory_manhattan,
                                         save_trajectory_tum)
from dr_slam_torch.slam.loop_closing import LoopCloser
from dr_slam_torch.slam.tracking import Tracker, TrackState
from dr_slam_torch.utils.profiling import PROFILER, stage_span
from dr_slam_torch.viz.live import LiveViewer
from dr_slam_torch.viz.viewer import Viewer

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def rotation_residual_deg(R_est: np.ndarray, R_gt: np.ndarray) -> float:
    """Angular distance between two rotations in degrees,
    2 cos(alpha) = trace(R_gt^T R_est) - 1 (the reference's MatrixResidual,
    src/Tracking.cc:3773-3783)."""
    tr = float(np.trace(R_gt.T @ R_est))
    return float(np.degrees(np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0))))


class System:
    """DR-SLAM system facade on PyTorch."""

    def __init__(self, config: SlamConfig | str | None = None,
                 use_viewer: bool = False, metrics_path: str | None = None,
                 enable_loop_closing: bool = True, detector=None,
                 live_viewer: bool = False, live_viewer_port: int = 0,
                 device=None):
        """detector: an object with .detect(rgb) -> Detections (e.g.
        models.yolox.YOLOX). The reference runs YOLOX per frame for the 2D
        overlay only (Frame::ExtractObject -> FrameDrawer::DrawObjects,
        src/Frame.cc:1330, src/FrameDrawer.cc:219); here it runs at each
        keyframe event, on the tracking thread, and the latest detections
        feed the viewers' overlay."""
        if isinstance(config, str):
            config = load_config(config)
        self.cfg = config or SlamConfig()
        self.device = resolve_device(device)
        self._load_default_vocabulary()
        self.detector = detector
        self.last_detections = None
        self.metrics = MetricsLogger(metrics_path)
        self.tracker = Tracker(self.cfg, metrics=self.metrics,
                               device=self.device)
        self.only_tracking = False
        self.enable_loop_closing = enable_loop_closing
        self._loop_closer = None
        self._viewer = None
        if use_viewer or self.cfg.viewer.use_viewer:
            self._viewer = Viewer(self)
        self._live = None
        if live_viewer:
            # the browser-stream live viewer (the reference's Pangolin
            # window, src/Viewer.cc:43, on a headless host)
            self._live = LiveViewer(self, port=live_viewer_port)

    def _load_default_vocabulary(self):
        """Register the shipped trained codebook for the config's word count
        (the reference loads ORBvoc.txt at startup, System.cc:51):
        data/vocab{W}.npz, else data/vocab.npz, whichever holds W words."""
        W = self.cfg.map.vocab_words
        for name in (f"vocab{W}.npz", "vocab.npz"):
            path = os.path.join(_DATA_DIR, name)
            if not os.path.exists(path):
                continue
            with np.load(path) as data:
                words = data["words"]
            if words.shape[0] == W:
                voc.set_vocabulary(words)
                return

    # -- main API ----------------------------------------------------------
    def track_rgbd(self, gray, depth, timestamp: float, gt_R=None):
        """Process one RGB-D frame -> TrackingResult (System::TrackRGBD,
        System.cc:284). gray is (H, W) in [0, 255], depth (H, W) in metres;
        colour conversion and resizing are the caller's.

        gt_R: optional (3, 3) ground-truth world -> camera rotation; the
        estimate's angular error is then logged as `rot_residual` (the
        reference's GroundTruth_R diagnostics), at the cost of a readback
        of the pose."""
        if self.only_tracking:
            res = self.tracker.process_localization_only(gray, depth,
                                                         timestamp)
        else:
            res = self.tracker.process_frame(gray, depth, timestamp)
        if gt_R is not None:
            T = to_numpy(res.T_cw)
            res.rot_residual_deg = rotation_residual_deg(T[:3, :3],
                                                         np.asarray(gt_R))
            self.metrics.log("rot_residual", frame=self.tracker.frame_id,
                             deg=res.rot_residual_deg)
        if self.tracker.consume_kf_event():
            if self.detector is not None:
                g = torch.as_tensor(gray, dtype=torch.float32,
                                    device=self.device)
                self.last_detections = self.detector.detect(
                    torch.stack([g, g, g], -1))
            if self.enable_loop_closing:
                self._run_loop_closing()
        if self._viewer is not None:
            self._viewer.update(res)
        if self._live is not None:
            cfg, dev = self.cfg, self.device
            self._live.update(
                res, gray=gray,
                feats_fn=lambda: extract_frame(gray, depth, cfg, dev),
                detections=self.last_detections)
        return res

    def _run_loop_closing(self):
        if self._loop_closer is None:
            self._loop_closer = LoopCloser(
                self.cfg, consistency_needed=self.cfg.tracking.loop_consistency,
                device=self.device)
        tr = self.tracker
        # merge a global BA that has finished, never waiting for one still
        # running (the reference's detached GBA thread joining back,
        # LoopClosing.cc:691)
        with stage_span("loop.resolve_gba", device=self.device):
            merged = self._loop_closer.resolve_gba(tr.map_state,
                                                   guard_gen=tr._hard_gen)
        if merged is not None:
            tr.map_state = merged
            tr._map_gen += 1   # additive: pending frames re-apply stats
            self.metrics.log("gba_merged", kf=tr.ref_kf)
        with stage_span("loop.process", device=self.device):
            new_state, corrected = self._loop_closer.process(
                tr.map_state, tr.ref_kf, odom=tr.kf_odom_host)
        if corrected:
            tr.map_state = new_state
            tr._map_gen += 1    # pending frames predate the correction:
            tr._hard_gen += 1   # destructive, they are dropped
            # the correction moved the current keyframe: re-seat the pose
            T_c = new_state.kf_pose[tr.ref_kf]
            tr.T_cw = T_c
            tr.velocity = torch.eye(4, device=self.device)
            tr.kf_pose_host[tr.ref_kf] = T_c.detach().cpu().numpy()
            if bool(new_state.manhattan_ok):
                tr.R_cm = T_c[:3, :3] @ new_state.R_wm
            self.metrics.log("loop_closed", kf=tr.ref_kf)
            # the detached global BA (LoopClosing.cc:625): enqueued now,
            # merged at a later keyframe
            self._loop_closer.dispatch_gba(tr.map_state,
                                           guard_gen=tr._hard_gen)

    # -- modes (System.cc:338-354) ------------------------------------------
    def activate_localization_mode(self):
        self.only_tracking = True

    def deactivate_localization_mode(self):
        self.only_tracking = False

    def reset(self):
        self.tracker = Tracker(self.cfg, metrics=self.metrics,
                               device=self.device)

    # -- state ----------------------------------------------------------------
    @property
    def track_state(self) -> TrackState:
        return self.tracker.state

    def map_summary(self) -> dict:
        self.tracker.flush()
        st = self.tracker.map_state
        return {
            "n_keyframes": int(st.n_kfs),
            "n_points": int(st.pt_valid.sum()),
            "n_planes": int(st.pl_valid.sum()),
            "n_lines": int(st.ln_valid.sum()),
            "manhattan": bool(st.manhattan_ok),
        }

    def block_until_ready(self):
        """Wait for the device work enqueued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- savers (System.cc:379-562) -------------------------------------------
    def save_trajectory_tum(self, path: str):
        """Every frame recomposed from its reference keyframe's current pose
        (System.cc:379-440), so loop and BA corrections reach the file."""
        self.tracker.flush()
        corrected = self.tracker.corrected_trajectory()
        save_trajectory_tum(path, [t for t, _ in corrected],
                            [p for _, p in corrected])

    def save_keyframe_trajectory_tum(self, path: str):
        """The live keyframes' current poses in insertion order
        (System.cc:442+)."""
        self.tracker.flush()
        st = self.tracker.map_state
        valid = st.kf_valid.cpu().numpy()
        seq = st.kf_seq.cpu().numpy()
        alive = np.where(valid)[0]
        order = alive[np.argsort(seq[alive])]
        kf_pose = st.kf_pose.cpu().numpy()[order]
        kf_ts = st.kf_ts.cpu().numpy()[order]
        save_keyframe_trajectory_tum(path, list(kf_ts), list(kf_pose))

    def save_trajectory_manhattan(self, path: str):
        corrected = self.tracker.corrected_trajectory()
        R_wm = self.tracker.map_state.R_wm.cpu().numpy()
        save_trajectory_manhattan(path, [t for t, _ in corrected],
                                  [p for _, p in corrected], R_mw=R_wm.T)

    def save_map(self, path: str):
        map_io.save_map(path, self.tracker.map_state)

    def load_map(self, path: str):
        """Load a map written by either package; the tracker is then LOST
        and relocalizes into the map on its next frame."""
        tr = self.tracker
        tr._pending.clear()   # deferred frames of the old map
        tr.map_state = map_io.load_map(path, self.cfg, self.device)
        tr._map_gen += 1
        tr._hard_gen += 1
        tr._n_kfs_host = int(tr.map_state.n_kfs)
        tr.state = TrackState.LOST

    def shutdown(self, save_dir: str | None = None):
        """Flush, join the global BA (blocking, as the reference joins its
        GBA thread, System.cc:356-377), optionally save the trajectories
        (and, with the stage profiler on, `stage_profile.json`), and close
        the metrics log."""
        self.tracker.flush()
        if self._loop_closer is not None:
            merged = self._loop_closer.resolve_gba(
                self.tracker.map_state, guard_gen=self.tracker._hard_gen,
                block=True)
            if merged is not None:
                self.tracker.map_state = merged
                self.tracker._map_gen += 1
        if save_dir:
            os.makedirs(save_dir, exist_ok=True)
            self.save_trajectory_tum(os.path.join(save_dir,
                                                  "CameraTrajectory.txt"))
            self.save_keyframe_trajectory_tum(
                os.path.join(save_dir, "KeyFrameTrajectory.txt"))
            if PROFILER.enabled:
                PROFILER.dump(os.path.join(save_dir, "stage_profile.json"))
        self.metrics.close()
