"""Tracking: the per-frame state machine over the device steps.

Counterpart of the JAX package's `slam/tracking.py` (the reference's
Tracking::Track, src/Tracking.cc:242): states NOT_INITIALIZED / OK / LOST;
the first frame initialises the map, every later frame runs `track_step`
(two launches of the CUDA matcher on the GPU), and the keyframe decision
(NeedNewKeyFrame) inserts a keyframe and runs the synchronous local-mapping
pass: cull, triangulate, fuse, local bundle adjustment, keyframe culling.

The default deferred mode enqueues a frame's fused extract+track step and
resolves its LOST / keyframe decision at the start of the next frame, from
a copy of the frame's scalar bundle into pinned host memory that was
started without waiting; on the CPU the copy is done at once. Per frame the
host reads back that one bundle, and per keyframe one packed bundle
(`_kf_scalar_bundle`). A LOST tracker relocalizes on its next frame
(`_relocalize`: BoW candidates, Horn- or PnP-RANSAC, pose optimisation, a
full-map projection check; the matcher runs there too), and a young map
that cannot be relocalized into is reset.

Every stage runs in a `stage_span` named as the reference's profiler spans
(`kf.add`, `kf.cull_map`, ..., `kf.local_ba` with the `ba.*` phases inside
it), and so do the deferred frame's dispatch (`track.dispatch`, with the
front-end's `frame.*` and the step's `track.*` stages inside it), its
resolve (`track.resolve`, with `resolve.readback`) and relocalization
(`track.relocalize`): with `utils.profiling.PROFILER` enabled they are
timed there on the host, with the host syncs counted in each."""

from __future__ import annotations

import collections
import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from dr_slam_torch import resolve_device, to_numpy
from dr_slam_torch.associate import keyframe_db
from dr_slam_torch.associate.vocabulary import bow_scores, compute_bow, word_ids
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.frontend.frame import FrameFeatures, extract_frame
from dr_slam_torch.geometry import se3
from dr_slam_torch.manhattan.bootstrap import find_manhattan
from dr_slam_torch.manhattan.tracker import track_manhattan_frame
from dr_slam_torch.optimize.global_ba import (bundle_adjust,
                                              local_problem_from_state,
                                              problem_from_state)
from dr_slam_torch.optimize.pnp import pnp_ransac
from dr_slam_torch.optimize.pose_opt import pose_optimize
from dr_slam_torch.optimize.sim3 import sim3_ransac
from dr_slam_torch.slam import map_ops
from dr_slam_torch.slam.loop_closing import _covis_full
from dr_slam_torch.slam.state import MapState, make_empty_state
from dr_slam_torch.slam.track_step import extract_and_track, track_step
from dr_slam_torch.utils.profiling import PROFILER, stage_span


def map_ba(state: MapState, cfg: SlamConfig, center_kf=None) -> MapState:
    """Per-keyframe map refinement: local-window BA around `center_kf`
    (LocalBundleAdjustment, Optimizer.cc:2067), or the whole map; 4
    Gauss-Newton steps of 24 CG iterations."""
    ws = cfg.tracking.use_struct_in_ba
    if cfg.tracking.use_local_ba and center_kf is not None:
        with stage_span("ba.problem"):
            prob, win = local_problem_from_state(
                state, center_kf, window=cfg.tracking.local_ba_window,
                with_struct=ws)
        out = bundle_adjust(prob, cfg.camera.K4, n_gn_iters=4, n_cg_iters=24)
        kf_pose = state.kf_pose.index_copy(0, win, out[0])
    else:
        with stage_span("ba.problem"):
            prob = problem_from_state(state, with_struct=ws)
        out = bundle_adjust(prob, cfg.camera.K4, n_gn_iters=4, n_cg_iters=24)
        kf_pose = out[0]
    return state._replace(
        kf_pose=kf_pose, pt_pos=out[1],
        pl_coef=out[2] if ws else state.pl_coef,
        ln_ep=out[3] if ws else state.ln_ep)


class TrackState(enum.Enum):
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


def _kf_scalar_bundle(state: MapState, kf_id, prev_kf) -> torch.Tensor:
    """(34,) float32: [kf_id, n_kfs, T_kf (16), T_prev (16)], every host
    value of a keyframe insertion in one tensor, so the host reads back
    once."""
    f32 = torch.float32
    return torch.cat([
        torch.stack([kf_id.to(f32), state.n_kfs.to(f32)]),
        map_ops._row(state.kf_pose, kf_id).reshape(-1),
        map_ops._row(state.kf_pose, prev_kf).reshape(-1)])


@dataclass
class TrackingResult:
    T_cw: object              # (4, 4): numpy, or a device tensor while lagged
    state: TrackState
    n_inliers: int
    n_matches: int
    manhattan_ok: bool
    is_keyframe: bool
    timestamp: float
    rot_residual_deg: float = None   # set by System.track_rgbd given gt_R


class _HostBundle:
    """A frame's scalar bundle on its way to the host: a non-blocking copy
    into pinned memory and a CUDA event behind it. On the CPU the copy is
    made at once."""

    def __init__(self, bundle: torch.Tensor):
        if bundle.is_cuda:
            self.host = torch.empty(bundle.shape, dtype=bundle.dtype,
                                    pin_memory=True)
            self.host.copy_(bundle, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = bundle.clone()
            self.event = None

    def is_ready(self) -> bool:
        return self.event is None or self.event.query()

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            if PROFILER.enabled and not self.event.query():
                PROFILER.count_sync()
            self.event.synchronize()
        return self.host.numpy()


@dataclass
class Tracker:
    """`Tracker(cfg, device=...)`; `device` defaults to cuda and raises
    without a GPU unless "cpu" is passed. `metrics` is None or any object
    with `.log(kind, **fields)`."""
    cfg: SlamConfig
    metrics: object = None
    device: object = None
    state: TrackState = TrackState.NOT_INITIALIZED
    map_state: MapState = None
    T_cw: torch.Tensor = None         # current pose
    velocity: torch.Tensor = None     # T_cw(t) @ inv(T_cw(t-1))
    R_cm: torch.Tensor = None         # Manhattan -> camera
    last_kf_frame: int = -1000
    ref_kf: int = 0
    frame_id: int = -1
    only_tracking: bool = False
    trajectory: list = field(default_factory=list)   # (ts, T_cw)
    kf_log: list = field(default_factory=list)       # (ts, T_kf) per insertion
    # per frame (ts, ref_kf, its pose and insertion seq at track time, T_cw):
    # corrected_trajectory recomposes frames from their keyframe's pose
    traj_rel: list = field(default_factory=list)
    kf_pose_host: dict = field(default_factory=dict)  # slot -> 4x4 at insert
    kf_seq_host: dict = field(default_factory=dict)   # slot -> insertion seq
    kf_odom_host: dict = field(default_factory=dict)  # seq -> (prev seq, 4x4)
    _seq_counter: int = 0
    _pending: object = field(default_factory=collections.deque)
    _last_inliers: int = 0
    _last_matches: int = 0
    _last_man_ok: bool = False
    _reloc_failures: int = 0
    _n_kfs_host: int = 0        # host mirror of map_state.n_kfs
    _map_gen: int = 0           # bumped on every map mutation
    _hard_gen: int = 0          # bumped on destructive mutations only
    _ref_kf_cache: object = None
    kf_inserted_event: bool = False

    def __post_init__(self):
        self.device = resolve_device(self.device)
        dev = self.device
        self.map_state = make_empty_state(self.cfg, dev)
        self.T_cw = torch.eye(4, device=dev)
        self.velocity = torch.eye(4, device=dev)
        self.R_cm = torch.eye(3, device=dev)

    def _frame(self, gray, depth):
        """The frame as float32 tensors on the device: depth in metres, as
        the reference's Tracker casts it (System.track_rgbd's contract)."""
        def as_f32(x):
            if isinstance(x, torch.Tensor):
                return x.to(self.device, torch.float32)
            return torch.tensor(np.asarray(x, np.float32), device=self.device)
        return as_f32(gray), as_f32(depth)

    # ------------------------------------------------------------------
    def process_frame(self, gray, depth, timestamp: float) -> TrackingResult:
        self.frame_id += 1
        cfg = self.cfg
        gray, depth = self._frame(gray, depth)

        if self.state == TrackState.NOT_INITIALIZED:
            res = self._initialize(extract_frame(gray, depth, cfg, self.device),
                                   timestamp)
        else:
            if cfg.tracking.deferred_readback:
                self._resolve_pending(force=False)
            if self.state == TrackState.LOST:
                with stage_span("track.relocalize"):
                    res = self._relocalize(
                        extract_frame(gray, depth, cfg, self.device),
                        timestamp)
            elif cfg.tracking.deferred_readback:
                res = self._track_deferred(gray, depth, timestamp)
            else:
                res = self._track(extract_frame(gray, depth, cfg, self.device),
                                  timestamp)

        self.trajectory.append((timestamp, res.T_cw))
        self.traj_rel.append((timestamp, self.ref_kf,
                              self.kf_pose_host.get(self.ref_kf),
                              self.kf_seq_host.get(self.ref_kf, -1),
                              res.T_cw))
        if self.metrics is not None:
            self.metrics.log("frame", idx=self.frame_id,
                             state=res.state.name, inliers=res.n_inliers,
                             matches=res.n_matches, kf=res.is_keyframe,
                             manhattan=res.manhattan_ok)
        return res

    def flush(self):
        """Resolve every pending deferred frame (before saving or shutting
        down, so the last frame's keyframe / LOST decision is applied)."""
        self._resolve_pending()

    def process_localization_only(self, gray, depth,
                                  timestamp: float) -> TrackingResult:
        """Track against a frozen map (System.cc:338): no keyframe, no
        culling, no BA, no landmark statistics."""
        prev = self.only_tracking
        self.only_tracking = True
        try:
            return self.process_frame(gray, depth, timestamp)
        finally:
            self.only_tracking = prev

    def corrected_trajectory(self) -> list:
        """[(ts, T_cw)], each frame recomposed from its reference keyframe's
        current pose (System::SaveTrajectoryTUM, System.cc:379-440); frames
        whose keyframe was culled keep their tracked pose."""
        kf_pose = to_numpy(self.map_state.kf_pose)
        kf_seq = to_numpy(self.map_state.kf_seq)
        kf_valid = to_numpy(self.map_state.kf_valid)
        out = []
        for ts, ref, ref_pose, seq, T in self.traj_rel:
            T_np = to_numpy(T)
            if ref_pose is None or not kf_valid[ref] or kf_seq[ref] != seq:
                out.append((ts, T_np))
                continue
            out.append((ts, (T_np @ np.linalg.inv(ref_pose)) @ kf_pose[ref]))
        return out

    def consume_kf_event(self) -> bool:
        """True once per keyframe insertion (in deferred mode
        `TrackingResult.is_keyframe` lags the insertion)."""
        ev = self.kf_inserted_event
        self.kf_inserted_event = False
        return ev

    # ------------------------------------------------------------------
    def _initialize(self, feats: FrameFeatures, ts: float) -> TrackingResult:
        """StereoInitialization (Tracking.cc:1549): the first frame becomes
        keyframe 0 at the origin, with points from depth and the frame's
        planes, and the Manhattan frame from its planes and lines."""
        if self.only_tracking:
            raise RuntimeError(
                "localization-only mode needs a loaded map -- cannot "
                "initialize a new map without mutating it")
        cfg = self.cfg
        dev = self.device
        n_depth = int(torch.sum(feats.kp.valid & (feats.kp_depth > 1e-3)))
        if n_depth < cfg.tracking.init_min_depth_points:
            return TrackingResult(np.eye(4), self.state, 0, 0, False, False, ts)

        T0 = torch.eye(4, device=dev)
        R_cm, mok = find_manhattan(
            feats.planes.coeffs[:, :3], feats.planes.valid,
            feats.planes.n_blocks.to(torch.float32),
            feats.lines.man_dir, feats.lines.man_ok,
            vertical_cos=cfg.plane.vertical_threshold)
        mok = bool(mok)
        if mok:
            out = track_manhattan_frame(
                R_cm, feats.normals, feats.normals_valid,
                feats.lines.man_dir, feats.lines.man_ok,
                cone_normals=cfg.manhattan.cone_angle_normals,
                cone_lines=cfg.manhattan.cone_angle_lines,
                kernel=cfg.manhattan.mean_shift_kernel,
                min_ratio=cfg.manhattan.min_sn_ratio)
            if bool(out.success):
                R_cm = out.R_cm
        self.R_cm = R_cm

        K = cfg.orb.max_keypoints
        no_match = torch.full((K,), -1, dtype=torch.int64, device=dev)
        pm = map_ops.match_planes(self.map_state, feats.planes.coeffs,
                                  feats.planes.valid, T0)   # all unmatched
        lm = torch.full((cfg.line.max_lines,), -1, dtype=torch.int64,
                        device=dev)
        bow = compute_bow(feats.kp.desc, feats.kp.valid, cfg.map.vocab_words)
        with stage_span("kf.add"):
            self.map_state, kf_id = map_ops.add_keyframe(
                self.map_state, feats, T0, ts, no_match, pm, lm, bow, cfg)
        self.map_state = self.map_state._replace(
            R_wm=R_cm, manhattan_ok=torch.tensor(mok, device=dev))
        self.T_cw = T0
        self.velocity = torch.eye(4, device=dev)
        self.state = TrackState.OK
        self.last_kf_frame = self.frame_id
        self.ref_kf = int(kf_id)
        self._n_kfs_host = 1
        self.kf_log.append((ts, np.eye(4)))
        self.kf_pose_host[self.ref_kf] = np.eye(4)
        self.kf_seq_host[self.ref_kf] = self._seq_counter
        self._seq_counter += 1
        self.kf_inserted_event = True
        return TrackingResult(np.eye(4), self.state, n_depth, n_depth, mok,
                              True, ts)

    # ------------------------------------------------------------------
    @staticmethod
    def _bad_pose(n_inliers: int, n_matches: int, jump: float) -> bool:
        """Failure detection: implausible updates go to LOST instead of
        being integrated."""
        return (n_inliers < 10 or n_inliers < 0.3 * max(n_matches, 1)
                or jump > 0.30)

    def _track(self, feats: FrameFeatures, ts: float) -> TrackingResult:
        """Synchronous tracking: `track_step`, one readback of its bundle,
        then the state machine."""
        out = track_step(self.map_state, feats, self.T_cw, self.velocity,
                         self.R_cm, self._ref_kf_dev(), self.cfg)
        b = to_numpy(out.bundle)
        n_inliers, n_matches = int(b[16]), int(b[17])
        man_ok, jump = bool(b[18] > 0.5), float(b[19])
        if self._bad_pose(n_inliers, n_matches, jump):
            self.state = TrackState.LOST
            return TrackingResult(to_numpy(self.T_cw), self.state, n_inliers,
                                  n_matches, man_ok, False, ts)
        if not self.only_tracking:
            self.map_state = out.new_map_state
        self.velocity = out.T_cw @ se3.inv_T(self.T_cw)
        self.T_cw = out.T_cw
        self.R_cm = out.R_cm
        self.state = TrackState.OK
        is_kf = self._maybe_insert_keyframe(
            feats, out, ts, self.frame_id, n_inliers,
            n_close_tracked=int(b[20]), n_close_untracked=int(b[21]),
            ref_tracked=int(b[22]))
        return TrackingResult(to_numpy(self.T_cw), self.state, n_inliers,
                              n_matches, man_ok, is_kf, ts)

    # ------------------------------------------------------------------
    def _maybe_insert_keyframe(self, feats: FrameFeatures, out, ts: float,
                               frame_id: int, n_inliers: int,
                               n_close_tracked: int = 0,
                               n_close_untracked: int = 0,
                               ref_tracked: int = 0) -> bool:
        """NeedNewKeyFrame (Tracking.cc:2907) with the reference's RGB-D
        gates, then CreateNewKeyFrame and the synchronous local-mapping
        pass. `out` is the frame's TrackStepOut."""
        cfg = self.cfg
        tr = cfg.tracking
        frames_since = frame_id - self.last_kf_frame
        fscale = cfg.orb.n_features / 1000.0
        need_close = (n_close_tracked < tr.kf_close_tracked_max * fscale
                      and n_close_untracked > tr.kf_close_untracked_min * fscale)
        ref_floor = max(ref_tracked, 1)
        c1a = frames_since >= tr.max_frames
        c1b = frames_since >= tr.min_frames
        c1c = n_inliers < tr.kf_collapse_ratio * ref_floor or need_close
        c2 = ((n_inliers < tr.kf_ref_ratio * ref_floor or need_close)
              and n_inliers > tr.kf_min_inliers)
        # max_frames forces a keyframe past the information gate
        forced = c1a and n_inliers > tr.kf_min_inliers
        need_kf = (not self.only_tracking) and (forced or ((c1b or c1c) and c2))
        if not need_kf:
            return False
        if self._n_kfs_host >= cfg.map.max_keyframes - 1:
            # capacity wall: evict the most redundant unprotected keyframe
            self.map_state = map_ops.cull_one_keyframe(self.map_state,
                                                       force=True)
            self._n_kfs_host = int(self.map_state.n_kfs)
            if self._n_kfs_host >= cfg.map.max_keyframes - 1:
                return False
        T_cur = out.T_cw
        dev = self.device
        bow = compute_bow(feats.kp.desc, feats.kp.valid, cfg.map.vocab_words)
        blocked = map_ops.creation_block_mask(
            self.map_state, feats.kp.uv, feats.kp_depth, T_cur, cfg.camera.K4)
        pm = map_ops.PlaneMatches(
            match_idx=out.plane_match, par_idx=out.plane_par,
            ver_idx=out.plane_ver,
            obs_world=se3.plane_to_world(T_cur, feats.planes.coeffs))
        prev_kf = torch.tensor(self.ref_kf, device=dev)
        with stage_span("kf.add"):
            self.map_state, kf_id = map_ops.add_keyframe(
                self.map_state, feats, T_cur, ts, out.mp_idx, pm,
                out.line_match, bow, cfg, blocked=blocked)
        if tr.run_cull_on_keyframe:
            with stage_span("kf.cull_map"):
                self.map_state = map_ops.cull_map(
                    self.map_state, merge_angle_cos=cfg.plane.merge_angle_cos,
                    merge_dist=cfg.plane.merge_dist)
        # LocalMapping: triangulate against the previous keyframe, fuse
        # duplicates, local BA, then cull one redundant keyframe. kf_id
        # stays a device scalar throughout.
        if tr.run_triangulation:
            with stage_span("kf.triangulate"):
                self.map_state = map_ops.triangulate_with_kf(
                    self.map_state, kf_id, prev_kf, cfg.camera.K4)
        if tr.run_fuse_on_keyframe:
            with stage_span("kf.fuse"):
                self.map_state = map_ops.fuse_new_points(
                    self.map_state, kf_id, fuse_dist=tr.fuse_dist)
        if tr.run_ba_on_keyframe:
            with stage_span("kf.local_ba"):
                self.map_state = map_ba(self.map_state, cfg, center_kf=kf_id)
            # the velocity is kept across the BA correction
            self.T_cw = map_ops._row(self.map_state.kf_pose, kf_id)
        if tr.run_kf_culling:
            with stage_span("kf.cull_keyframe"):
                self.map_state = map_ops.cull_one_keyframe(self.map_state)
        self.last_kf_frame = frame_id
        with stage_span("kf.readback"):
            b = to_numpy(_kf_scalar_bundle(self.map_state, kf_id, prev_kf))
        kf_i = int(b[0])
        self._n_kfs_host = int(b[1])
        T_kf = b[2:18].reshape(4, 4).astype(np.float64)
        T_prev = b[18:34].reshape(4, 4).astype(np.float64)
        self.ref_kf = kf_i
        self.kf_log.append((ts, T_kf))
        self.kf_pose_host[kf_i] = T_kf
        self.kf_seq_host[kf_i] = self._seq_counter
        # odometry edge against the previous reference keyframe's current
        # (post-BA) estimate
        prev = int(prev_kf)
        prev_seq = self.kf_seq_host.get(prev)
        if prev_seq is not None and prev != kf_i:
            self.kf_odom_host[self._seq_counter] = (
                prev_seq, T_kf @ np.linalg.inv(T_prev))
        self._seq_counter += 1
        self._map_gen += 1
        self.kf_inserted_event = True
        return True

    def _ref_kf_dev(self) -> torch.Tensor:
        """Device copy of ref_kf, made again only when ref_kf changes."""
        if self._ref_kf_cache is None or self._ref_kf_cache[0] != self.ref_kf:
            self._ref_kf_cache = (self.ref_kf,
                                  torch.tensor(self.ref_kf, device=self.device))
        return self._ref_kf_cache[1]

    # ------------------------------------------------------------------
    def _track_deferred(self, gray, depth, ts: float) -> TrackingResult:
        """Enqueue this frame's extract+track without a readback; its
        decision is resolved at the start of the next frame."""
        # track.dispatch: the host's enqueue of the frame's work
        with stage_span("track.dispatch"):
            feats, out = extract_and_track(
                gray, depth, self.map_state, self.T_cw, self.velocity,
                self.R_cm, self._ref_kf_dev(), self.cfg, device=self.device)
        T_prev, R_cm_prev = self.T_cw, self.R_cm
        # speculative advance on device values
        self.velocity = out.velocity
        self.T_cw = out.T_cw
        self.R_cm = out.R_cm
        self._pending.append((ts, feats, out, _HostBundle(out.bundle), T_prev,
                              R_cm_prev, self.frame_id, self.only_tracking,
                              self._map_gen, self._hard_gen))
        return TrackingResult(out.T_cw, self.state, self._last_inliers,
                              self._last_matches, self._last_man_ok, False, ts)

    def _resolve_pending(self, force: bool = True):
        """Apply deferred frames' decisions, oldest first. With force=False
        the newest frame is left pending while its bundle is still on the
        way; the queue stays at most 2 deep."""
        with stage_span("track.resolve"):
            while self._pending:
                entry = self._pending[0]
                if (not force and len(self._pending) <= 1
                        and not entry[3].is_ready()):
                    return
                self._pending.popleft()
                self._resolve_one(entry)
                if self.state == TrackState.LOST:
                    # later frames were enqueued off the rejected pose
                    self._pending.clear()
                    return

    def _resolve_one(self, entry):
        (ts, feats, out, host, T_prev, R_cm_prev, frame_id, was_loc,
         gen, hard) = entry
        if hard != self._hard_gen:
            return   # enqueued before a destructive mutation: dropped
        with stage_span("resolve.readback"):
            b = host.numpy()
        n_inliers, n_matches = int(b[16]), int(b[17])
        man_ok, jump = bool(b[18] > 0.5), float(b[19])
        self._last_inliers, self._last_matches = n_inliers, n_matches
        self._last_man_ok = man_ok
        if self._bad_pose(n_inliers, n_matches, jump):
            # roll the speculative pose and Manhattan anchor back
            self.state = TrackState.LOST
            self.T_cw = T_prev
            self.R_cm = R_cm_prev
            self.velocity = torch.eye(4, device=self.device)
            if self.metrics is not None:
                self.metrics.log("frame_resolved", idx=frame_id, state="LOST",
                                 inliers=n_inliers, matches=n_matches)
            return
        if not (self.only_tracking or was_loc):
            if gen == self._map_gen:
                self.map_state = out.new_map_state
            else:
                # a keyframe was inserted since this frame was enqueued:
                # apply its visibility statistics to the current map
                self.map_state = map_ops.update_point_stats(
                    self.map_state, out.visible, out.mp_idx)
            self._maybe_insert_keyframe(
                feats, out, ts, frame_id, n_inliers,
                n_close_tracked=int(b[20]), n_close_untracked=int(b[21]),
                ref_tracked=int(b[22]))

    # ------------------------------------------------------------------
    def _relocalize(self, feats: FrameFeatures, ts: float) -> TrackingResult:
        """Relocalization (Tracking.cc:3543): BoW covisibility-group
        candidates plus the raw top 3, descriptor matches per candidate,
        Horn-RANSAC on 3D-3D pairs (or PnP-RANSAC where depth is missing),
        pose optimisation, a wide projection search when that lands under
        50 inliers (Tracking.cc:3627-3664), then a full-map projection
        check. Three failures on a young map reset it (Tracking.cc:698)."""
        cfg = self.cfg
        st = self.map_state
        bow = compute_bow(feats.kp.desc, feats.kp.valid, cfg.map.vocab_words)
        scores = to_numpy(bow_scores(bow, st.kf_bow, st.kf_valid))
        # group-accumulated shortlist with no minScore floor (the query
        # frame has no covisible neighbours to derive one from)
        common = to_numpy(keyframe_db.common_word_counts(bow, st.kf_bow,
                                                         st.kf_valid))
        order = keyframe_db.group_candidates(
            scores, common, to_numpy(_covis_full(st)),
            to_numpy(st.kf_valid))[:5]
        # union with the raw top 3: where scores are near-uniform, group
        # accumulation can drop the nearby keyframe the raw score ranks
        # first; the geometric checks arbitrate
        for k in np.argsort(-scores)[:3]:
            if int(k) not in order and scores[int(k)] > 0:
                order.append(int(k))

        kp_word = word_ids(feats.kp.desc, cfg.map.vocab_words)
        for kf_id in order:
            if float(scores[kf_id]) <= 0:
                continue
            ref = map_ops.match_reference_kf(
                st, kf_id, feats.kp.desc, feats.kp.valid,
                max_hamming=map_ops.TH_HIGH, kp_word=kp_word,
                kf_word=st.kf_word[kf_id])
            if int(ref.n_matches) < 15:
                continue
            ok3d = ref.mp_idx >= 0
            pts3d = st.pt_pos[torch.clamp(ref.mp_idx, min=0)]
            # RGB-D: 3D-3D Horn on measured depth is well-posed for the
            # coplanar landmarks where a 2D-3D DLT degenerates
            pairs3d = ok3d & (feats.kp_depth > 1e-3)
            used_horn = int(torch.sum(pairs3d)) >= 10
            if used_horn:
                T0, _, n_in = sim3_ransac(pts3d, feats.kp_xyz, pairs3d,
                                          inlier_dist=0.10)
            else:
                T0, n_in = pnp_ransac(pts3d, feats.kp.uv, ok3d, cfg.camera.K4)
            n_in = int(n_in)
            if n_in < 10:
                continue
            pm = map_ops.match_planes(st, feats.planes.coeffs,
                                      feats.planes.valid, T0)
            lm = map_ops.match_lines_projection(
                st, feats.lines.seg2d, feats.lines.desc,
                feats.lines.valid & feats.lines.has3d, T0, cfg.camera.K4,
                width=cfg.camera.width, height=cfg.camera.height)
            obs = map_ops.build_pose_obs(st, feats, ref.mp_idx, pm, lm.ml_idx,
                                         n_struct=cfg.map.max_kf_planes)
            opt = pose_optimize(T0, obs, cfg.camera.K4, cfg.camera.bf)
            if int(opt.n_inliers) < 50:
                # the candidate ladder: search the whole map by projection
                # from the coarse pose, without the scale gate, and
                # re-optimise on the richer set
                wide = map_ops.match_points_projection(
                    st, feats.kp.uv, feats.kp.desc, feats.kp.valid,
                    opt.T_cw, cfg.camera.K4, radius=10.0,
                    max_hamming=map_ops.TH_HIGH,
                    width=cfg.camera.width, height=cfg.camera.height,
                    kp_angle=feats.kp.angle)
                if int(wide.n_matches) > int(opt.n_inliers):
                    obs = map_ops.build_pose_obs(
                        st, feats, wide.mp_idx, pm, lm.ml_idx,
                        n_struct=cfg.map.max_kf_planes)
                    opt = pose_optimize(opt.T_cw, obs, cfg.camera.K4,
                                        cfg.camera.bf)
            # verify against the whole map: an aliased pose matches one
            # keyframe consistently but projects poorly against the rest
            verify = map_ops.match_points_projection(
                st, feats.kp.uv, feats.kp.desc, feats.kp.valid, opt.T_cw,
                cfg.camera.K4, radius=6.0, max_hamming=map_ops.TH_LOW + 10.0,
                width=cfg.camera.width, height=cfg.camera.height,
                kp_angle=feats.kp.angle, kp_octave=feats.kp.octave,
                pt_scale=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels)
            n_opt, n_ver = int(opt.n_inliers), int(verify.n_matches)
            # acceptance: joint inliers and full-map consistency; or, on a
            # drifted map where no rigid pose fits the whole map, a strong
            # metric consensus (>= 50 Horn inliers at 0.10 m) with relaxed
            # floors
            strong_metric = (used_horn and n_in >= 50 and n_opt >= 15
                             and n_ver >= 35)
            if (n_opt >= 30 and n_ver >= 60) or strong_metric:
                self.T_cw = opt.T_cw
                self.velocity = torch.eye(4, device=self.device)
                self.state = TrackState.OK
                self._reloc_failures = 0
                self._map_gen += 1
                self._hard_gen += 1
                self.ref_kf = int(kf_id)
                if self.ref_kf not in self.kf_pose_host:
                    # relocalized into a loaded map: anchor the relative
                    # trajectory bookkeeping on the keyframe as it is
                    self.kf_pose_host[self.ref_kf] = to_numpy(
                        st.kf_pose[self.ref_kf])
                    self.kf_seq_host[self.ref_kf] = int(st.kf_seq[self.ref_kf])
                    self._seq_counter = max(self._seq_counter,
                                            self.kf_seq_host[self.ref_kf] + 1)
                if bool(st.manhattan_ok):
                    self.R_cm = opt.T_cw[:3, :3] @ st.R_wm
                return TrackingResult(to_numpy(opt.T_cw), self.state, n_opt,
                                      int(ref.n_matches), False, False, ts)
        # losing track on a young map (<= 5 keyframes soon after
        # initialization) resets it rather than relocalizing forever
        self._reloc_failures += 1
        if (not self.only_tracking and self._reloc_failures >= 3
                and self._n_kfs_host <= 5 and self._seq_counter <= 5):
            if self.metrics is not None:
                self.metrics.log("map_reset", frame=self.frame_id)
            self.map_state = make_empty_state(cfg, self.device)
            self.state = TrackState.NOT_INITIALIZED
            self._reloc_failures = 0
            self._n_kfs_host = 0
            self._map_gen += 1
            self._hard_gen += 1
            self.kf_pose_host.clear()
            self.kf_seq_host.clear()
            self.kf_odom_host.clear()
            # the map's kf_seq restarts at 0, and the host counter with it
            self._seq_counter = 0
        return TrackingResult(to_numpy(self.T_cw), TrackState.LOST, 0, 0,
                              False, False, ts)
