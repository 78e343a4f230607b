"""The per-frame tracking step and `extract_and_track`, the main path.

Counterpart of the JAX package's `slam/track_step.py`: Manhattan mean shift, pose
prediction, two projection-matching passes (each one launch of the gated
top-2 matcher) with the reference-keyframe BoW match as a fallback, plane
and line association, two `pose_optimize` solves and the landmark
statistics, as eager PyTorch on one device.

The reference-keyframe fallback, which the reference runs under
`lax.cond`, is computed every frame and selected with `torch.where`, so no
branch waits for the device. Yet a frame is not enqueued without waiting
today: on the card the host waits for the device 7 times a frame inside the
dispatch (PERF.md §6 lists the sites). Rows indexed by the 0-d device tensor
`ref_kf` read it back (the fallback's `state.kf_word[ref_kf]` and the
keyframe inputs' `state.kf_mp[ref_kf]` in `track_step`, and
`map_ops.match_reference_kf`), and a Python float written into one element
(`ops/planes.py: segment_planes`, `ops/lines.py: extract_lines`) is copied
from host memory.
Each stage runs in a `stage_span` (`track.manhattan`,
`track.match`, `track.assoc`, `track.pose_opt` for each of the two passes,
`track.stats`); through `extract_and_track` they sit in the tracker's
`track.dispatch` span beside the front-end's `frame.*` spans."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.associate.vocabulary import word_ids
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.frontend.frame import FrameFeatures, _extract_frame, ingest
from dr_slam_torch.geometry import se3
from dr_slam_torch.manhattan.tracker import track_manhattan_frame
from dr_slam_torch.optimize.pose_opt import pose_optimize
from dr_slam_torch.slam import map_ops
from dr_slam_torch.slam.state import MapState
from dr_slam_torch.utils.profiling import stage_span


class TrackStepOut(NamedTuple):
    T_cw: torch.Tensor          # (4, 4) optimized pose
    R_cm: torch.Tensor          # (3, 3) refreshed Manhattan->camera
    n_matches: torch.Tensor     # () motion-stage matches
    n_inliers: torch.Tensor     # () final inliers
    man_ok: torch.Tensor        # () bool
    jump: torch.Tensor          # () |t - t_pred|
    velocity: torch.Tensor      # (4, 4) T_cur @ inv(T_last)
    bundle: torch.Tensor        # (23,) T_cw.ravel() ++ [n_inliers, n_matches,
                                #   man_ok, jump, n_close_tracked,
                                #   n_close_untracked, ref_tracked]
    mp_idx: torch.Tensor        # (K,) final per-keypoint map-point matches
    plane_match: torch.Tensor   # (P,)
    plane_par: torch.Tensor     # (P,)
    plane_ver: torch.Tensor     # (P,)
    line_match: torch.Tensor    # (L,)
    visible: torch.Tensor       # (NP,) map points in-frustum this frame
    new_map_state: MapState     # with updated visibility statistics


def _as_tensor(x, dtype, dev):
    return torch.as_tensor(x, dtype=dtype).to(dev)


def extract_and_track(gray, depth, state: MapState, T_last, velocity,
                      R_cm_prev, ref_kf, cfg: SlamConfig, device=None):
    """Front-end extraction + the tracking step for one frame, on `device`
    (default cuda; raises without a GPU unless device="cpu").

    gray (H, W) uint8 or float32, depth (H, W) uint16 sensor units or
    float32 meters (numpy or tensors); `state` lives on `device`.
    Returns (FrameFeatures, TrackStepOut)."""
    dev = resolve_device(device)
    if state.pt_pos.device.type != dev.type:
        raise ValueError(f"map state is on {state.pt_pos.device}, not {dev}")
    gray, depth = ingest(gray, depth, cfg.camera, dev)
    feats = _extract_frame(gray, depth, cfg.camera, cfg.orb, cfg.plane,
                           cfg.line)
    f32 = torch.float32
    out = track_step(state, feats, _as_tensor(T_last, f32, dev),
                     _as_tensor(velocity, f32, dev),
                     _as_tensor(R_cm_prev, f32, dev),
                     _as_tensor(ref_kf, torch.int64, dev), cfg)
    return feats, out


def _no_planes(pm: map_ops.PlaneMatches) -> map_ops.PlaneMatches:
    return pm._replace(match_idx=torch.full_like(pm.match_idx, -1),
                       par_idx=torch.full_like(pm.par_idx, -1),
                       ver_idx=torch.full_like(pm.ver_idx, -1))


def track_step(state: MapState, feats: FrameFeatures, T_last, velocity,
               R_cm_prev, ref_kf, cfg: SlamConfig) -> TrackStepOut:
    cam = cfg.camera
    tr = cfg.tracking

    # --- Manhattan rotation tracking (Tracking.cc:328-332) ------------------
    with stage_span("track.manhattan"):
        man = track_manhattan_frame(
            R_cm_prev, feats.normals, feats.normals_valid,
            feats.lines.man_dir, feats.lines.man_ok,
            cone_normals=cfg.manhattan.cone_angle_normals,
            cone_lines=cfg.manhattan.cone_angle_lines,
            kernel=cfg.manhattan.mean_shift_kernel,
            min_ratio=cfg.manhattan.min_sn_ratio,
            n_iterations=cfg.manhattan.n_iterations)
        man_ok = man.success & state.manhattan_ok

        # --- predict pose (velocity model; Manhattan R as rotation prior) ---
        T_vel = velocity @ T_last
        R_cw_man = man.R_cm @ state.R_wm.T
        T_man = se3.make_T(R_cw_man, T_vel[:3, 3])
        T_pred = torch.where(man_ok, T_man, T_vel)

    match_kw = dict(width=cam.width, height=cam.height,
                    kp_angle=feats.kp.angle, kp_octave=feats.kp.octave,
                    pt_scale=cfg.orb.scale_factor, n_levels=cfg.orb.n_levels,
                    max_candidates=tr.match_candidates)

    # --- stage 1: motion-model matching + full pose solve --------------------
    with stage_span("track.match"):
        pm = map_ops.match_points_projection(
            state, feats.kp.uv, feats.kp.desc, feats.kp.valid, T_pred, cam.K4,
            radius=tr.motion_search_radius, max_hamming=64.0, **match_kw)
        mp_idx = pm.mp_idx
        if tr.use_ref_kf_anchor:
            # BoW-word-bucketed SearchByBoW fallback (Tracking.cc:370-375),
            # taken only when projection matching collapsed
            use_ref = pm.n_matches < 20
            kpw = word_ids(feats.kp.desc, cfg.map.vocab_words)
            ref = map_ops.match_reference_kf(
                state, ref_kf, feats.kp.desc, feats.kp.valid,
                kp_word=kpw, kf_word=state.kf_word[ref_kf])
            mp_idx = torch.where(use_ref & (ref.mp_idx >= 0), ref.mp_idx,
                                 mp_idx)
            T_pred = torch.where(use_ref, T_last, T_pred)

    plane_kw = dict(assoc_ang=cfg.plane.association_ang_ref,
                    assoc_dis=cfg.plane.association_dis_ref,
                    par_th=cfg.plane.parallel_threshold,
                    ver_th=cfg.plane.vertical_threshold)
    with stage_span("track.assoc"):
        plane_m = map_ops.match_planes(state, feats.planes.coeffs,
                                       feats.planes.valid, T_pred, **plane_kw)
        line_m = map_ops.match_lines_projection(
            state, feats.lines.seg2d, feats.lines.desc,
            feats.lines.valid & feats.lines.has3d, T_pred, cam.K4,
            width=cam.width, height=cam.height)
        lm_pose = (line_m.ml_idx if tr.use_lines_in_pose
                   else torch.full_like(line_m.ml_idx, -1))
        if not tr.use_planes_in_pose:
            plane_m = _no_planes(plane_m)
        obs = map_ops.build_pose_obs(state, feats, mp_idx, plane_m, lm_pose,
                                     n_struct=cfg.map.max_kf_planes)

    solve_kw = dict(angle_info=cfg.plane.angle_info,
                    dist_info=cfg.plane.distance_info,
                    plane_chi2=cfg.plane.chi2, vp_chi2=cfg.plane.vp_chi2,
                    prior_sigma_t=0.3, prior_sigma_r=0.03)
    with stage_span("track.pose_opt"):
        opt = pose_optimize(
            T_pred, obs, cam.K4, cam.bf,
            translation_only=tr.translation_only_with_manhattan,
            struct_on=False, **solve_kw)

    # --- stage 2: local-map rematch at the refined pose + struct edges -------
    with stage_span("track.match"):
        pm2 = map_ops.match_points_projection(
            state, feats.kp.uv, feats.kp.desc, feats.kp.valid, opt.T_cw,
            cam.K4, radius=tr.local_search_radius,
            max_hamming=map_ops.TH_LOW + 10.0, **match_kw)
        mp_idx2 = torch.where(pm2.mp_idx >= 0, pm2.mp_idx, mp_idx)
        # deduplicate across the two passes: stage-2 wins a shared map point
        NP = state.pt_pos.shape[0]
        K = mp_idx2.shape[0]
        k_idx = torch.arange(K, device=mp_idx2.device)
        tgt = torch.where(mp_idx2 >= 0, mp_idx2, torch.full_like(mp_idx2, NP))
        stage2 = pm2.mp_idx >= 0
        dump = torch.full_like(tgt, NP)
        own1 = map_ops._last_writer(NP + 1, torch.where(~stage2, tgt, dump),
                                    k_idx)
        own2 = map_ops._last_writer(NP + 1, torch.where(stage2, tgt, dump),
                                    k_idx)
        owner = torch.where(own2 >= 0, own2, own1)
        mp_idx2 = torch.where(owner[torch.clamp(mp_idx2, min=0)] == k_idx,
                              mp_idx2, torch.full_like(mp_idx2, -1))
    with stage_span("track.assoc"):
        plane_m2 = map_ops.match_planes(state, feats.planes.coeffs,
                                        feats.planes.valid, opt.T_cw,
                                        **plane_kw)
        if not tr.use_planes_in_pose:
            plane_m2 = _no_planes(plane_m2)
        obs2 = map_ops.build_pose_obs(state, feats, mp_idx2, plane_m2,
                                      lm_pose, n_struct=cfg.map.max_kf_planes)
    with stage_span("track.pose_opt"):
        opt2 = pose_optimize(opt.T_cw, obs2, cam.K4, cam.bf,
                             translation_only=False, struct_on=True,
                             **solve_kw)

    with stage_span("track.stats"):
        # back onto SO(3): the velocity model predicts T_cur inv_T(T_last)
        # T_cur, and inv_T transposes R, so a rotation's departure from
        # orthonormality would grow by 1 + sqrt(2) per frame while the
        # Manhattan prior is off
        T_cur = se3.make_T(se3.orthonormalize_rotation(opt2.T_cw[:3, :3]),
                           opt2.T_cw[:3, 3])

        # --- bookkeeping (MapPoint Increase{Visible,Found}) -----------------
        new_state = map_ops.update_point_stats(state, pm2.visible, mp_idx2)

        # --- NeedNewKeyFrame inputs (Tracking.cc:2944-2964) -----------------
        close = (feats.kp.valid & (feats.kp_depth > 1e-3)
                 & (feats.kp_depth < cam.th_depth_m))
        n_close_tracked = torch.sum(close & (mp_idx2 >= 0))
        n_close_untracked = torch.sum(close & (mp_idx2 < 0))
        ref_mp = state.kf_mp[ref_kf]
        ref_tracked = torch.sum((ref_mp >= 0)
                                & state.pt_valid[torch.clamp(ref_mp, min=0)])

        R_cm_new = torch.where(state.manhattan_ok, T_cur[:3, :3] @ state.R_wm,
                               R_cm_prev)
        jump = torch.linalg.norm(T_cur[:3, 3] - T_pred[:3, 3])
        velocity_new = T_cur @ se3.inv_T(T_last)
        f32 = torch.float32
        bundle = torch.cat([
            T_cur.reshape(-1),
            torch.stack([opt2.n_inliers.to(f32), pm.n_matches.to(f32),
                         man_ok.to(f32), jump, n_close_tracked.to(f32),
                         n_close_untracked.to(f32), ref_tracked.to(f32)])])
    return TrackStepOut(
        T_cw=T_cur, R_cm=R_cm_new, n_matches=pm.n_matches,
        n_inliers=opt2.n_inliers, man_ok=man_ok, jump=jump,
        velocity=velocity_new, bundle=bundle,
        mp_idx=mp_idx2, plane_match=plane_m2.match_idx,
        plane_par=plane_m2.par_idx, plane_ver=plane_m2.ver_idx,
        line_match=line_m.ml_idx, visible=pm2.visible,
        new_map_state=new_state)
