"""Per-frame map association: projection matching, reference-keyframe
matching, plane and line association, pose-observation assembly and the
landmark visibility statistics.

Counterpart of the per-frame half of the JAX package's `slam/map_ops.py`
(ORBmatcher::SearchByProjection / SearchByBoW, PlaneMatcher::
SearchMapByCoefficients, LSDmatcher). Keyframe insertion, culling, fusion
and triangulation are not ported yet.

Scatters whose targets may repeat (`.at[].set` in the reference, last write
wins on the CPU) are written as scatter-max over the writer index, which is
the same result and deterministic on the GPU."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.frontend.frame import FrameFeatures
from dr_slam_torch.geometry import se3
from dr_slam_torch.ops.hamming import hamming_matrix
from dr_slam_torch.ops.match_cuda import TILE_C, gated_top2_hamming
from dr_slam_torch.ops.select import top_k
from dr_slam_torch.optimize.pose_opt import PoseObservations
from dr_slam_torch.slam.state import MapState

TH_HIGH = 100.0   # ORBmatcher.h TH_HIGH
TH_LOW = 50.0     # ORBmatcher.h TH_LOW


class PointMatches(NamedTuple):
    mp_idx: torch.Tensor      # (K,) int matched map-point id or -1
    n_matches: torch.Tensor   # () int
    visible: torch.Tensor     # (NP,) bool predicted-visible mask


def _last_writer(n: int, tgt: torch.Tensor, writer: torch.Tensor) -> torch.Tensor:
    """(n,) table: for each slot the largest writer index aimed at it, -1
    where none (the `.at[tgt].set(writer)` result with ascending writers)."""
    out = torch.full((n,), -1, dtype=torch.int64, device=tgt.device)
    return out.scatter_reduce_(0, tgt.to(torch.int64), writer.to(torch.int64),
                               reduce="amax", include_self=True)


def rotation_consistency(ok, dangle, n_bins: int = 30, keep_bins: int = 3):
    """ORBmatcher's orientation-histogram check (ORBmatcher.cc:38-40,1666):
    keep only matches in the `keep_bins` most populated of 30 angle bins."""
    two_pi = 2.0 * torch.pi
    a = torch.remainder(dangle, two_pi)
    bins = torch.clamp((a / two_pi * n_bins).to(torch.int64), 0, n_bins - 1)
    hist = torch.zeros(n_bins, dtype=torch.int32, device=ok.device).index_add_(
        0, bins, ok.to(torch.int32))
    _, top_bins = top_k(hist, keep_bins)
    in_top = torch.any(bins[:, None] == top_bins[None, :], dim=1)
    return ok & in_top


def _pad_rows(x: torch.Tensor, n: int, fill=0) -> torch.Tensor:
    if n == 0:
        return x
    pad = torch.full((n,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad])


def match_points_projection(state: MapState, kp_uv, kp_desc, kp_valid,
                            T_pred, K4, radius: float,
                            max_hamming: float = TH_HIGH,
                            width: int = 640, height: int = 480,
                            kp_angle=None, kp_octave=None,
                            pt_scale: float = 1.2,
                            n_levels: int = 8,
                            max_candidates: int = 0) -> PointMatches:
    """Project every map point, gate by frustum / scale band / view cone,
    optionally compact the candidates, then run the gated top-2 matcher
    (the CUDA kernel on the GPU, its plain version on the CPU); ratio test,
    mutual check and rotation consistency decide the matches."""
    dev = kp_uv.device
    NP = state.pt_pos.shape[0]
    K = kp_uv.shape[0]
    pos_c = se3.transform_points(T_pred, state.pt_pos)
    z = pos_c[:, 2]
    uv = se3.project(K4, pos_c)
    in_img = ((uv[:, 0] >= 0) & (uv[:, 0] < width)
              & (uv[:, 1] >= 0) & (uv[:, 1] < height))
    vis = state.pt_valid & (z > 0.1) & in_img

    # scale-invariance band and view cone (Frame::isInFrustum); maps without
    # bounds (pt_dist_max == 0) skip the gate
    dist = torch.linalg.norm(pos_c, dim=-1)
    has_si = state.pt_dist_max > 0.0
    in_band = ((dist >= 0.8 * state.pt_dist_min)
               & (dist <= 1.2 * state.pt_dist_max))
    vdir_w = (pos_c / torch.clamp(dist, min=1e-9)[:, None]) @ T_pred[:3, :3]
    viewcos = torch.sum(vdir_w * state.pt_normal, dim=-1)
    vis = vis & torch.where(has_si, in_band & (viewcos > 0.5),
                            torch.ones_like(has_si))
    # predicted pyramid level (MapPoint::PredictScale) drives the radius
    scale32 = float(np.float32(pt_scale))
    log_s = float(np.log(np.float32(pt_scale)))
    n_pred = torch.ceil(torch.log(torch.clamp(state.pt_dist_max, min=1e-9)
                                  / torch.clamp(dist, min=1e-9)) / log_s)
    n_pred = torch.clamp(n_pred, 0, n_levels - 1).to(torch.int32)
    n_pred = torch.where(has_si, n_pred, torch.zeros_like(n_pred))
    pt_radius = radius * torch.pow(scale32, n_pred.to(torch.float32))

    NC = min(max_candidates, NP) if max_candidates > 0 else NP
    if NC < NP:
        # stable compaction of the in-frustum rows (overflow drops the
        # newest slots first)
        pos = torch.cumsum(vis.to(torch.int32), 0) - 1
        tgt = torch.where(vis & (pos < NC), pos, torch.full_like(pos, NC))
        cand = torch.zeros(NC + 1, dtype=torch.int64, device=dev).scatter_(
            0, tgt.to(torch.int64), torch.arange(NP, device=dev))[:NC]
        n_cand = torch.clamp(torch.sum(vis), max=NC)
        cand_valid = torch.arange(NC, device=dev) < n_cand
        pt_desc = state.pt_desc[cand]
        pt_angle = state.pt_angle[cand]
        uv_c, rad_c = uv[cand], pt_radius[cand]
        lvl_c, si_c = n_pred[cand], has_si[cand]
    else:
        cand = torch.arange(NP, device=dev)
        cand_valid = vis
        pt_desc, pt_angle = state.pt_desc, state.pt_angle
        uv_c, rad_c, lvl_c, si_c = uv, pt_radius, n_pred, has_si

    padp = -NC % TILE_C
    if kp_octave is None:
        oct_ = torch.zeros((K,), dtype=torch.int32, device=dev)
        si_p = torch.zeros((NC + padp,), dtype=torch.bool, device=dev)
    else:
        oct_ = kp_octave
        si_p = _pad_rows(si_c, padp, False)
    best_d, best_pt, second, pbest_k = gated_top2_hamming(
        kp_desc, kp_uv, kp_valid, oct_, _pad_rows(pt_desc, padp),
        _pad_rows(uv_c, padp, 1e9), _pad_rows(rad_c, padp),
        _pad_rows(lvl_c, padp), si_p, _pad_rows(cand_valid, padp, False))
    best_pt = best_pt.to(torch.int64)
    pbest_k = pbest_k[:NC]

    ok = best_d <= max_hamming
    # ambiguity (ratio) test against the second-best candidate
    ok = ok & (best_d < 0.85 * second)
    # mutual best
    k_idx = torch.arange(K, device=dev)
    ok = ok & (pbest_k[best_pt] == k_idx)
    if kp_angle is not None:
        ok = rotation_consistency(ok, kp_angle - pt_angle[best_pt])
    mp_idx = torch.where(ok, cand[best_pt], torch.full_like(cand[best_pt], -1))
    return PointMatches(mp_idx=mp_idx, n_matches=torch.sum(ok), visible=vis)


def dedup_matches(mp_idx: torch.Tensor, n_points: int) -> torch.Tensor:
    """(K,) map-point ids with possible duplicates -> one keypoint per map
    point (the later keypoint keeps it)."""
    K = mp_idx.shape[0]
    k_idx = torch.arange(K, device=mp_idx.device)
    tgt = torch.where(mp_idx >= 0, mp_idx, torch.full_like(mp_idx, n_points))
    owner = _last_writer(n_points + 1, tgt, k_idx)
    return torch.where(owner[torch.clamp(mp_idx, min=0)] == k_idx, mp_idx,
                       torch.full_like(mp_idx, -1))


def match_reference_kf(state: MapState, kf_id, kp_desc, kp_valid,
                       max_hamming: float = TH_LOW, ratio: float = 0.75,
                       kp_word=None, kf_word=None) -> PointMatches:
    """Frame <-> keyframe descriptor matching through the keyframe's
    observation table (SearchByBoW): pairs restricted to the same word when
    word ids are given, ratio test, mutual check, one keypoint per point."""
    kdesc = state.kf_desc[kf_id]
    row = state.kf_mp[kf_id]
    kvalid = (state.kf_kp_valid[kf_id] & (row >= 0)
              & state.pt_valid[torch.clamp(row, min=0)])
    ham = hamming_matrix(kp_desc, kdesc)
    gate = kp_valid[:, None] & kvalid[None, :]
    if kp_word is not None and kf_word is not None:
        gate = gate & (kp_word[:, None] == kf_word[None, :])
    D = torch.where(gate, ham, torch.full_like(ham, torch.inf))
    best_j = torch.argmin(D, 1)
    k_idx = torch.arange(D.shape[0], device=D.device)
    best_d = D[k_idx, best_j]
    masked = D.scatter(1, best_j[:, None], torch.inf)
    second = torch.amin(masked, 1)
    ok = (best_d <= max_hamming) & (best_d < ratio * second)
    best_i = torch.argmin(D, 0)
    ok = ok & (best_i[best_j] == k_idx)
    mp = torch.where(ok, row[best_j].to(torch.int64),
                     torch.full_like(best_j, -1))
    mp_idx = dedup_matches(mp, state.pt_pos.shape[0])
    return PointMatches(mp_idx=mp_idx, n_matches=torch.sum(mp_idx >= 0),
                        visible=state.pt_valid)


class PlaneMatches(NamedTuple):
    match_idx: torch.Tensor   # (P,) map-plane id or -1 (direct association)
    par_idx: torch.Tensor     # (P,) parallel-relation map plane or -1
    ver_idx: torch.Tensor     # (P,) vertical-relation map plane or -1
    obs_world: torch.Tensor   # (P, 4) observed planes in world frame


def _masked_argbest(mask, score):
    """argmax of score over dim 1 where mask, -1 for rows with no entry."""
    best = torch.argmax(torch.where(mask, score, torch.full_like(score, -torch.inf)), 1)
    return torch.where(torch.any(mask, 1), best, torch.full_like(best, -1))


def match_planes(state: MapState, coeffs_c, valid, T_cw,
                 assoc_ang: float = 0.985, assoc_dis: float = 0.05,
                 par_th: float = 0.9962, ver_th: float = 0.0871
                 ) -> PlaneMatches:
    """PlaneMatcher::SearchMapByCoefficients (PlaneMatcher.cpp:11-94)."""
    obs_w = se3.plane_to_world(T_cw, coeffs_c)
    n_obs = obs_w[:, :3]
    cosang = torch.abs(n_obs @ state.pl_coef[:, :3].T)       # (P, NF)
    dist = torch.abs(torch.einsum("pc,fqc->pfq", n_obs, state.pl_cloud)
                     + obs_w[:, 3][:, None, None])
    dist = torch.where(state.pl_cloud_valid[None], dist,
                       torch.full_like(dist, torch.inf))
    mind = torch.amin(dist, -1)                              # (P, NF)

    live = state.pl_valid[None, :] & valid[:, None]
    direct = live & (cosang > assoc_ang) & (mind < assoc_dis)
    par = live & (cosang > par_th) & ~direct
    ver = live & (cosang < ver_th)
    return PlaneMatches(match_idx=_masked_argbest(direct, -mind),
                        par_idx=_masked_argbest(par, cosang),
                        ver_idx=_masked_argbest(ver, -cosang),
                        obs_world=obs_w)


class LineMatches(NamedTuple):
    ml_idx: torch.Tensor      # (L,) map-line id or -1
    n_matches: torch.Tensor


def match_lines_projection(state: MapState, lf_seg2d, lf_desc, lf_valid,
                           T_pred, K4, radius: float = 40.0,
                           max_hamming: float = 90.0,
                           width: int = 640, height: int = 480
                           ) -> LineMatches:
    """LSDmatcher capability: Hamming over binary line descriptors gated by
    the projected midpoint distance, mutual best."""
    mid_w = 0.5 * (state.ln_ep[:, :3] + state.ln_ep[:, 3:])
    mid_c = se3.transform_points(T_pred, mid_w)
    uv = se3.project(K4, mid_c)
    vis = (state.ln_valid & (mid_c[:, 2] > 0.1)
           & (uv[:, 0] >= -50) & (uv[:, 0] < width + 50)
           & (uv[:, 1] >= -50) & (uv[:, 1] < height + 50))
    mid_f = 0.5 * (lf_seg2d[:, :2] + lf_seg2d[:, 2:])
    ham = hamming_matrix(lf_desc, state.ln_desc)
    d2 = torch.sum((mid_f[:, None] - uv[None]) ** 2, -1)
    gate = (d2 < radius * radius) & vis[None] & lf_valid[:, None]
    D = torch.where(gate, ham, torch.full_like(ham, torch.inf))
    best = torch.argmin(D, 1)
    l_idx = torch.arange(D.shape[0], device=D.device)
    ok = D[l_idx, best] <= max_hamming
    best_rev = torch.argmin(D, 0)
    ok = ok & (best_rev[best] == l_idx)
    ml_idx = torch.where(ok, best, torch.full_like(best, -1))
    return LineMatches(ml_idx=ml_idx, n_matches=torch.sum(ok))


def build_pose_obs(state: MapState, feats: FrameFeatures,
                   mp_idx: torch.Tensor, pm: PlaneMatches,
                   lm_idx: torch.Tensor, n_struct: int = 16
                   ) -> PoseObservations:
    """Assemble the fixed-capacity observation set for pose_optimize."""
    ok = mp_idx >= 0
    pt_world = state.pt_pos[torch.clamp(mp_idx, min=0)]
    pt_obs = torch.cat([feats.kp.uv, feats.kp_ur[:, None]], -1)
    inv_sigma2 = 1.0 / torch.clamp(feats.kp.sigma2, min=1e-6)

    lok = lm_idx >= 0
    ln_world = state.ln_ep[torch.clamp(lm_idx, min=0)]
    ln_obs = feats.lines.lineq

    pok = pm.match_idx >= 0
    pl_world = state.pl_coef[torch.clamp(pm.match_idx, min=0)]

    def pad_to(x, n):
        return _pad_rows(x, max(0, n - x.shape[0]))[:n]

    par_ok = pm.par_idx >= 0
    ver_ok = pm.ver_idx >= 0
    par_world = state.pl_coef[torch.clamp(pm.par_idx, min=0)]
    ver_world = state.pl_coef[torch.clamp(pm.ver_idx, min=0)]
    coeffs = feats.planes.coeffs
    return PoseObservations(
        pt_world=pt_world, pt_obs=pt_obs, pt_inv_sigma2=inv_sigma2,
        pt_valid=ok & feats.kp.valid,
        ln_world=ln_world, ln_obs=ln_obs,
        # cell-grid line endpoints carry a few px of noise: 1/sigma^2 = 0.25
        ln_inv_sigma2=torch.full((ln_obs.shape[0],), 0.25, device=ln_obs.device),
        ln_valid=lok & feats.lines.valid,
        pl_world=pl_world, pl_obs=coeffs, pl_valid=pok & feats.planes.valid,
        par_world=pad_to(par_world, n_struct),
        par_obs=pad_to(coeffs, n_struct),
        par_valid=pad_to(par_ok & feats.planes.valid, n_struct),
        ver_world=pad_to(ver_world, n_struct),
        ver_obs=pad_to(coeffs, n_struct),
        ver_valid=pad_to(ver_ok & feats.planes.valid, n_struct),
    )


def update_point_stats(state: MapState, visible, mp_idx) -> MapState:
    """MapPoint IncreaseVisible / IncreaseFound bookkeeping."""
    found = torch.zeros_like(state.pt_found).index_add_(
        0, torch.clamp(mp_idx, min=0), (mp_idx >= 0).to(state.pt_found.dtype))
    return state._replace(
        pt_visible=state.pt_visible + visible.to(state.pt_visible.dtype),
        pt_found=state.pt_found + found)
