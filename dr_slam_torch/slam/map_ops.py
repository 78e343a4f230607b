"""Map operations: per-frame association, keyframe insertion and the local
mapping pass.

Counterpart of the JAX package's `slam/map_ops.py`. The per-frame half:
projection matching, reference-keyframe matching, plane and line
association, pose-observation assembly and the landmark visibility
statistics (ORBmatcher::SearchByProjection / SearchByBoW, PlaneMatcher::
SearchMapByCoefficients, LSDmatcher). The keyframe half: `add_keyframe`
(CreateNewKeyFrame), `cull_map`, `triangulate_with_kf`, `fuse_new_points`
and `cull_one_keyframe` (LocalMapping), `creation_block_mask` and
`covisible_keyframes`.

Every function returns new tensors and never writes into the state it was
given: a deferred frame may still hold that state. Scatters whose targets
may repeat (`.at[].set` in the reference, last write wins on the CPU) are
written as scatter-max over the writer index, which is the same result and
deterministic on the GPU; the reference's `mode="drop"` (index = capacity)
goes to a dump row. Keyframe ids stay device scalars: no function here reads
a value back to the host."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.associate.vocabulary import word_ids
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.frontend.frame import FrameFeatures
from dr_slam_torch.geometry import se3
from dr_slam_torch.ops.hamming import hamming_matrix
from dr_slam_torch.ops.match_cuda import TILE_C, gated_top2_hamming
from dr_slam_torch.ops.orb import bits_to_signs, unpack_bits
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


def _scatter_set(table: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """`table.at[idx].set(values, mode="drop")` as a new tensor: rows whose
    index is >= len(table) are dropped, and where indices repeat the last
    writer wins. `values` has one row per index or broadcasts to it."""
    n = table.shape[0]
    idx = torch.clamp(idx.to(torch.int64), max=n)
    writer = _last_writer(n + 1, idx, torch.arange(idx.shape[0],
                                                   device=idx.device))[:n]
    values = torch.as_tensor(values, dtype=table.dtype, device=table.device)
    values = values.expand((idx.shape[0],) + tuple(table.shape[1:]))
    hit = (writer >= 0).reshape((n,) + (1,) * (table.dim() - 1))
    return torch.where(hit, values[torch.clamp(writer, min=0)], table)


def _scatter_add(table: torch.Tensor, idx: torch.Tensor, values) -> torch.Tensor:
    """`table.at[idx].add(values, mode="drop")` as a new tensor."""
    n = table.shape[0]
    out = torch.cat([table, torch.zeros_like(table[:1])])
    values = torch.as_tensor(values, device=table.device).to(table.dtype)
    out.index_add_(0, torch.clamp(idx.to(torch.int64), max=n),
                   values.expand((idx.shape[0],) + tuple(table.shape[1:])))
    return out[:n]


def _row(table: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """`table[i]` for a device scalar index, as a gather."""
    return table.index_select(0, i.reshape(1).to(torch.int64))[0]


def _set_row(table: torch.Tensor, i: torch.Tensor, value) -> torch.Tensor:
    """`table.at[i].set(value)` for a device scalar index, as a new tensor."""
    value = torch.as_tensor(value, dtype=table.dtype, device=table.device)
    return table.index_copy(0, i.reshape(1).to(torch.int64),
                            value.expand(table.shape[1:])[None])


def _free_slots(valid: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N,) int64: the free slots in ascending order, then the
    used ones."""
    n = valid.shape[0]
    idx = torch.arange(n, device=valid.device)
    return torch.argsort(torch.where(valid, idx + n, idx))


def _allocate(want: torch.Tensor, valid: torch.Tensor) -> tuple:
    """Slot allocation of the reference: the r-th wanted row takes the r-th
    free slot while free slots last. -> (can (R,) bool, slot (R,) int64,
    len(valid) where nothing is allocated)."""
    n = valid.shape[0]
    rank = torch.cumsum(want.to(torch.int64), 0) - 1
    can = want & (rank < torch.sum(~valid))
    slot = torch.where(can, _free_slots(valid)[torch.clamp(rank, 0, n - 1)], n)
    return can, slot


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


_MATCH_CHUNK = 4096  # map points per chunk where a (K, NP) table is built


def creation_block_mask(state: MapState, kp_uv, kp_depth, T_cw, K4,
                        radius: float = 5.0) -> torch.Tensor:
    """(K,) bool: a valid map point already projects within `radius` px of
    the keypoint at a compatible depth (duplicate-landmark prevention, the
    role of ORBmatcher::Fuse in SearchInNeighbors, LocalMapping.cc:1039)."""
    pos_c = se3.transform_points(T_cw, state.pt_pos)
    uv = se3.project(K4, pos_c)
    z = pos_c[:, 2]
    ok = state.pt_valid & (z > 0.1)
    blocked = torch.zeros(kp_uv.shape[0], dtype=torch.bool, device=kp_uv.device)
    for s in range(0, uv.shape[0], _MATCH_CHUNK):
        uvc, zc, okc = (x[s:s + _MATCH_CHUNK] for x in (uv, z, ok))
        du = torch.abs(kp_uv[:, 0:1] - uvc[None, :, 0])
        dv = torch.abs(kp_uv[:, 1:2] - uvc[None, :, 1])
        ratio = kp_depth[:, None] / torch.clamp(zc[None, :], min=1e-6)
        near = ((du < radius) & (dv < radius) & okc[None, :]
                & (ratio > 0.8) & (ratio < 1.25))
        blocked = blocked | torch.any(near, dim=1)
    return blocked


def add_keyframe(state: MapState, feats: FrameFeatures, T_cw, ts: float,
                 mp_idx, pm: PlaneMatches, lm_idx, bow, cfg: SlamConfig,
                 blocked=None) -> tuple[MapState, torch.Tensor]:
    """Insert a keyframe into the lowest free slot (CreateNewKeyFrame,
    Tracking.cc:3040): new map points from depth, the matched points'
    descriptor ring, viewing direction and scale band, the keyframe row,
    matched planes averaged and unmatched ones added, matched lines
    refreshed and unmatched 3D lines added. -> (state, slot as a device
    scalar)."""
    dev = T_cw.device
    i32 = torch.int32
    NP = cfg.map.max_points
    mp_idx = mp_idx.to(torch.int64)
    k = _free_slots(state.kf_valid)[0]
    T_wc = se3.inv_T(T_cw)
    cam_center = T_wc[:3, 3]

    # ---- new map points from depth -----------------------------------------
    creatable = (feats.kp.valid & (feats.kp_depth > 1e-3)
                 & (feats.kp_depth < 8.0) & (mp_idx < 0))
    if blocked is not None:
        creatable = creatable & ~blocked
    can, slot = _allocate(creatable, state.pt_valid)
    pos_w = se3.transform_points(T_wc, feats.kp_xyz)
    view = pos_w - cam_center
    view = view / torch.clamp(torch.linalg.norm(view, dim=-1, keepdim=True),
                              min=1e-9)
    pt_pos = _scatter_set(state.pt_pos, slot, pos_w)
    pt_normal = _scatter_set(state.pt_normal, slot, view)
    pt_angle = _scatter_set(state.pt_angle, slot, feats.kp.angle)
    # scale band (MapPoint::UpdateNormalAndDepth): sigma2 = scale^(2 oct)
    lvl_factor = torch.sqrt(feats.kp.sigma2)
    span = float(cfg.orb.scale_factor) ** (cfg.orb.n_levels - 1)
    dmax_new = torch.linalg.norm(pos_w - cam_center, dim=-1) * lvl_factor
    pt_dmax = _scatter_set(state.pt_dist_max, slot, dmax_new)
    pt_dmin = _scatter_set(state.pt_dist_min, slot, dmax_new / span)
    pt_desc = _scatter_set(state.pt_desc, slot, feats.kp.desc)
    pt_valid = _scatter_set(state.pt_valid, slot, True)
    pt_visible = _scatter_set(state.pt_visible, slot, 1)
    pt_found = _scatter_set(state.pt_found, slot, 1)
    pt_first = _scatter_set(state.pt_first_kf, slot, k)

    kf_mp_row = torch.where(can & (slot < NP), slot, mp_idx)
    pt_obs = _scatter_add(state.pt_obs_count, torch.clamp(kf_mp_row, min=0),
                          kf_mp_row >= 0)
    # descriptor ring (MapPoint::ComputeDistinctiveDescriptors): the
    # representative is the ring entry of least median distance to the rest
    Kk = feats.kp.desc.shape[0]
    R = state.pt_desc_ring.shape[1]
    m_tgt = torch.where(mp_idx >= 0, mp_idx, NP)
    ring_slot = state.pt_obs_count[torch.clamp(mp_idx, min=0)] % R
    pt_ring = _scatter_set(state.pt_desc_ring, slot,
                           feats.kp.desc[:, None, :].expand(Kk, R, 8))
    pt_ring = _scatter_set(pt_ring.reshape(NP * R, 8),
                           torch.where(mp_idx >= 0, m_tgt * R + ring_slot,
                                       NP * R),
                           feats.kp.desc).reshape(NP, R, 8)
    ring_m = pt_ring[torch.clamp(m_tgt, 0, NP - 1)]              # (K, R, 8)
    sg = bits_to_signs(unpack_bits(ring_m.reshape(-1, 8))).reshape(Kk, R, 256)
    ham = (256.0 - torch.einsum("krc,kqc->krq", sg, sg)) * 0.5
    ham = torch.where(torch.eye(R, dtype=torch.bool, device=dev)[None],
                      torch.inf, ham)
    med = torch.sort(ham, dim=-1).values[:, :, (R - 2) // 2]   # median of R-1
    best_r = torch.argmin(med, dim=-1)
    distinct = torch.gather(ring_m, 1, best_r[:, None, None].expand(Kk, 1, 8))
    pt_desc = _scatter_set(pt_desc, m_tgt, distinct[:, 0])
    pt_angle = _scatter_set(pt_angle, m_tgt, feats.kp.angle)
    # re-observed points: running-mean viewing direction, refreshed band
    cl = torch.clamp(mp_idx, 0, NP - 1)
    obs_pos = state.pt_pos[cl]
    view_m = obs_pos - cam_center
    view_m = view_m / torch.clamp(torch.linalg.norm(view_m, dim=-1, keepdim=True),
                                  min=1e-9)
    n_mean = (pt_normal[cl] * state.pt_obs_count[cl].to(torch.float32)[:, None]
              + view_m)
    n_mean = n_mean / torch.clamp(torch.linalg.norm(n_mean, dim=-1, keepdim=True),
                                  min=1e-9)
    pt_normal = _scatter_set(pt_normal, m_tgt, n_mean)
    dmax_obs = torch.linalg.norm(obs_pos - cam_center, dim=-1) * lvl_factor
    pt_dmax = _scatter_set(pt_dmax, m_tgt, dmax_obs)
    pt_dmin = _scatter_set(pt_dmin, m_tgt, dmax_obs / span)

    # ---- keyframe row -----------------------------------------------------
    kf_valid = _set_row(state.kf_valid, k, True)
    state = state._replace(
        pt_pos=pt_pos, pt_normal=pt_normal, pt_desc=pt_desc,
        pt_desc_ring=pt_ring, pt_valid=pt_valid, pt_visible=pt_visible,
        pt_found=pt_found, pt_first_kf=pt_first, pt_obs_count=pt_obs,
        pt_angle=pt_angle, pt_dist_min=pt_dmin, pt_dist_max=pt_dmax,
        kf_pose=_set_row(state.kf_pose, k, T_cw),
        kf_valid=kf_valid,
        kf_seq=_set_row(state.kf_seq, k, state.kf_next_seq),
        kf_next_seq=state.kf_next_seq + 1,
        kf_ts=_set_row(state.kf_ts, k, ts),
        kf_uv=_set_row(state.kf_uv, k, feats.kp.uv),
        kf_ur=_set_row(state.kf_ur, k, feats.kp_ur),
        kf_xyz=_set_row(state.kf_xyz, k, feats.kp_xyz),
        kf_desc=_set_row(state.kf_desc, k, feats.kp.desc),
        kf_sigma2=_set_row(state.kf_sigma2, k, feats.kp.sigma2),
        kf_angle=_set_row(state.kf_angle, k, feats.kp.angle),
        kf_kp_valid=_set_row(state.kf_kp_valid, k, feats.kp.valid),
        kf_mp=_set_row(state.kf_mp, k, kf_mp_row),
        kf_bow=_set_row(state.kf_bow, k, bow),
        # word ids cached at insertion (track_step reads kf_word[ref_kf])
        kf_word=_set_row(state.kf_word, k,
                         word_ids(feats.kp.desc, state.kf_bow.shape[1])),
        n_kfs=torch.sum(kf_valid).to(i32),
    )

    # ---- planes: average the matched, add the unmatched --------------------
    NF = cfg.map.max_planes
    Q = cfg.plane.cloud_points
    cloud_w = se3.transform_points(T_wc, feats.planes.cloud.reshape(-1, 3)
                                   ).reshape(feats.planes.cloud.shape)
    match = pm.match_idx.to(torch.int64)
    matched = match >= 0
    mids = torch.clamp(match, min=0)
    mids_w = torch.where(matched, mids, NF)
    # running-average coefficients (MapPlane::UpdateCoefficientsAndPoints);
    # two observed planes may match one map plane: the later one wins
    w_old = state.pl_obs_count[mids].to(torch.float32)[:, None]
    new_coef = se3.normalize_plane(
        (state.pl_coef[mids] * w_old + pm.obs_world) / (w_old + 1.0))
    pl_coef = _scatter_set(state.pl_coef, mids_w, new_coef)
    # refresh half the cloud samples (ring offset by the observation count)
    half = torch.arange(Q // 2, device=dev) * 2
    ring = half[None, :] + (state.pl_obs_count[mids] % 2)[:, None]
    upd_ok = feats.planes.cloud_valid[:, half] & matched[:, None]
    cell = torch.where(upd_ok, mids[:, None] * Q + ring, NF * Q).reshape(-1)
    pl_cloud = _scatter_set(state.pl_cloud.reshape(NF * Q, 3), cell,
                            cloud_w[:, half].reshape(-1, 3)).reshape(NF, Q, 3)
    pl_cloud_valid = _scatter_set(state.pl_cloud_valid.reshape(NF * Q), cell,
                                  True).reshape(NF, Q)
    pl_obs = _scatter_add(state.pl_obs_count, mids_w, 1)

    pcan, pslot = _allocate(feats.planes.valid & ~matched, state.pl_valid)
    pl_coef = _scatter_set(pl_coef, pslot, pm.obs_world)
    pl_cloud = _scatter_set(pl_cloud, pslot, cloud_w)
    pl_cloud_valid = _scatter_set(pl_cloud_valid, pslot,
                                  feats.planes.cloud_valid)
    # per-keyframe plane observations (KeyFrame::AddMapPlane)
    kf_pl_row = torch.where(matched, match,
                            torch.where(pcan & (pslot < NF), pslot, -1))
    pvalid = feats.planes.valid
    state = state._replace(
        pl_coef=pl_coef, pl_cloud=pl_cloud, pl_cloud_valid=pl_cloud_valid,
        pl_valid=_scatter_set(state.pl_valid, pslot, True),
        pl_obs_count=_scatter_set(pl_obs, pslot, 1),
        pl_first_kf=_scatter_set(state.pl_first_kf, pslot, k),
        kf_pl=_set_row(state.kf_pl, k, torch.where(pvalid, kf_pl_row, -1)),
        kf_pl_par=_set_row(state.kf_pl_par, k,
                           torch.where(pvalid, pm.par_idx, -1)),
        kf_pl_ver=_set_row(state.kf_pl_ver, k,
                           torch.where(pvalid, pm.ver_idx, -1)),
        kf_pl_obs=_set_row(state.kf_pl_obs, k, feats.planes.coeffs))

    # ---- lines: refresh the matched, add the unmatched 3D lines ------------
    NL = cfg.map.max_lines
    lf = feats.lines
    ep_w = torch.cat([se3.transform_points(T_wc, lf.ep3d[:, :3]),
                      se3.transform_points(T_wc, lf.ep3d[:, 3:])], -1)
    dir_w = lf.dir3d @ T_wc[:3, :3].T
    lm = lm_idx.to(torch.int64)
    lmatched = lm >= 0
    lmc = torch.clamp(lm, min=0)
    ln_found = _scatter_add(state.ln_found, lmc, lmatched)
    ln_obs = _scatter_add(state.ln_obs_count, lmc, lmatched)
    lcan, lslot = _allocate(lf.has3d & ~lmatched, state.ln_valid)
    kf_ln_row = torch.where(lmatched, lm,
                            torch.where(lcan & (lslot < NL), lslot, -1))
    # matched-line refresh (MapLine::UpdateAverageDir) only where the
    # directions agree (< ~11 deg): obs-weighted mean direction, endpoints
    # at the extremes of old and new along it
    d_old = state.ln_dir[lmc]
    dot_od = torch.sum(d_old * dir_w, -1, keepdim=True)
    lm_tgt = torch.where(lmatched & (torch.abs(dot_od[:, 0]) > 0.98), lm, NL)
    flip = torch.sign(dot_od)
    flip = torch.where(flip == 0.0, 1.0, flip)
    w_obs = state.ln_obs_count[lmc].to(torch.float32)[:, None]
    d_avg = d_old * w_obs + dir_w * flip
    d_avg = d_avg / torch.clamp(torch.linalg.norm(d_avg, dim=-1, keepdim=True),
                                min=1e-9)
    eps4 = torch.stack([state.ln_ep[lmc, :3], state.ln_ep[lmc, 3:],
                        ep_w[:, :3], ep_w[:, 3:]], 1)            # (Fl, 4, 3)
    ctr = torch.mean(eps4, 1)
    s4 = torch.einsum("fpc,fc->fp", eps4 - ctr[:, None], d_avg)
    ep_lo = ctr + torch.amin(s4, 1)[:, None] * d_avg
    ep_hi = ctr + torch.amax(s4, 1)[:, None] * d_avg
    ln_ep = _scatter_set(state.ln_ep, lm_tgt, torch.cat([ep_lo, ep_hi], -1))
    ln_dir = _scatter_set(state.ln_dir, lm_tgt, d_avg)
    ln_valid = _scatter_set(state.ln_valid, lslot, True)
    state = state._replace(
        ln_ep=_scatter_set(ln_ep, lslot, ep_w),
        ln_dir=_scatter_set(ln_dir, lslot, dir_w),
        ln_desc=_scatter_set(state.ln_desc, lslot, lf.desc),
        ln_valid=ln_valid,
        ln_obs_count=_scatter_set(ln_obs, lslot, 1),
        ln_found=_scatter_set(ln_found, lslot, 1),
        ln_visible=_scatter_set(state.ln_visible, lslot, 1),
        ln_first_kf=_scatter_set(state.ln_first_kf, lslot, k),
        kf_ln=_set_row(state.kf_ln, k, torch.where(lf.valid, kf_ln_row, -1)),
        kf_ln_obs=_set_row(state.kf_ln_obs, k, lf.lineq),
        kf_ln_xyz=_set_row(state.kf_ln_xyz, k,
                           torch.where(lf.has3d[:, None], lf.ep3d, 0.0)),
        n_lns=torch.sum(ln_valid).to(i32),
        n_pts=torch.sum(pt_valid).to(i32),
    )
    return state, k


def _remap(tab: torch.Tensor, redirect: torch.Tensor,
           alive: torch.Tensor) -> torch.Tensor:
    """Rewrite an id table through `redirect`; ids of dead landmarks -> -1."""
    t = torch.where(tab >= 0, redirect[torch.clamp(tab, min=0).to(torch.int64)],
                    -1)
    return torch.where((t >= 0) & alive[torch.clamp(t, min=0)], t,
                       -1).to(tab.dtype)


def cull_map(state: MapState, merge_angle_cos: float = 0.985,
             merge_dist: float = 0.05) -> MapState:
    """LocalMapping culling (LocalMapping.cc:175-276): points and lines
    matched in too few of their sightings die, duplicate lines fuse into
    the one with more observations, duplicate planes merge into the lower
    slot, and the keyframe observation tables follow."""
    f32 = torch.float32
    vis = torch.clamp(state.pt_visible, min=1)
    ratio = state.pt_found.to(f32) / vis.to(f32)
    bad = state.pt_valid & (state.pt_visible > 8) & (ratio < 0.25)
    pt_valid = state.pt_valid & ~bad
    # dead points leave every observing keyframe (MapPoint::SetBadFlag)
    stale = (state.kf_mp >= 0) & ~pt_valid[torch.clamp(state.kf_mp, min=0)]
    kf_mp = torch.where(stale, -1, state.kf_mp)
    pt_obs_count = torch.where(pt_valid, state.pt_obs_count, 0)

    lvis = torch.clamp(state.ln_visible, min=1)
    lratio = state.ln_found.to(f32) / lvis.to(f32)
    lbad = state.ln_valid & (state.ln_visible > 8) & (lratio < 0.2)
    ln_valid = state.ln_valid & ~lbad

    # line fusion (LSDmatcher::Fuse): close endpoints in either order,
    # aligned directions, similar descriptors; the loser (fewer
    # observations, ties to the higher slot) dies, the winner takes its
    # statistics
    e1 = state.ln_ep[:, :3]
    e2 = state.ln_ep[:, 3:]
    d11 = torch.linalg.norm(e1[:, None] - e1[None], dim=-1)
    d22 = torch.linalg.norm(e2[:, None] - e2[None], dim=-1)
    d12 = torch.linalg.norm(e1[:, None] - e2[None], dim=-1)
    d21 = torch.linalg.norm(e2[:, None] - e1[None], dim=-1)
    d_pair = torch.minimum(torch.maximum(d11, d22), torch.maximum(d12, d21))
    dir_ok = torch.abs(state.ln_dir @ state.ln_dir.T) > 0.966
    lham = hamming_matrix(state.ln_desc, state.ln_desc)
    NL = e1.shape[0]
    li = torch.arange(NL, device=e1.device)
    same_pair = (ln_valid[:, None] & ln_valid[None, :] & (d_pair < 0.10)
                 & dir_ok & (lham <= 80.0) & (li[:, None] != li[None, :]))
    oc = state.ln_obs_count
    i_wins = ((oc[:, None] > oc[None, :])
              | ((oc[:, None] == oc[None, :]) & (li[:, None] < li[None, :])))
    lose_to = same_pair & i_wins                  # [i, j]: j loses to i
    loser = torch.any(lose_to, 0)
    winner_of = torch.argmax(lose_to.to(torch.int32), 0)   # first winner
    gain_tgt = torch.where(loser, winner_of, NL)
    ln_obs2 = _scatter_add(oc, gain_tgt, torch.where(loser, oc, 0))
    ln_found2 = _scatter_add(state.ln_found, gain_tgt,
                             torch.where(loser, state.ln_found, 0))
    ln_valid = ln_valid & ~loser

    # plane merge: j into i when i < j, normals aligned and i's plane
    # passes through j's cloud
    n = state.pl_coef[:, :3]
    cosang = torch.abs(n @ n.T)
    dist = torch.abs(torch.einsum("ic,jqc->ijq", n, state.pl_cloud)
                     + state.pl_coef[:, 3][:, None, None])
    dist = torch.where(state.pl_cloud_valid[None], dist, torch.inf)
    mind = torch.amin(dist, -1)
    NF = n.shape[0]
    ii = torch.arange(NF, device=n.device)
    dup = (state.pl_valid[:, None] & state.pl_valid[None, :]
           & (cosang > merge_angle_cos) & (mind < merge_dist)
           & (ii[:, None] < ii[None, :]))
    merged_away = torch.any(dup, 0)
    pl_valid = state.pl_valid & ~merged_away

    # keyframe structure tables follow the merges and deaths
    pl_redirect = torch.where(merged_away, torch.argmax(dup.to(torch.int32), 0),
                              ii)
    ln_redirect = torch.where(loser, winner_of, li)
    return state._replace(
        pt_valid=pt_valid, pl_valid=pl_valid, ln_valid=ln_valid, kf_mp=kf_mp,
        kf_pl=_remap(state.kf_pl, pl_redirect, pl_valid),
        kf_pl_par=_remap(state.kf_pl_par, pl_redirect, pl_valid),
        kf_pl_ver=_remap(state.kf_pl_ver, pl_redirect, pl_valid),
        kf_ln=_remap(state.kf_ln, ln_redirect, ln_valid),
        ln_obs_count=ln_obs2, ln_found=ln_found2,
        pt_obs_count=pt_obs_count, n_pts=torch.sum(pt_valid).to(torch.int32),
        n_lns=torch.sum(ln_valid).to(torch.int32))


def _recount_point_obs(kf_mp, kf_kp_valid, kf_valid, NP: int) -> torch.Tensor:
    """(NP,) int32 observation counts from the kf_mp table, alive keyframes
    only."""
    K = kf_mp.shape[1]
    flat = kf_mp.reshape(-1).to(torch.int64)
    ok = (flat >= 0) & kf_kp_valid.reshape(-1) & kf_valid.repeat_interleave(K)
    cnt = torch.zeros(NP + 1, dtype=torch.int32, device=kf_mp.device)
    cnt.index_add_(0, torch.where(ok, flat, NP),
                   torch.ones_like(flat, dtype=torch.int32))
    return cnt[:NP]


def _dedup_kf_rows(kf_mp: torch.Tensor) -> torch.Tensor:
    """Per keyframe row, keep only the first feature observing each map
    point (a merge can point two features of one keyframe at one point)."""
    srt, order = torch.sort(kf_mp, dim=1, stable=True)
    dup_s = (srt == torch.roll(srt, 1, dims=1)) & (srt >= 0)
    dup_s[:, 0] = False
    dup = torch.zeros_like(dup_s).scatter(1, order, dup_s)
    return torch.where(dup, -1, kf_mp)


def fuse_new_points(state: MapState, new_kf, fuse_dist: float = 0.05,
                    max_hamming: float = TH_LOW) -> MapState:
    """Merge the points that keyframe `new_kf` created into older points
    they duplicate (SearchInNeighbors / ORBmatcher::Fuse,
    LocalMapping.cc:1039)."""
    new = state.pt_valid & (state.pt_first_kf == new_kf)
    return fuse_points_mask(state, new, fuse_dist, max_hamming)


def fuse_points_mask(state: MapState, new: torch.Tensor,
                     fuse_dist: float = 0.05,
                     max_hamming: float = TH_LOW) -> MapState:
    """Merge each point in `new` into its nearest duplicate outside `new`
    (3D distance and descriptor gates); every keyframe observation of the
    loser moves to the winner, which takes its statistics
    (MapPoint::Replace)."""
    NP = state.pt_pos.shape[0]
    K = state.kf_mp.shape[1]
    dev = state.pt_pos.device
    new = state.pt_valid & new
    old = state.pt_valid & ~new

    # the (<= K) new points, compacted in slot order
    rank = torch.cumsum(new.to(torch.int64), 0) - 1
    tgt = torch.where(new & (rank < K), rank, K)
    new_ids = _scatter_set(torch.full((K + 1,), -1, dtype=torch.int64,
                                      device=dev), tgt,
                           torch.arange(NP, device=dev))[:K]
    has_new = new_ids >= 0
    ids = torch.clamp(new_ids, min=0)
    pos_new = state.pt_pos[ids]
    sg_new = bits_to_signs(unpack_bits(state.pt_desc[ids]))

    # nearest gated old point, chunk by chunk (strict < keeps the first);
    # the squared radius in float32, as the reference traces it
    r2 = float(np.float32(fuse_dist) * np.float32(fuse_dist))
    best_d = torch.full((K,), torch.inf, device=dev)
    best_old = torch.zeros((K,), dtype=torch.int64, device=dev)
    for s in range(0, NP, _MATCH_CHUNK):
        pc = state.pt_pos[s:s + _MATCH_CHUNK]
        d2 = torch.sum((pos_new[:, None] - pc[None]) ** 2, -1)
        sc = bits_to_signs(unpack_bits(state.pt_desc[s:s + _MATCH_CHUNK]))
        ham = (256.0 - sg_new @ sc.T) * 0.5
        gate = (old[None, s:s + _MATCH_CHUNK] & has_new[:, None]
                & (d2 < r2) & (ham <= max_hamming))
        D = torch.where(gate, d2, torch.inf)
        cmin, carg = torch.min(D, 1)
        upd = cmin < best_d
        best_d = torch.minimum(best_d, cmin)
        best_old = torch.where(upd, carg + s, best_old)
    fused = has_new & torch.isfinite(best_d)

    # loser -> winner redirect through the observation table
    lose_tgt = torch.where(fused, ids, NP)
    redirect = _scatter_set(torch.arange(NP, device=dev), lose_tgt, best_old)
    kf_mp = torch.where(state.kf_mp >= 0,
                        redirect[torch.clamp(state.kf_mp, min=0)].to(torch.int32),
                        state.kf_mp)
    kf_mp = _dedup_kf_rows(kf_mp)

    win = torch.where(fused, best_old, NP)
    pt_visible = _scatter_add(state.pt_visible, win,
                              torch.where(fused, state.pt_visible[ids], 0))
    pt_found = _scatter_add(state.pt_found, win,
                            torch.where(fused, state.pt_found[ids], 0))
    pt_valid = _scatter_set(state.pt_valid, lose_tgt, False)
    pt_obs = _recount_point_obs(kf_mp, state.kf_kp_valid, state.kf_valid, NP)
    return state._replace(kf_mp=kf_mp, pt_valid=pt_valid,
                          pt_visible=pt_visible, pt_found=pt_found,
                          pt_obs_count=torch.where(pt_valid, pt_obs, 0),
                          n_pts=torch.sum(pt_valid).to(torch.int32))


def cull_one_keyframe(state: MapState, redundancy: float = 0.9,
                      min_obs: int = 20, keep_recent: int = 2,
                      force: bool = False) -> MapState:
    """KeyFrameCulling (LocalMapping.cc:1226): erase the most redundant
    keyframe whose observations are >= `redundancy` seen by >= 3 other
    keyframes; the first keyframe and the `keep_recent` newest are kept.
    force=True evicts the most redundant unprotected keyframe even below the
    threshold (the capacity wall). Selected on the device, no readback."""
    NK, K = state.kf_mp.shape
    NP = state.pt_pos.shape[0]
    f32 = torch.float32
    kfm = torch.clamp(state.kf_mp, min=0)
    obs = _recount_point_obs(state.kf_mp, state.kf_kp_valid, state.kf_valid, NP)
    entry_ok = ((state.kf_mp >= 0) & state.kf_kp_valid
                & state.kf_valid[:, None] & state.pt_valid[kfm])
    well = obs[kfm] >= 4                                # self + 3 others
    n_obs = torch.sum(entry_ok, 1)
    n_red = torch.sum(entry_ok & well, 1)

    seq = state.kf_seq
    recent_th = top_k(seq, keep_recent)[0][keep_recent - 1]
    protect = (seq <= 0) | (seq >= torch.clamp(recent_th, min=1))
    ratio = n_red.to(f32) / torch.clamp(n_obs, min=1).to(f32)
    cand = (state.kf_valid & ~protect & (n_obs >= min_obs)
            & (ratio > redundancy))
    if force:
        fallback = state.kf_valid & ~protect
        score = torch.where(cand, ratio + 10.0,
                            torch.where(fallback, ratio, -1.0))
        do = torch.any(cand | fallback)
    else:
        score = torch.where(cand, ratio, -1.0)
        do = torch.any(cand)
    kill = torch.argmax(score)

    kf_valid = torch.where(do, _set_row(state.kf_valid, kill, False),
                           state.kf_valid)
    kf_mp = torch.where(do, _set_row(state.kf_mp, kill, -1), state.kf_mp)
    kf_seq = torch.where(do, _set_row(state.kf_seq, kill, -1), state.kf_seq)
    kf_kp_valid = torch.where(do, _set_row(state.kf_kp_valid, kill, False),
                              state.kf_kp_valid)

    # observation counts, liveness (a point whose only observer died dies
    # too) and an alive anchor keyframe per point
    pt_obs = _recount_point_obs(kf_mp, kf_kp_valid, kf_valid, NP)
    pt_valid = state.pt_valid & (pt_obs > 0)
    flat = kf_mp.reshape(-1).to(torch.int64)
    rows = torch.arange(NK, dtype=torch.int32,
                        device=flat.device).repeat_interleave(K)
    ok = (flat >= 0) & kf_kp_valid.reshape(-1) & kf_valid.repeat_interleave(K)
    first = torch.full((NP + 1,), NK, dtype=torch.int32, device=flat.device)
    first = first.scatter_reduce(0, torch.where(ok, flat, NP), rows,
                                 reduce="amin", include_self=True)[:NP]
    pt_first_kf = torch.where(pt_valid & (first < NK), first,
                              state.pt_first_kf)
    return state._replace(
        kf_valid=kf_valid, kf_mp=kf_mp, kf_seq=kf_seq,
        kf_kp_valid=kf_kp_valid, pt_obs_count=torch.where(pt_valid, pt_obs, 0),
        pt_valid=pt_valid, pt_first_kf=pt_first_kf,
        n_pts=torch.sum(pt_valid).to(torch.int32),
        n_kfs=torch.sum(kf_valid).to(torch.int32))


def triangulate_with_kf(state: MapState, kf_a, kf_b, K4,
                        max_hamming: float = TH_LOW,
                        epipolar_chi2: float = 3.84,
                        min_parallax_cos: float = 0.9998,
                        reproj_chi2: float = 5.991) -> MapState:
    """CreateNewMapPoints (LocalMapping.cc:309): epipolar-gated descriptor
    matching between keyframes `kf_a` (new) and `kf_b` over features with
    no landmark and no usable depth, then mid-point triangulation with the
    parallax, depth and reprojection gates. kf_a == kf_b creates nothing;
    the guard runs on the device."""
    NP = state.pt_pos.shape[0]
    K = state.kf_mp.shape[1]
    dev = state.pt_pos.device
    kf_a = torch.as_tensor(kf_a, device=dev)
    kf_b = torch.as_tensor(kf_b, device=dev)
    fx, fy, cx, cy = (float(v) for v in K4)
    Km = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                      dtype=torch.float32, device=dev)

    def free(kf):
        no_depth = ((_row(state.kf_ur, kf) < 0)
                    | (_row(state.kf_xyz, kf)[:, 2] >= 8.0))
        return (_row(state.kf_kp_valid, kf) & (_row(state.kf_mp, kf) < 0)
                & no_depth)

    free_a = free(kf_a) & (kf_a != kf_b)
    free_b = free(kf_b)
    desc_a, desc_b = _row(state.kf_desc, kf_a), _row(state.kf_desc, kf_b)
    ham = hamming_matrix(desc_a, desc_b)
    T_a, T_b = _row(state.kf_pose, kf_a), _row(state.kf_pose, kf_b)
    # fundamental matrix of the pair: F = K^-T [t]x R K^-1 (a -> b)
    T_ba = T_b @ se3.inv_T(T_a)
    R = T_ba[:3, :3]
    Kinv = torch.linalg.inv(Km)
    F = Kinv.T @ se3.hat(T_ba[:3, 3]) @ R @ Kinv

    uv_a, uv_b = _row(state.kf_uv, kf_a), _row(state.kf_uv, kf_b)
    sig2_a, sig2_b = _row(state.kf_sigma2, kf_a), _row(state.kf_sigma2, kf_b)
    ones = torch.ones((K, 1), device=dev)
    xa = torch.cat([uv_a, ones], -1)
    xb = torch.cat([uv_b, ones], -1)
    l_b = xa @ F.T                                          # epipolar lines in b
    num = torch.abs(l_b @ xb.T)                             # (Ka, Kb)
    den = torch.sqrt(l_b[:, 0] ** 2 + l_b[:, 1] ** 2)[:, None]
    d_epi = num / torch.clamp(den, min=1e-9)
    # thresholds in float32, as the reference traces them
    epi_ok = d_epi < (float(np.sqrt(np.float32(epipolar_chi2)))
                      * torch.sqrt(sig2_b)[None, :])

    gate = free_a[:, None] & free_b[None, :] & epi_ok
    D = torch.where(gate, ham, torch.inf)
    best_b = torch.argmin(D, 1)
    a_idx = torch.arange(K, device=dev)
    best_d = D[a_idx, best_b]
    rev = torch.argmin(D, 0)
    m_ok = (best_d <= max_hamming) & (rev[best_b] == a_idx)

    # mid-point triangulation in world coordinates
    T_wa, T_wb = se3.inv_T(T_a), se3.inv_T(T_b)
    o_a, o_b = T_wa[:3, 3], T_wb[:3, 3]
    ray_a = torch.stack([(uv_a[:, 0] - cx) / fx, (uv_a[:, 1] - cy) / fy,
                         torch.ones(K, device=dev)], -1) @ T_wa[:3, :3].T
    uvb = uv_b[best_b]
    ray_b = torch.stack([(uvb[:, 0] - cx) / fx, (uvb[:, 1] - cy) / fy,
                         torch.ones(K, device=dev)], -1) @ T_wb[:3, :3].T
    raa = torch.sum(ray_a * ray_a, -1)
    rbb = torch.sum(ray_b * ray_b, -1)
    rab = torch.sum(ray_a * ray_b, -1)
    dov = o_b - o_a
    pa = torch.sum(ray_a * dov, -1)
    pb = torch.sum(ray_b * dov, -1)
    det = raa * rbb - rab * rab
    safe_det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    s = (pa * rbb - pb * rab) / safe_det
    u = (pa * rab - pb * raa) / safe_det
    X = 0.5 * (o_a + s[:, None] * ray_a + o_b + u[:, None] * ray_b)

    norm_a = ray_a / torch.linalg.norm(ray_a, dim=-1, keepdim=True)
    norm_b = ray_b / torch.linalg.norm(ray_b, dim=-1, keepdim=True)
    parallax = torch.sum(norm_a * norm_b, -1)
    Xc_a = se3.transform_points(T_a, X)
    Xc_b = se3.transform_points(T_b, X)
    e_a = torch.sum((se3.project(K4, Xc_a) - uv_a) ** 2, -1) / sig2_a
    e_b = torch.sum((se3.project(K4, Xc_b) - uvb) ** 2, -1) / sig2_b[best_b]
    good = (m_ok & (Xc_a[:, 2] > 0.1) & (Xc_b[:, 2] > 0.1)
            & (parallax < min_parallax_cos) & (parallax > 0.0)
            & (e_a < reproj_chi2) & (e_b < reproj_chi2)
            & torch.all(torch.isfinite(X), -1))

    can, slot = _allocate(good, state.pt_valid)
    view = X - o_a
    dist_a = torch.linalg.norm(view, dim=-1)
    view = view / torch.clamp(dist_a[:, None], min=1e-9)
    # scale band from the creating keyframe's octave; the span is the
    # default 8-level, 1.2 pyramid's, as in the reference
    dmax_tri = dist_a * torch.sqrt(sig2_a)
    span_tri = 1.2 ** 7
    R_ring = state.pt_desc_ring.shape[1]
    state = state._replace(
        pt_pos=_scatter_set(state.pt_pos, slot, X),
        pt_normal=_scatter_set(state.pt_normal, slot, view),
        pt_dist_max=_scatter_set(state.pt_dist_max, slot, dmax_tri),
        pt_dist_min=_scatter_set(state.pt_dist_min, slot, dmax_tri / span_tri),
        pt_desc=_scatter_set(state.pt_desc, slot, desc_a),
        pt_desc_ring=_scatter_set(state.pt_desc_ring, slot,
                                  desc_a[:, None, :].expand(K, R_ring, 8)),
        pt_angle=_scatter_set(state.pt_angle, slot, _row(state.kf_angle, kf_a)),
        pt_valid=_scatter_set(state.pt_valid, slot, True),
        pt_visible=_scatter_set(state.pt_visible, slot, 2),
        pt_found=_scatter_set(state.pt_found, slot, 2),
        pt_obs_count=_scatter_set(state.pt_obs_count, slot, 2),
        pt_first_kf=_scatter_set(state.pt_first_kf, slot, kf_a),
    )
    slot_c = torch.clamp(slot, 0, NP - 1)
    row_a = _scatter_set(_row(state.kf_mp, kf_a), torch.where(can, a_idx, K),
                         slot_c)
    row_b = _scatter_set(_row(state.kf_mp, kf_b), torch.where(can, best_b, K),
                         slot_c)
    kf_mp = _set_row(_set_row(state.kf_mp, kf_a, row_a), kf_b, row_b)
    return state._replace(kf_mp=kf_mp,
                          n_pts=torch.sum(state.pt_valid).to(torch.int32))


def covisible_keyframes(state: MapState, mp_idx: torch.Tensor) -> torch.Tensor:
    """(NK,) per-keyframe count of map points shared with `mp_idx` (the
    covisibility weights of UpdateLocalKeyFrames, Tracking.cc:3447)."""
    NP = state.pt_pos.shape[0]
    mp_idx = mp_idx.to(torch.int64)
    indicator = _scatter_set(
        torch.zeros(NP + 1, dtype=torch.int32, device=mp_idx.device),
        torch.where(mp_idx >= 0, mp_idx, NP), 1)
    counts = indicator[torch.clamp(state.kf_mp, min=0)] * (state.kf_mp >= 0)
    return torch.sum(counts, -1) * state.kf_valid
