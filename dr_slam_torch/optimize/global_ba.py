"""Bundle adjustment: matrix-free Gauss-Newton with conjugate gradients over
keyframe poses, map points, planes and lines.

Counterpart of the JAX package's `optimize/global_ba.py` (the capability of
Optimizer::GlobalBundleAdjustemnt and LocalBundleAdjustment,
src/Optimizer.cc:36-600 and :2067). The Hessian is never formed: each
Gauss-Newton step weights the residuals once (Huber with a redescending
cut), and conjugate gradients solves J^T J dx = -J^T r with products
J^T (J v) from `torch.func.jvp` and one `torch.func.vjp` of the weighted
residual function, as the reference uses `jax.linearize` and `jax.vjp`.
Nothing is read back to the host. Each step's weighting and linearisation
runs in a `ba.linearize` span and its solve in a `ba.cg` span; the callers
build the problem in a `ba.problem` span."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr_slam_torch.geometry import se3
from dr_slam_torch.ops.select import top_k
from dr_slam_torch.optimize.pose_graph import _cg
from dr_slam_torch.optimize.residuals import _tangent_basis
from dr_slam_torch.utils.profiling import stage_span


class StructBlocks(NamedTuple):
    """Plane and line parameter blocks and their observation tables (the
    reference's VertexPlane with EdgePlane / EdgeParallelPlane /
    EdgeVerticalPlane, and line endpoints with EdgeLineProjectXYZ)."""
    pl_coef: torch.Tensor     # (NF, 4) initial world planes (n, d)
    pl_free: torch.Tensor     # (NF,) bool
    pobs_kf: torch.Tensor     # (Mp,) problem-keyframe index
    pobs_pl: torch.Tensor     # (Mp,) plane index
    pobs_coef: torch.Tensor   # (Mp, 4) observed camera-frame plane
    pobs_kind: torch.Tensor   # (Mp,) 0 direct, 1 parallel, 2 vertical
    pobs_valid: torch.Tensor  # (Mp,) bool
    ln_ep: torch.Tensor       # (NL, 6) initial world line endpoints
    ln_free: torch.Tensor     # (NL,) bool
    lobs_kf: torch.Tensor     # (Ml,)
    lobs_ln: torch.Tensor     # (Ml,)
    lobs_line: torch.Tensor   # (Ml, 3) observed 2D line (a, b, c)
    lobs_ep3: torch.Tensor    # (Ml, 6) measured camera-frame endpoints (0: none)
    lobs_valid: torch.Tensor  # (Ml,) bool


class BAProblem(NamedTuple):
    kf_pose: torch.Tensor     # (NK, 4, 4) initial T_cw
    pt_pos: torch.Tensor      # (NP, 3) initial world points
    obs_kf: torch.Tensor      # (M,) keyframe index per observation
    obs_pt: torch.Tensor      # (M,) map-point index
    obs_uv: torch.Tensor      # (M, 2) pixel observation
    obs_z: torch.Tensor       # (M,) observed metric depth (<= 0: none)
    obs_inv_sigma2: torch.Tensor  # (M,)
    obs_valid: torch.Tensor   # (M,) bool
    kf_free: torch.Tensor     # (NK,) bool: optimise this pose
    pt_free: torch.Tensor     # (NP,) bool
    struct: StructBlocks | None = None


def _marked(n: int, idx: torch.Tensor, flag: torch.Tensor) -> torch.Tensor:
    """(n,) bool: `zeros(n).at[idx].max(flag)`."""
    out = torch.zeros(n, dtype=torch.int32, device=idx.device)
    return out.scatter_reduce(0, idx, flag.to(torch.int32), reduce="amax") > 0


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """`x[idx]` along the first axis, with a gradient summed in a fixed
    order. The derivative of `x[idx]` accumulates with atomic adds over
    threads on the CPU, so repeated solves differ in their last bits there;
    `index_select`'s derivative (`index_add_`) adds the rows one after the
    other. CUDA keeps `x[idx]`, whose derivative sorts the indices and is
    already run-to-run equal."""
    return x[idx] if x.is_cuda else x.index_select(0, idx)


def plane_retract(pl: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """3-DoF plane update: the normal moves in its tangent plane, the
    distance adds."""
    n = pl[..., :3]
    t1, t2 = _tangent_basis(n)[:2]
    n_new = n + d[..., 0:1] * t1 + d[..., 1:2] * t2
    n_new = n_new / torch.clamp(torch.linalg.norm(n_new, dim=-1, keepdim=True),
                                min=1e-9)
    return torch.cat([n_new, pl[..., 3:4] + d[..., 2:3]], -1)


_SAFE_PLANE4 = (0.0, 0.0, 1.0, 1.0)
_SAFE_LINE6 = (0.0, 0.0, 2.0, 0.5, 0.0, 2.0)


def _struct_from_tables(state, kf_ids: torch.Tensor,
                        kf_alive: torch.Tensor) -> StructBlocks:
    """The per-keyframe structure tables of keyframes `kf_ids` (the
    problem's keyframe axis) as StructBlocks."""
    dev = kf_ids.device
    W = kf_ids.shape[0]
    Fp = state.kf_pl.shape[1]
    Fl = state.kf_ln.shape[1]
    NF = state.pl_coef.shape[0]
    NL = state.ln_ep.shape[0]
    prob_kf = torch.arange(W, device=dev).repeat_interleave(Fp)
    alive_p = kf_alive.repeat_interleave(Fp)

    def flat_pobs(tab, kind):
        ids = tab[kf_ids].reshape(-1).to(torch.int64)
        ok = (ids >= 0) & alive_p
        ids = torch.clamp(ids, min=0)
        ok = ok & state.pl_valid[ids]
        return ids, ok, torch.full_like(ids, kind)

    d_ids, d_ok, d_k = flat_pobs(state.kf_pl, 0)
    p_ids, p_ok, p_k = flat_pobs(state.kf_pl_par, 1)
    v_ids, v_ok, v_k = flat_pobs(state.kf_pl_ver, 2)
    coef = state.kf_pl_obs[kf_ids].reshape(-1, 4)

    lids = state.kf_ln[kf_ids].reshape(-1).to(torch.int64)
    lok = (lids >= 0) & kf_alive.repeat_interleave(Fl)
    lids = torch.clamp(lids, min=0)
    lok = lok & state.ln_valid[lids]
    # free exactly the landmarks these keyframes observe
    pl_free = _marked(NF, torch.where(d_ok, d_ids, 0), d_ok) & state.pl_valid
    ln_free = _marked(NL, torch.where(lok, lids, 0), lok) & state.ln_valid
    return StructBlocks(
        pl_coef=state.pl_coef, pl_free=pl_free,
        pobs_kf=prob_kf.repeat(3), pobs_pl=torch.cat([d_ids, p_ids, v_ids]),
        pobs_coef=coef.repeat(3, 1), pobs_kind=torch.cat([d_k, p_k, v_k]),
        pobs_valid=torch.cat([d_ok, p_ok, v_ok]),
        ln_ep=state.ln_ep, ln_free=ln_free,
        lobs_kf=torch.arange(W, device=dev).repeat_interleave(Fl),
        lobs_ln=lids, lobs_line=state.kf_ln_obs[kf_ids].reshape(-1, 3),
        lobs_ep3=state.kf_ln_xyz[kf_ids].reshape(-1, 6), lobs_valid=lok)


def problem_from_state(state, with_struct: bool = True) -> BAProblem:
    """The whole kf_mp observation table as a BAProblem; the first keyframe
    slot is held fixed (gauge)."""
    NK, K = state.kf_mp.shape
    dev = state.kf_mp.device
    obs_kf = torch.arange(NK, device=dev).repeat_interleave(K)
    obs_pt = state.kf_mp.reshape(-1).to(torch.int64)
    valid = ((obs_pt >= 0) & state.kf_valid[obs_kf]
             & state.kf_kp_valid.reshape(-1))
    obs_pt = torch.clamp(obs_pt, min=0)
    valid = valid & state.pt_valid[obs_pt]
    ids = torch.arange(NK, device=dev)
    struct = (_struct_from_tables(state, ids, state.kf_valid)
              if with_struct else None)
    return BAProblem(
        kf_pose=state.kf_pose, pt_pos=state.pt_pos,
        obs_kf=obs_kf, obs_pt=obs_pt, obs_uv=state.kf_uv.reshape(-1, 2),
        obs_z=state.kf_xyz[..., 2].reshape(-1),
        obs_inv_sigma2=1.0 / torch.clamp(state.kf_sigma2.reshape(-1), min=1e-6),
        obs_valid=valid, kf_free=state.kf_valid & (ids != 0),
        pt_free=state.pt_valid, struct=struct)


def local_problem_from_state(state, center_kf, window: int = 8,
                             with_struct: bool = True):
    """Local-window problem (LocalBundleAdjustment, Optimizer.cc:2067): the
    `window` keyframes most covisible with `center_kf` (ties to the lower
    slot, as lax.top_k) are free except the oldest, which anchors the gauge;
    only their observations enter and only the points they see are free.
    -> (BAProblem, window slot ids)."""
    NK, K = state.kf_mp.shape
    NP = state.pt_pos.shape[0]
    dev = state.kf_mp.device
    center_kf = torch.as_tensor(center_kf, device=dev).reshape(1)
    row = state.kf_mp.index_select(0, center_kf)[0].to(torch.int64)
    ind = _marked(NP + 1, torch.where(row >= 0, row, NP),
                  torch.ones_like(row)).to(torch.int32)
    cnt = torch.sum(ind[torch.clamp(state.kf_mp, min=0)] * (state.kf_mp >= 0),
                    -1) * state.kf_valid
    cnt = cnt.index_fill(0, center_kf, 10 ** 6)       # the centre always in
    _, win = top_k(cnt, window)
    win_ok = cnt[win] > 0
    seq = torch.where(win_ok, state.kf_seq[win], 2 ** 30)
    anchor = torch.argmin(seq)
    kf_free = win_ok & (torch.arange(window, device=dev) != anchor)

    obs_pt = state.kf_mp[win].reshape(-1).to(torch.int64)
    valid = ((obs_pt >= 0) & state.kf_kp_valid[win].reshape(-1)
             & win_ok.repeat_interleave(K))
    obs_pt = torch.clamp(obs_pt, min=0)
    valid = valid & state.pt_valid[obs_pt]
    pt_free = _marked(NP, torch.where(valid, obs_pt, 0), valid) & state.pt_valid
    struct = _struct_from_tables(state, win, win_ok) if with_struct else None
    return BAProblem(
        kf_pose=state.kf_pose[win], pt_pos=state.pt_pos,
        obs_kf=torch.arange(window, device=dev).repeat_interleave(K),
        obs_pt=obs_pt, obs_uv=state.kf_uv[win].reshape(-1, 2),
        obs_z=state.kf_xyz[win][..., 2].reshape(-1),
        obs_inv_sigma2=1.0 / torch.clamp(state.kf_sigma2[win].reshape(-1),
                                         min=1e-6),
        obs_valid=valid, kf_free=kf_free, pt_free=pt_free, struct=struct), win


def _shard_terms(p: BAProblem, K4, huber: bool, chi2_mono: float,
                 chi2_plane: float, chi2_vp: float, chi2_line: float,
                 angle_info: float, dist_info: float, line_info: float,
                 line3d_info: float):
    """The Huber weights and the weighted residuals of one problem's
    observation rows, on the problem's device. -> (weights(T, X, P, L) ->
    (w, wp, wl), res_at(xi, dX, dP, dL, cur, sws) -> the flat weighted
    residual at the update (xi, dX, dP, dL) of the parameters `cur` =
    (T, X, P, L), with the weights' square roots `sws`)."""
    dev = p.kf_pose.device
    f32 = torch.float32
    kf_freef = p.kf_free.to(f32)[:, None]
    pt_freef = p.pt_free.to(f32)[:, None]
    s = p.struct
    has_struct = s is not None

    has_z = p.obs_z > 1e-3
    sigma_z = 0.0025 * p.obs_z * p.obs_z + 0.002
    info_z = torch.where(has_z, 1.0 / (sigma_z * sigma_z), 0.0)

    if has_struct:
        pl_freef = s.pl_free.to(f32)[:, None]
        ln_freef = s.ln_free.to(f32)[:, None]
        safe_pl = torch.tensor(_SAFE_PLANE4, dtype=f32, device=dev)
        pobs_coef = torch.where(s.pobs_valid[:, None], s.pobs_coef, safe_pl)
        is_direct = (s.pobs_kind == 0)[:, None]
        is_ver = (s.pobs_kind == 2)[:, None]

    def reproj(T_all, X_all):
        """(M, 3) residual (du, dv, dz) and its validity."""
        T = _rows(T_all, p.obs_kf)
        Xc = (torch.einsum("mij,mj->mi", T[:, :3, :3], _rows(X_all, p.obs_pt))
              + T[:, :3, 3])
        uv = se3.project(K4, Xc)
        dz = torch.where(has_z, p.obs_z - Xc[:, 2], 0.0)
        r = torch.cat([p.obs_uv - uv, dz[:, None]], -1)
        return r, p.obs_valid & (Xc[:, 2] > 0.05)

    def plane_res(T_all, P_all):
        """(Mp, 3): tangent components + distance (direct), tangent
        components (parallel), normal dot (vertical)."""
        T_wc = se3.inv_T(_rows(T_all, s.pobs_kf))
        pred = torch.einsum("mi,mij->mj", _rows(P_all, s.pobs_pl), T_wc)
        pred = pred / torch.clamp(torch.linalg.norm(pred[:, :3], dim=-1,
                                                    keepdim=True), min=1e-9)
        pred = pred * torch.where(pred[:, 3:4] < 0, -1.0, 1.0)
        n_pred = pred[:, :3]
        n_obs = pobs_coef[:, :3]
        # undirected agreement: flip the observation to the prediction's
        # hemisphere (parallel and vertical relations have no orientation)
        flip = torch.where(torch.sum(n_obs * n_pred, -1, keepdim=True) < 0,
                           -1.0, 1.0)
        n_obs_d = n_obs * torch.where(is_direct, 1.0, flip)
        t1, t2 = _tangent_basis(n_pred)[:2]
        r_t1 = torch.sum(n_obs_d * t1, -1)
        r_t2 = torch.sum(n_obs_d * t2, -1)
        r_d = pobs_coef[:, 3] - pred[:, 3]
        r_dot = torch.sum(n_obs * n_pred, -1)
        return torch.stack([
            torch.where(is_ver[:, 0], r_dot, r_t1),
            torch.where(is_ver[:, 0], 0.0, r_t2),
            torch.where(is_direct[:, 0], r_d, 0.0)], -1)

    def line_res(T_all, L_all):
        """(Ml, 8): both projected endpoints against the observed 2D line,
        and each predicted endpoint's perpendicular offset from the measured
        3D line (the RGB-D anchor of the endpoints' null space)."""
        T = _rows(T_all, s.lobs_kf)
        L = _rows(L_all, s.lobs_ln)
        R, t = T[:, :3, :3], T[:, :3, 3]
        Xs = torch.einsum("mij,mj->mi", R, L[:, :3]) + t
        Xe = torch.einsum("mij,mj->mi", R, L[:, 3:]) + t
        uvs = se3.project(K4, Xs)
        uve = se3.project(K4, Xe)
        eq = s.lobs_line
        rs = eq[:, 0] * uvs[:, 0] + eq[:, 1] * uvs[:, 1] + eq[:, 2]
        re = eq[:, 0] * uve[:, 0] + eq[:, 1] * uve[:, 1] + eq[:, 2]
        ok = s.lobs_valid & (Xs[:, 2] > 0.05) & (Xe[:, 2] > 0.05)
        m1 = s.lobs_ep3[:, :3]
        m2 = s.lobs_ep3[:, 3:]
        has3 = ok & (m1[:, 2] > 0.05) & (m2[:, 2] > 0.05)
        d = m2 - m1
        d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)

        def perp(q):
            v = q - m1
            return v - torch.sum(v * d, -1, keepdim=True) * d

        w3 = has3[:, None].to(f32)
        return torch.cat([torch.stack([rs, re], -1), perp(Xs) * w3,
                          perp(Xe) * w3], -1), ok, has3

    def huberize(info, r, chi2_th):
        chi2 = torch.sum(r * r * info, -1)
        if not huber:
            return info
        hw = torch.where(chi2 <= chi2_th, 1.0,
                         torch.sqrt(chi2_th / torch.clamp(chi2, min=1e-9)))
        # redescending cut: gross outliers drop out, re-decided every step
        hw = torch.where(chi2 > 16.0 * chi2_th, 0.0, hw)
        return info * hw[:, None]

    def weights(T_all, X_all, P_all, L_all):
        r, ok = reproj(T_all, X_all)
        info = torch.stack([p.obs_inv_sigma2 * ok, p.obs_inv_sigma2 * ok,
                            info_z * ok], -1)
        w = huberize(info, r, chi2_mono)
        if not has_struct:
            return w, None, None
        rp = plane_res(T_all, P_all)
        pinfo = torch.where(
            is_direct, torch.tensor([angle_info, angle_info, dist_info],
                                    dtype=f32, device=dev),
            torch.tensor([angle_info, angle_info, 0.0], dtype=f32, device=dev))
        pinfo = pinfo * s.pobs_valid[:, None]
        chi2_p = torch.where(is_direct[:, 0],
                             torch.tensor(chi2_plane, dtype=f32, device=dev),
                             torch.tensor(chi2_vp, dtype=f32, device=dev))
        wp = huberize(pinfo, rp, chi2_p)
        rl, lok, lhas3 = line_res(T_all, L_all)
        linfo = torch.cat([line_info * lok[:, None].to(f32).expand(-1, 2),
                           line3d_info * lhas3[:, None].to(f32).expand(-1, 6)],
                          -1)
        return w, wp, huberize(linfo, rl, chi2_line)

    def res_at(xi, dX, dP, dL, cur, sws):
        T_cur, X_cur, P_cur, L_cur = cur
        sw, swp, swl = sws
        T = se3.se3_exp(xi * kf_freef) @ T_cur
        r, _ = reproj(T, X_cur + dX * pt_freef)
        parts = [(r * sw).reshape(-1)]
        if has_struct:
            Pn = plane_retract(P_cur, dP * pl_freef)
            parts.append((plane_res(T, Pn) * swp).reshape(-1))
            rl = line_res(T, L_cur + dL * ln_freef)[0]
            parts.append((rl * swl).reshape(-1))
        return torch.cat(parts)

    return weights, res_at


def bundle_adjust(p: BAProblem, K4, **kw):
    """-> (kf_pose, pt_pos), or (kf_pose, pt_pos, pl_coef, ln_ep) when the
    problem carries StructBlocks. Options as `bundle_adjust_shards`."""
    return bundle_adjust_shards([p], K4, **kw)


def bundle_adjust_shards(shards: list, K4, n_gn_iters: int = 8,
                         n_cg_iters: int = 40, damping: float = 1e-3,
                         huber: bool = True, chi2_mono: float = 5.991,
                         chi2_plane: float = 100.0, chi2_vp: float = 50.0,
                         chi2_line: float = 9.0, angle_info: float = 0.5,
                         dist_info: float = 50.0, line_info: float = 0.25,
                         line3d_info: float = 25.0):
    """`bundle_adjust` over observation shards: each shard is a BAProblem
    on its own device, holding a slice of the observation rows (`obs_*`,
    `pobs_*`, `lobs_*`) and a copy of the parameters. The Huber weights are
    per observation and stay in their shard; J^T r and every conjugate-
    gradient product J^T J v are the shards' own, moved to the first
    shard's device and summed there in shard order (the psum that XLA
    inserts for the JAX package's sharded solve). The solve and the result
    live on the first shard's device. One shard is `bundle_adjust`."""
    p = shards[0]
    dev = p.kf_pose.device
    f32 = torch.float32
    NK = p.kf_pose.shape[0]
    NP = p.pt_pos.shape[0]
    kf_freef = p.kf_free.to(f32)[:, None]
    pt_freef = p.pt_free.to(f32)[:, None]
    s = p.struct
    has_struct = s is not None
    if has_struct:
        NF = s.pl_coef.shape[0]
        NL = s.ln_ep.shape[0]
        pl_freef = s.pl_free.to(f32)[:, None]
        ln_freef = s.ln_free.to(f32)[:, None]
        # sanitise DEGENERATE rows (empty slots: zero normal, coincident
        # endpoints) before anything is differentiated: the derivative of a
        # zero vector's normalisation is NaN, and NaN times a zero weight
        # still poisons the solve. Keyed on content, not freeness.
        safe_pl = torch.tensor(_SAFE_PLANE4, dtype=f32, device=dev)
        safe_ln = torch.tensor(_SAFE_LINE6, dtype=f32, device=dev)
        pl_live = torch.linalg.norm(s.pl_coef[:, :3], dim=-1) > 0.5
        ln_live = torch.linalg.norm(s.ln_ep[:, 3:] - s.ln_ep[:, :3], dim=-1) > 1e-4
        pl0 = torch.where(pl_live[:, None], s.pl_coef, safe_pl)
        ln0 = torch.where(ln_live[:, None], s.ln_ep, safe_ln)
    else:
        NF = NL = 0
    terms = [_shard_terms(q, K4, huber, chi2_mono, chi2_plane, chi2_vp,
                          chi2_line, angle_info, dist_info, line_info,
                          line3d_info) for q in shards]

    shapes = [(NK, 6), (NP, 3), (NF, 3), (NL, 6)]
    sizes = [a * b for a, b in shapes]

    def unflat(v):
        return tuple(x.reshape(sh) for x, sh in zip(torch.split(v, sizes), shapes))

    def flat(t):
        return torch.cat([x.reshape(-1) for x in t])

    def reduce(parts):
        """Per-shard vectors summed on the parameters' device, in order."""
        total = parts[0].to(dev)
        for x in parts[1:]:
            total = total + x.to(dev)
        return total

    T_cur, X_cur = p.kf_pose, p.pt_pos
    P_cur = pl0 if has_struct else torch.zeros((0, 4), device=dev)
    L_cur = ln0 if has_struct else torch.zeros((0, 6), device=dev)
    for _ in range(n_gn_iters):
        lin = []
        with stage_span("ba.linearize"):
            for q, (weights, res_at) in zip(shards, terms):
                d = q.kf_pose.device
                cur = tuple(x.to(d) for x in (T_cur, X_cur, P_cur, L_cur))
                sws = tuple(None if w is None else torch.sqrt(w)
                            for w in weights(*cur))

                def f(xi, dX, dP, dL, res_at=res_at, cur=cur, sws=sws):
                    return res_at(xi, dX, dP, dL, cur, sws)

                zero = tuple(torch.zeros(sh, device=d) for sh in shapes)
                r0, vjp_fn = torch.func.vjp(f, *zero)
                lin.append((d, f, zero, r0, vjp_fn))
            b = reduce([flat(vjp_fn(r0)) for _, _, _, r0, vjp_fn in lin])

        def hvp(v):
            return reduce([
                flat(vjp_fn(torch.func.jvp(f, zero, unflat(v.to(d)))[1]))
                for d, f, zero, _, vjp_fn in lin])

        with stage_span("ba.cg"):
            dx = _cg(hvp, -b, n_cg_iters, damping)
            dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        dxi, dX, dP, dL = unflat(dx)
        T_cur = se3.se3_exp(dxi * kf_freef) @ T_cur
        X_cur = X_cur + dX * pt_freef
        if has_struct:
            P_cur = plane_retract(P_cur, dP * pl_freef)
            L_cur = L_cur + dL * ln_freef
    if has_struct:
        # restore fixed and degenerate rows (sanitised above)
        keep = s.pl_free & pl_live
        P_out = torch.where(keep[:, None], P_cur, s.pl_coef)
        keepl = s.ln_free & ln_live
        L_out = torch.where(keepl[:, None], L_cur, s.ln_ep)
        return T_cur, X_cur, P_out, L_out
    return T_cur, X_cur
