"""Per-frame pose optimization: Gauss-Newton with IRLS rounds.

Counterpart of the JAX package's `optimize/pose_opt.py` (Optimizer::
PoseOptimization / TranslationOptimization, src/Optimizer.cc:601-1338,
3211-3980): one SE3 (or translation-only) vertex, point / line / plane /
parallel / vertical edges and a weak motion prior, optimized as 4 rounds x
10 iterations with chi2 inlier masks between rounds and the robust kernel
dropped after round 2. Each iteration linearizes the left-multiplied
tangent update T <- se3_exp(xi) @ T with the analytic Jacobians of
`residuals.py` (the reference differentiates the same residuals with
`jax.jacfwd`), reduces H = J^T W J and b = J^T W r, and solves the damped
6x6 system. Plane, parallel and vertical edges share one batched
evaluation; the weak motion prior is linearized with the SE(3) inverse
left Jacobian.

On CUDA tensors `pose_optimize` runs the whole solve as one launch of a
hand-written kernel (`csrc/pose_gn.cu`, through `pose_gn.solve`): the plain
body is some 30,000 tiny launches a solve, bound by the host. CPU tensors
take the plain body, `_pose_optimize_plain`, which the JAX package's tests
hold."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr_slam_torch import device_const
from dr_slam_torch.geometry import se3
from dr_slam_torch.optimize import pose_gn
from dr_slam_torch.optimize import residuals as res
from dr_slam_torch.utils.profiling import stage_span

CHI2_MONO = 5.991
CHI2_STEREO = 9.488  # 4 components: (du, dv, duR, dz)
CHI2_LINE = 3.84


class PoseObservations(NamedTuple):
    """Fixed-capacity observation set for one frame's pose solve."""
    pt_world: torch.Tensor     # (NP, 3)
    pt_obs: torch.Tensor       # (NP, 3) (u, v, uR); uR<0 = mono
    pt_inv_sigma2: torch.Tensor  # (NP,)
    pt_valid: torch.Tensor     # (NP,) bool
    ln_world: torch.Tensor     # (NL, 6) 3D endpoints
    ln_obs: torch.Tensor       # (NL, 3) normalized 2D line equation
    ln_inv_sigma2: torch.Tensor
    ln_valid: torch.Tensor
    pl_world: torch.Tensor     # (NF, 4)
    pl_obs: torch.Tensor       # (NF, 4) camera-frame observation
    pl_valid: torch.Tensor
    par_world: torch.Tensor    # (NS, 4) parallel-relation planes
    par_obs: torch.Tensor
    par_valid: torch.Tensor
    ver_world: torch.Tensor    # (NS, 4) vertical-relation planes
    ver_obs: torch.Tensor
    ver_valid: torch.Tensor

    @staticmethod
    def empty(n_pt: int, n_ln: int, n_pl: int, n_st: int,
              device=None) -> "PoseObservations":
        """An observation set with every edge invalid (planes held at a
        unit normal, so the structural terms stay finite)."""
        def z(*shape):
            return torch.zeros(shape, device=device)

        def no(n):
            return torch.zeros(n, dtype=torch.bool, device=device)

        def plane(n):
            return z(n, 4).index_fill(1, torch.tensor([2], device=device),
                                      1.0)
        return PoseObservations(
            pt_world=z(n_pt, 3), pt_obs=z(n_pt, 3),
            pt_inv_sigma2=torch.ones(n_pt, device=device), pt_valid=no(n_pt),
            ln_world=z(n_ln, 6), ln_obs=z(n_ln, 3),
            ln_inv_sigma2=torch.ones(n_ln, device=device), ln_valid=no(n_ln),
            pl_world=plane(n_pl), pl_obs=plane(n_pl), pl_valid=no(n_pl),
            par_world=plane(n_st), par_obs=plane(n_st), par_valid=no(n_st),
            ver_world=plane(n_st), ver_obs=plane(n_st), ver_valid=no(n_st))


class PoseOptResult(NamedTuple):
    T_cw: torch.Tensor
    pt_inlier: torch.Tensor    # (NP,) bool
    ln_inlier: torch.Tensor
    pl_inlier: torch.Tensor
    n_inliers: torch.Tensor    # () point inliers
    chi2: torch.Tensor         # () total weighted chi2


def _huber_w(chi2, delta2):
    c = torch.sqrt(torch.clamp(chi2, min=1e-12))
    d = delta2 ** 0.5 if isinstance(delta2, float) else torch.sqrt(delta2)
    return torch.where(chi2 <= delta2, torch.ones_like(c), d / c)


class _Problem(NamedTuple):
    """Per-solve constants: the observations, the sanitized structural
    planes (plane, parallel and vertical rows stacked) and the edge
    weights."""
    obs: PoseObservations
    K4: tuple
    bf: float
    st_world: torch.Tensor     # (NF + 2 NS, 4)
    st_obs: torch.Tensor
    pl_info: torch.Tensor      # (3,) angle, angle, distance
    angle_info: float
    plane_chi2: float
    vp_chi2: float
    par_on: torch.Tensor       # (NS,) parallel edges live
    ver_on: torch.Tensor       # (NS,) vertical edges live
    prior_T: torch.Tensor | None
    prior_w: torch.Tensor | None


def _linearize(T, pb: _Problem, masks, huber_on: bool, jac: bool):
    """Residuals r, weights w (info x robust weight) and, when `jac`,
    J = d r / d xi, flattened in edge order (points, lines, planes,
    parallel, vertical, prior); plus the per-edge chi2 of points, lines and
    planes and the stereo mask."""
    obs = pb.obs
    pt_m, ln_m, pl_m = masks
    NF = obs.pl_valid.shape[0]
    NS = obs.par_valid.shape[0]
    pt = res.point_residuals(T, obs.pt_world, obs.pt_obs, obs.pt_inv_sigma2,
                             obs.pt_valid & pt_m, pb.K4, pb.bf, jac=jac)
    r_pt, i_pt, c_pt, is_st = pt[:4]
    ln = res.line_residuals(T, obs.ln_world, obs.ln_obs, obs.ln_inv_sigma2,
                            obs.ln_valid & ln_m, pb.K4, jac=jac)
    r_ln, i_ln, c_ln = ln[:3]
    e, Je = res.structural_terms(T, pb.st_world, pb.st_obs, jac=jac)
    r_pl = e[:NF, :3]
    r_par = e[NF:NF + NS, :2]
    r_ver = e[NF + NS:, 3:]
    zero = torch.zeros_like(pb.pl_info)
    i_pl = torch.where((obs.pl_valid & pl_m)[:, None], pb.pl_info, zero)
    i_par = pb.par_on[:, None] * (pb.angle_info * torch.ones_like(r_par))
    i_ver = pb.ver_on[:, None] * (pb.angle_info * torch.ones_like(r_ver))
    c_pl = torch.sum(r_pl * r_pl * i_pl, -1)

    w_pt, w_ln, w_pl, w_par, w_ver = i_pt, i_ln, i_pl, i_par, i_ver
    if huber_on:
        th_pt = torch.where(is_st, CHI2_STEREO, CHI2_MONO).to(c_pt.dtype)
        c_par = torch.sum(r_par * r_par * i_par, -1)
        c_ver = torch.sum(r_ver * r_ver * i_ver, -1)
        w_pt = i_pt * _huber_w(c_pt, th_pt)[..., None]
        w_ln = i_ln * _huber_w(c_ln, CHI2_LINE)[..., None]
        w_pl = i_pl * _huber_w(c_pl, pb.plane_chi2)[..., None]
        w_par = i_par * _huber_w(c_par, pb.vp_chi2)[..., None]
        w_ver = i_ver * _huber_w(c_ver, pb.vp_chi2)[..., None]

    parts_r = [r_pt, r_ln, r_pl, r_par, r_ver]
    parts_w = [w_pt, w_ln, w_pl, w_par, w_ver]
    parts_j = ([pt[4], ln[3], Je[:NF, :3], Je[NF:NF + NS, :2], Je[NF + NS:, 3:]]
               if jac else [])
    if pb.prior_T is not None:
        # weak motion prior: log(T T_prior^-1)
        r_prior = se3.se3_log((T @ se3.inv_T(pb.prior_T))[None])[0]
        parts_r.append(r_prior)
        parts_w.append(pb.prior_w)
        if jac:
            parts_j.append(se3.se3_left_jacobian_inv(r_prior).to(T.dtype))
    r = torch.cat([x.reshape(-1) for x in parts_r])
    w = torch.cat([x.reshape(-1) for x in parts_w])
    J = torch.cat([x.reshape(-1, 6) for x in parts_j]) if jac else None
    return r, w, J, (c_pt, c_ln, c_pl, is_st)


def pose_optimize(T_init: torch.Tensor, obs: PoseObservations, K4, bf: float,
                  translation_only: bool = False, struct_on: bool = False,
                  n_rounds: int = 4, n_iters: int = 10,
                  angle_info: float = 0.5, dist_info: float = 50.0,
                  plane_chi2: float = 100.0, vp_chi2: float = 50.0,
                  damping: float = 1e-5,
                  prior_sigma_t: float = 0.0,
                  prior_sigma_r: float = 0.0) -> PoseOptResult:
    """Optimize T_cw against the observation set; prior_sigma_t/_r > 0 add a
    weak SE3 prior around T_init. CPU tensors take the plain body; CUDA
    tensors one kernel launch, counted in `pose_optimize.launches` (an input
    the kernel does not take raises: there is no fallback)."""
    args = (T_init, obs, K4, bf, translation_only, struct_on, n_rounds,
            n_iters, angle_info, dist_info, plane_chi2, vp_chi2, damping,
            prior_sigma_t, prior_sigma_r)
    if T_init.device.type == "cpu":
        return _pose_optimize_plain(*args)
    with stage_span("pose_opt.kernel"):
        out = pose_gn.solve(*args)
    pose_optimize.launches += 1
    return PoseOptResult(*out)


pose_optimize.launches = 0


def _pose_optimize_plain(T_init: torch.Tensor, obs: PoseObservations, K4,
                         bf: float, translation_only: bool, struct_on: bool,
                         n_rounds: int, n_iters: int, angle_info: float,
                         dist_info: float, plane_chi2: float, vp_chi2: float,
                         damping: float, prior_sigma_t: float,
                         prior_sigma_r: float) -> PoseOptResult:
    """The plain PyTorch body of `pose_optimize`: the rounds and steps as
    Python loops over batched tensor ops."""
    dev, dt = T_init.device, T_init.dtype
    dim = 3 if translation_only else 6
    use_prior = prior_sigma_t > 0 and prior_sigma_r > 0
    pl_w, pl_o = res._sanitize_planes(obs.pl_world, obs.pl_obs, obs.pl_valid)
    par_on = obs.par_valid & struct_on
    ver_on = obs.ver_valid & struct_on
    par_w, par_o = res._sanitize_planes(obs.par_world, obs.par_obs, par_on)
    ver_w, ver_o = res._sanitize_planes(obs.ver_world, obs.ver_obs, ver_on)
    pb = _Problem(
        obs=obs, K4=tuple(K4), bf=bf,
        st_world=torch.cat([pl_w, par_w, ver_w]),
        st_obs=torch.cat([pl_o, par_o, ver_o]),
        pl_info=device_const((angle_info, angle_info, dist_info), dt, dev),
        angle_info=angle_info, plane_chi2=plane_chi2, vp_chi2=vp_chi2,
        par_on=par_on, ver_on=ver_on,
        prior_T=T_init if use_prior else None,
        prior_w=(device_const((1.0 / prior_sigma_t ** 2,) * 3
                              + (1.0 / prior_sigma_r ** 2,) * 3, dt, dev)
                 if use_prior else None))
    eye = torch.eye(dim, dtype=dt, device=dev)

    def lift(xi):
        if translation_only:
            xi = torch.cat([xi, torch.zeros_like(xi)])
        return se3.se3_exp(xi)

    def gn_iter(T, masks, huber_on):
        r0, w0, J, _ = _linearize(T, pb, masks, huber_on, jac=True)
        J = J[:, :dim]
        Jw = J * w0[:, None]
        H = J.T @ Jw
        b = Jw.T @ r0
        H = H + damping * eye + 1e-8 * torch.trace(H) * eye
        delta = torch.linalg.solve_ex(H, -b)[0]
        # reject non-finite updates (empty problems)
        delta = torch.where(torch.isfinite(delta).all(), delta,
                            torch.zeros_like(delta))
        return lift(delta) @ T

    def round_masks(T):
        ones = (torch.ones_like(obs.pt_valid), torch.ones_like(obs.ln_valid),
                torch.ones_like(obs.pl_valid))
        _, _, _, (c_pt, c_ln, c_pl, is_st) = _linearize(T, pb, ones, False,
                                                        jac=False)
        th_pt = torch.where(is_st, CHI2_STEREO, CHI2_MONO).to(c_pt.dtype)
        return c_pt < th_pt, c_ln < CHI2_LINE * 2.0, c_pl < plane_chi2

    masks = (torch.ones_like(obs.pt_valid), torch.ones_like(obs.ln_valid),
             torch.ones_like(obs.pl_valid))
    T = T_init
    for rnd in range(n_rounds):
        # g2o drops the robust kernel at round 3 (Optimizer.cc:1044-1330)
        huber_on = rnd < 2
        for _ in range(n_iters):
            T = gn_iter(T, masks, huber_on)
        masks = round_masks(T)

    r, w, _, _ = _linearize(T, pb, masks, False, jac=False)
    pt_in = masks[0] & obs.pt_valid
    ln_in = masks[1] & obs.ln_valid
    pl_in = masks[2] & obs.pl_valid
    return PoseOptResult(
        T_cw=T, pt_inlier=pt_in, ln_inlier=ln_in, pl_inlier=pl_in,
        n_inliers=torch.sum(pt_in), chi2=torch.sum(r * r * w))
