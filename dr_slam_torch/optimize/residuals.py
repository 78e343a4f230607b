"""Residuals of point / line / plane / structural factors as functions of the
camera pose, with their analytic Jacobians.

Counterpart of the JAX package's `optimize/residuals.py` (the reference's g2o
edges: EdgeStereoSE3ProjectXYZOnlyPose plus a metric-depth channel,
EdgeLineProjectXYZOnlyPose, EdgePlaneOnlyPose and the parallel / vertical
plane edges). Every function takes the full observation capacity with
validity masks and returns (residual block, info, per-edge chi2).

With `jac=True` a function also returns d r / d xi (..., 6) for the left
update T <- se3_exp(xi) @ T at xi = 0, xi = [rho, phi]: the derivative the
JAX package takes with `jax.jacfwd` around `lift(xi) @ T`, written out so a
Gauss-Newton step is a few hundred tensor ops instead of a forward-mode
trace. A camera-frame point Xc moves as dXc = rho + phi x Xc, so
d r / d xi = [d r / d Xc, Xc x (d r / d Xc)]."""

from __future__ import annotations

import torch

from dr_slam_torch import device_const
from dr_slam_torch.geometry import se3


def _pose_jac(dr_dX: torch.Tensor, Xc: torch.Tensor) -> torch.Tensor:
    """(..., R, 3) d r / d Xc and (..., 3) Xc -> (..., R, 6) d r / d xi."""
    return torch.cat([dr_dX, se3.cross(Xc[..., None, :], dr_dX)], -1)


def _proj_grads(Xc, K4):
    """d u / d Xc and d v / d Xc (..., 3) of se3.project."""
    fx, fy, _, _ = K4
    x, y, z = Xc.unbind(-1)
    tiny = torch.abs(z) < se3._EPS
    zs = torch.where(tiny, torch.full_like(z, se3._EPS), z)
    dz = torch.where(tiny, torch.zeros_like(z), -1.0 / (zs * zs))
    zero = torch.zeros_like(z)
    du = torch.stack([fx / zs, zero, fx * x * dz], -1)
    dv = torch.stack([zero, fy / zs, fy * y * dz], -1)
    return du, dv


def point_residuals(T_cw, pt_world, pt_obs, inv_sigma2, valid, K4, bf,
                    jac: bool = False):
    """-> (r (N,4), info (N,4), chi2 (N,), is_stereo (N,)[, J (N,4,6)]).

    pt_obs = (u, v, uR), uR < 0 marking a monocular observation. Components
    (du, dv, duR, dz): dz is a direct metric-depth residual with
    sigma_z = 0.0025 z^2 + 2 mm, z_obs = bf / (u - uR)."""
    Xc = se3.transform_points(T_cw, pt_world)
    z = Xc[..., 2]
    uv = se3.project(K4, Xc)
    u_r = uv[..., 0] - bf / torch.clamp(z, min=1e-6)
    is_stereo = pt_obs[..., 2] > 0
    disparity = torch.clamp(pt_obs[..., 0] - pt_obs[..., 2], min=1e-3)
    z_obs = torch.where(is_stereo, bf / disparity, torch.ones_like(disparity))
    zero = torch.zeros_like(z)
    r = torch.stack([
        pt_obs[..., 0] - uv[..., 0],
        pt_obs[..., 1] - uv[..., 1],
        torch.where(is_stereo, pt_obs[..., 2] - u_r, zero),
        torch.where(is_stereo, z_obs - z, zero),
    ], -1)
    ok = valid & (z > 0.05)
    sigma_z = 0.0025 * z_obs * z_obs + 0.002
    info_z = torch.where(is_stereo, 1.0 / (sigma_z * sigma_z),
                         torch.zeros_like(sigma_z))
    info = torch.stack(
        [inv_sigma2, inv_sigma2, inv_sigma2 * is_stereo, info_z], -1)
    info = torch.where(ok[..., None], info, torch.zeros_like(info))
    chi2 = torch.sum(r * r * info, -1)
    if not jac:
        return r, info, chi2, is_stereo
    du, dv = _proj_grads(Xc, K4)
    st = is_stereo.to(z.dtype)[..., None]
    ez = device_const((0.0, 0.0, 1.0), z.dtype, z.device)
    dbz = torch.where(z > 1e-6, bf / (z * z), zero)          # d(-bf/z)/dz
    dur = du + dbz[..., None] * ez
    dr_dX = -torch.stack([du, dv, st * dur, st * ez.expand_as(du)], -2)
    return r, info, chi2, is_stereo, _pose_jac(dr_dX, Xc)


def line_residuals(T_cw, ln_world, ln_obs, inv_sigma2, valid, K4,
                   jac: bool = False):
    """ln_world (N, 6) endpoints; ln_obs (N, 3) 2D line (a,b,c), a^2+b^2=1.
    -> (r (N,2), info (N,2), chi2 (N,)[, J (N,2,6)])."""
    Xs = se3.transform_points(T_cw, ln_world[..., :3])
    Xe = se3.transform_points(T_cw, ln_world[..., 3:])
    uvs = se3.project(K4, Xs)
    uve = se3.project(K4, Xe)
    a, b = ln_obs[..., 0], ln_obs[..., 1]
    rs = a * uvs[..., 0] + b * uvs[..., 1] + ln_obs[..., 2]
    re = a * uve[..., 0] + b * uve[..., 1] + ln_obs[..., 2]
    ok = valid & (Xs[..., 2] > 0.05) & (Xe[..., 2] > 0.05)
    r = torch.stack([rs, re], -1)
    info = torch.where(ok[..., None], inv_sigma2[..., None],
                       torch.zeros_like(inv_sigma2[..., None])) * torch.ones_like(r)
    chi2 = torch.sum(r * r * info, -1)
    if not jac:
        return r, info, chi2
    rows = []
    for X in (Xs, Xe):
        du, dv = _proj_grads(X, K4)
        rows.append(_pose_jac((a[..., None] * du + b[..., None] * dv)[..., None, :],
                              X))
    return r, info, chi2, torch.cat(rows, -2)


_SAFE_PLANE = (0.0, 0.0, 1.0, 1.0)


def _sanitize_planes(pl_world, pl_obs, valid):
    """Replace masked rows with a well-conditioned plane so normalization and
    tangent bases never meet a zero vector."""
    safe = device_const(_SAFE_PLANE, pl_world.dtype, pl_world.device)
    w = valid[..., None]
    return torch.where(w, pl_world, safe), torch.where(w, pl_obs, safe)


def _tangent_basis(n):
    """Two unit vectors orthogonal to n (..., 3), branchless -> (t1, t2, a,
    |n x a|) with a the world axis used."""
    ex = device_const((1.0, 0.0, 0.0), n.dtype, n.device)
    ey = device_const((0.0, 1.0, 0.0), n.dtype, n.device)
    a = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    u = se3.cross(n, a)
    nu = torch.clamp(torch.linalg.norm(u, dim=-1, keepdim=True), min=1e-9)
    t1 = u / nu
    t2 = se3.cross(n, t1)
    return t1, t2, a, nu


def structural_terms(T_cw, pl_world, pl_obs, jac: bool = False):
    """Shared core of the plane / parallel / vertical edges for (sanitized)
    world planes and camera observations (N, 4).

    -> (e (N, 4), J (N, 4, 6) or None), e = (n_obs . t1, n_obs . t2,
    d_obs - d_pred, n_obs . n_pred) with n_pred, d_pred the world plane in
    the camera frame and (t1, t2) the tangent basis of n_pred."""
    p_c = pl_world @ se3.inv_T(T_cw)                 # unnormalized camera plane
    nn = torch.clamp(torch.linalg.norm(p_c[..., :3], dim=-1, keepdim=True),
                     min=se3._EPS)
    sign = torch.where(p_c[..., 3:4] / nn < 0, -1.0, 1.0).to(p_c.dtype)
    pred = p_c / nn * sign                           # se3.normalize_plane
    n_pred = pred[..., :3]
    t1, t2, a, nu = _tangent_basis(n_pred)
    n_obs = pl_obs[..., :3]
    e = torch.stack([torch.sum(n_obs * t1, -1), torch.sum(n_obs * t2, -1),
                     pl_obs[..., 3] - pred[..., 3],
                     torch.sum(n_obs * n_pred, -1)], -1)
    if not jac:
        return e, None
    # under T <- exp(xi) T the camera plane moves as n <- n + phi x n,
    # d <- d - n . rho; normalization scales by sign / |n| (|n| is constant
    # to first order)
    n_c = p_c[..., :3]
    scale = (sign / nn)[..., None]                              # (N, 1, 1)
    zero3 = torch.zeros_like(n_c)[..., None, :].expand(n_c.shape[:-1] + (3, 3))
    dn = torch.cat([zero3, -se3.hat(n_c).transpose(-1, -2)], -2) * scale  # (N,6,3)
    dd = torch.cat([-n_c, torch.zeros_like(n_c)], -1) * scale[..., 0]     # (N,6)
    du = se3.cross(dn, a[..., None, :])
    dt1 = (du - t1[..., None, :] * torch.sum(t1[..., None, :] * du, -1,
                                             keepdim=True)) / nu[..., None]
    dt2 = se3.cross(dn, t1[..., None, :]) + se3.cross(n_pred[..., None, :], dt1)
    no = n_obs[..., None, :]
    J = torch.stack([torch.sum(no * dt1, -1), torch.sum(no * dt2, -1), -dd,
                     torch.sum(no * dn, -1)], -2)                  # (N, 4, 6)
    return e, J


def plane_residuals(T_cw, pl_world, pl_obs, valid, angle_info, dist_info):
    """Pole-free 3-DoF plane error: tangent-basis components of the observed
    normal + distance difference. -> (r (N,3), info (N,3), chi2 (N,))."""
    pl_world, pl_obs = _sanitize_planes(pl_world, pl_obs, valid)
    e, _ = structural_terms(T_cw, pl_world, pl_obs)
    r = e[..., :3]
    w = device_const((angle_info, angle_info, dist_info), r.dtype, r.device)
    info = torch.where(valid[..., None], w, torch.zeros_like(w))
    return r, info, torch.sum(r * r * info, -1)


def parallel_residuals(T_cw, pl_world, pl_obs, valid, angle_info):
    """2-DoF parallel-plane penalty (zero iff normals are parallel)."""
    pl_world, pl_obs = _sanitize_planes(pl_world, pl_obs, valid)
    r = structural_terms(T_cw, pl_world, pl_obs)[0][..., :2]
    info = torch.where(valid[..., None], angle_info, 0.0).to(r.dtype) \
        * torch.ones_like(r)
    return r, info, torch.sum(r * r * info, -1)


def vertical_residuals(T_cw, pl_world, pl_obs, valid, angle_info):
    """1-DoF perpendicular-plane penalty: n_obs . n_pred."""
    pl_world, pl_obs = _sanitize_planes(pl_world, pl_obs, valid)
    r = structural_terms(T_cw, pl_world, pl_obs)[0][..., 3:]
    info = torch.where(valid[..., None], angle_info, 0.0).to(r.dtype) \
        * torch.ones_like(r)
    return r, info, torch.sum(r * r * info, -1)
