"""SE(3) / SO(3) / plane utilities on batched tensors.

Poses are 4x4 row-major matrices T_cw = [R|t; 0 1] mapping world -> camera
(the reference convention, src/Tracking.cc Tcw). Counterpart of
the JAX package's `geometry/se3.py`: the same formulas, so results agree to float
rounding."""

from __future__ import annotations

import torch

from dr_slam_torch import device_const

_EPS = 1e-9


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def hat(w):
    """so(3) hat operator: (...,3) -> (...,3,3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def vee(W):
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def so3_exp(w):
    """Rodrigues: (...,3) -> (...,3,3), safe at theta = 0."""
    theta2 = torch.sum(w * w, -1, keepdim=True)[..., None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(w)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    return _eye3(w) + a * W + b * (W @ W)


def so3_log(R):
    """(...,3,3) -> (...,3), atan2 form."""
    w = vee(R - R.transpose(-1, -2)) * 0.5       # axis * sin(theta)
    s = torch.sqrt(torch.sum(w * w, -1) + 1e-20)  # sin(theta)
    c = (torch.diagonal(R, dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    theta = torch.atan2(s, c)
    small = s < 1e-5
    safe_s = torch.where(small, torch.ones_like(s), s)
    scale = torch.where(small, 1.0 + (1.0 - c) / 3.0, theta / safe_s)
    return w * scale[..., None]


def se3_exp(xi):
    """se(3) exp. xi = (...,6) as [rho(3), phi(3)] -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(phi * phi, -1, keepdim=True)[..., None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(phi)
    I = _eye3(xi)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / theta2_safe)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - a) / theta2_safe)
    WW = W @ W
    R = I + a * W + b * WW
    V = I + b * W + c * WW
    t = (V @ rho[..., None])[..., 0]
    return make_T(R, t)


def se3_log(T):
    """(...,4,4) -> (...,6) as [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2 = torch.sum(phi * phi, -1, keepdim=True)[..., None]
    small = theta2 < 1e-8
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2_safe)
    W = hat(phi)
    half = theta / 2.0
    cot_big = (1.0 - half * torch.cos(half)
               / torch.clamp(torch.sin(half), min=_EPS)) / theta2_safe
    cot = torch.where(small, 1.0 / 12.0 + theta2 / 720.0, cot_big)
    Vinv = _eye3(T) - 0.5 * W + cot * (W @ W)
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)


def make_T(R, t):
    """(...,3,3),(...,3) -> (...,4,4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    bottom = device_const((0.0, 0.0, 0.0, 1.0), R.dtype,
                          R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], -2)


def inv_T(T):
    """Fast SE(3) inverse."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_T(Rt, -(Rt @ t[..., None])[..., 0])


def transform_points(T, pts):
    """Apply (...,4,4) to (...,N,3) -> (...,N,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def _k4(K):
    if isinstance(K, torch.Tensor):
        if K.shape[-1] == 4:
            return K[..., 0], K[..., 1], K[..., 2], K[..., 3]
        return K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    fx, fy, cx, cy = (float(k) for k in K)
    return fx, fy, cx, cy


def project(K, pts_c):
    """Pinhole projection. K = (fx, fy, cx, cy) or a (3,3) tensor;
    pts_c (...,3) -> (...,2)."""
    fx, fy, cx, cy = _k4(K)
    z = pts_c[..., 2]
    zs = torch.where(torch.abs(z) < _EPS, torch.full_like(z, _EPS), z)
    u = fx * pts_c[..., 0] / zs + cx
    v = fy * pts_c[..., 1] / zs + cy
    return torch.stack([u, v], -1)


def backproject(K4, uv, depth):
    """Inverse projection: K4 = (fx,fy,cx,cy); uv (...,2); depth (...) ->
    (...,3) camera-frame points."""
    fx, fy, cx, cy = _k4(K4)
    x = (uv[..., 0] - cx) / fx * depth
    y = (uv[..., 1] - cy) / fy * depth
    return torch.stack([x, y, depth], -1)


def quat_to_rot(q):
    """Quaternion (...,4) as (x,y,z,w), the TUM trajectory order ->
    (...,3,3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], -1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], -1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


def rot_to_quat_unnormalized(R):
    """(...,3,3) -> (...,4) as (x,y,z,w): of Shepperd's four constructions,
    the one with the largest pivot, before the final normalisation (the
    caller normalises, as the trajectory saver does to match the JAX
    package's rounding)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw0 = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) / 2.0
    c0 = torch.stack([(m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0), qw0], -1)
    qx1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) / 2.0
    c1 = torch.stack([qx1, (m01 + m10) / (4 * qx1), (m02 + m20) / (4 * qx1),
                      (m21 - m12) / (4 * qx1)], -1)
    qy2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) / 2.0
    c2 = torch.stack([(m01 + m10) / (4 * qy2), qy2, (m12 + m21) / (4 * qy2),
                      (m02 - m20) / (4 * qy2)], -1)
    qz3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) / 2.0
    c3 = torch.stack([(m02 + m20) / (4 * qz3), (m12 + m21) / (4 * qz3), qz3,
                      (m10 - m01) / (4 * qz3)], -1)
    pivots = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], -1)
    idx = torch.argmax(pivots, -1)
    cands = torch.stack([c0, c1, c2, c3], -2)
    return torch.gather(cands, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]


def rot_to_quat(R):
    """(...,3,3) -> (...,4) unit quaternion as (x,y,z,w): the branchless
    Shepperd construction of `rot_to_quat_unnormalized` (largest pivot, the
    first on ties), normalised."""
    q = rot_to_quat_unnormalized(R)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def orthonormalize_rotation(M, n_iters: int = 6):
    """Project a near-rotation onto SO(3) with the fixed-iteration Newton
    polar iteration X <- (X + X^-T)/2 (same as the reference; no SVD)."""
    det = torch.linalg.det(M)
    sign = torch.where(det < 0, -1.0, 1.0).to(M.dtype)
    M = torch.cat([M[..., :, :2], M[..., :, 2:3] * sign[..., None, None]], -1)
    X = M
    for _ in range(n_iters):
        X = 0.5 * (X + _inv33_T(X))
    return X


def _inv33_T(A):
    """Transpose-inverse of (..., 3, 3) in closed form (adjugate)."""
    a = A[..., 0, :]
    b = A[..., 1, :]
    c = A[..., 2, :]
    r0 = cross(b, c)
    r1 = cross(c, a)
    r2 = cross(a, b)
    det = torch.sum(a * r0, -1, keepdim=True)[..., None]
    adjT = torch.stack([r0, r1, r2], -2)
    return adjT / torch.where(torch.abs(det) < _EPS,
                              torch.full_like(det, _EPS), det)


# Planes: a 4-vector (nx, ny, nz, d) with n unit and n.p + d = 0.

def normalize_plane(p):
    """Unit normal; sign canonicalised so d >= 0."""
    n = torch.linalg.norm(p[..., :3], dim=-1, keepdim=True)
    p = p / torch.clamp(n, min=_EPS)
    sign = torch.where(p[..., 3:4] < 0, -1.0, 1.0).to(p.dtype)
    return p * sign


def plane_to_camera(T_cw, plane_w):
    """World plane -> camera frame: coef_c = Twc^T . coef_w."""
    T_wc = inv_T(T_cw)
    return normalize_plane(plane_w @ T_wc)


def plane_to_world(T_cw, plane_c):
    """Camera plane -> world frame: coef_w = Tcw^T coef_c (Frame.cc:1311)."""
    return normalize_plane(plane_c @ T_cw)


def plane_azel(p):
    az = torch.atan2(p[..., 1], p[..., 0])
    el = torch.atan2(p[..., 2], torch.linalg.norm(p[..., :2], dim=-1))
    return az, el


def plane_ominus(p_obs, p_pred):
    """3-DoF plane error (d_azimuth, d_elevation, d_distance)."""
    az_o, el_o = plane_azel(p_obs)
    az_p, el_p = plane_azel(p_pred)
    daz = torch.atan2(torch.sin(az_o - az_p), torch.cos(az_o - az_p))
    return torch.stack([daz, el_o - el_p, p_obs[..., 3] - p_pred[..., 3]], -1)


def se3_left_jacobian_inv(xi):
    """Inverse left Jacobian of SE(3) at xi = [rho, phi] (6,), evaluated in
    float64: d log(exp(eps) exp(xi)) / d eps at eps = 0, i.e.
    [[J^-1, -J^-1 Q J^-1], [0, J^-1]] with J the SO(3) left Jacobian and Q
    the coupling block (Barfoot & Furgale 2014, eq. 102). Small angles use
    the Taylor series of each coefficient."""
    x = xi.to(torch.float64)
    rho, phi = x[:3], x[3:]
    theta2 = torch.sum(phi * phi)
    small = theta2 < 1e-4
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    t = torch.sqrt(t2)
    s, c = torch.sin(t), torch.cos(t)
    half = 0.5 * t
    c0 = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                     (1.0 - half * torch.cos(half) / torch.sin(half)) / t2)
    c1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (t - s) / (t2 * t))
    c2 = torch.where(small, 1.0 / 24.0 - theta2 / 720.0,
                     (t2 + 2.0 * c - 2.0) / (2.0 * t2 * t2))
    c3 = torch.where(small, 1.0 / 120.0 - theta2 / 2520.0,
                     (2.0 * t - 3.0 * s + t * c) / (2.0 * t2 * t2 * t))
    P, F = hat(rho), hat(phi)
    FF = F @ F
    FP, PF = F @ P, P @ F
    FPF = FP @ F
    Q = (0.5 * P + c1 * (FP + PF + FPF) + c2 * (FF @ P + PF @ F - 3.0 * FPF)
         + c3 * (FPF @ F + F @ FPF))
    Jinv = _eye3(x) - 0.5 * F + c0 * FF
    top = torch.cat([Jinv, -Jinv @ Q @ Jinv], 1)
    bottom = torch.cat([torch.zeros_like(Jinv), Jinv], 1)
    return torch.cat([top, bottom], 0)
