"""Batched PnP RANSAC for relocalization.

Counterpart of the JAX package's `optimize/pnp.py` (the capability of the
reference's PnPsolver, src/PnPsolver.cc, used by Tracking::Relocalization,
Tracking.cc:3580). Every hypothesis at once:

- H 6-point samples, drawn by a per-hypothesis top-k over the same seeded
  numpy keys as the reference package's (masked by validity);
- a DLT per sample: the smallest eigenvector of the 12x12 normal matrix
  gives the projection matrix, its sign fixed by the determinant of its
  left 3x3 block; the scale is that determinant's cube root (it is made
  non-negative first, so `pow(1/3)` stands in for `cbrt`, which PyTorch
  lacks), the rotation its polar factor;
- a plane-to-image homography per sample for coplanar points, where the DLT
  is rank-deficient: the plane normal is the smallest eigenvector of the
  sample's scatter (either sign gives the same pose), the homography's sign
  is fixed by cheirality;
- both families scored against all points; the first of the most votes
  wins.

The small symmetric eigenproblems go to `torch.linalg.eigh` (cuSOLVER's
batched solver on the card). Refinement is left to pose_optimize."""

from __future__ import annotations

import functools

import numpy as np
import torch

from dr_slam_torch import device_const
from dr_slam_torch.geometry import se3
from dr_slam_torch.ops.select import top_k


@functools.lru_cache(maxsize=4)
def _sample_keys(n_hyp: int, n_pts: int, seed: int = 5) -> np.ndarray:
    return np.random.RandomState(seed).rand(n_hyp, n_pts).astype(np.float32)


def pnp_ransac(pts_w: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               K4, n_hyp: int = 64, px_threshold: float = 4.0):
    """-> (T_cw (4,4), n_inliers ()). pts_w (N,3), uv (N,2), valid (N,)."""
    dev = pts_w.device
    N = pts_w.shape[0]
    fx, fy, cx, cy = (float(k) for k in K4)
    xn = (uv[:, 0] - cx) / fx
    yn = (uv[:, 1] - cy) / fy

    keys = (torch.from_numpy(_sample_keys(n_hyp, N)).to(dev)
            + torch.where(valid, 0.0, -10.0))
    _, picks = top_k(keys, 6)                            # (H, 6)
    hyp_ok = torch.all(valid[picks], -1)

    X = pts_w[picks]                                     # (H, 6, 3)
    x = xn[picks]
    y = yn[picks]
    ones = torch.ones_like(x)
    Xh = torch.cat([X, ones[..., None]], -1)             # (H, 6, 4)
    # rows: [X 0 -x*X ; 0 X -y*X] for P = [p1; p2; p3]
    row1 = torch.cat([Xh, torch.zeros_like(Xh), -x[..., None] * Xh], -1)
    row2 = torch.cat([torch.zeros_like(Xh), Xh, -y[..., None] * Xh], -1)
    A = torch.cat([row1, row2], 1)                       # (H, 12, 12)
    AtA = torch.einsum("hni,hnj->hij", A, A)
    _, evecs = torch.linalg.eigh(AtA)
    P = evecs[..., 0].reshape(-1, 3, 4)                  # smallest eigvec
    det = torch.linalg.det(P[:, :, :3])
    P = P * torch.where(det < 0, -1.0, 1.0)[:, None, None]
    s = torch.pow(torch.clamp(torch.abs(det), min=1e-12), 1.0 / 3.0)
    Mn = P / s[:, None, None]
    R = se3.orthonormalize_rotation(Mn[:, :, :3])
    t = Mn[:, :, 3]

    # ---- planar branch: homography decomposition per hypothesis ----------
    c_h = torch.mean(X, 1)                                # (H, 3)
    d_h = X - c_h[:, None]
    cov_h = torch.einsum("hni,hnj->hij", d_h, d_h)
    _, vec_h = torch.linalg.eigh(cov_h)
    n_h = vec_h[..., 0]                                   # plane normal
    e_x = device_const((1.0, 0.0, 0.0), torch.float32, dev)
    e_y = device_const((0.0, 1.0, 0.0), torch.float32, dev)
    ref = torch.where(torch.abs(n_h[:, :1]) < 0.9, e_x, e_y)
    e1 = se3.cross(n_h, ref)
    e1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True),
                          min=1e-9)
    e2 = se3.cross(n_h, e1)
    px_ = torch.einsum("hnc,hc->hn", d_h, e1)             # plane coords
    py_ = torch.einsum("hnc,hc->hn", d_h, e2)
    ph = torch.stack([px_, py_, torch.ones_like(px_)], -1)   # (H, 6, 3)
    r1h = torch.cat([ph, torch.zeros_like(ph), -x[..., None] * ph], -1)
    r2h = torch.cat([torch.zeros_like(ph), ph, -y[..., None] * ph], -1)
    Ah = torch.cat([r1h, r2h], 1)                         # (H, 12, 9)
    AtAh = torch.einsum("hni,hnj->hij", Ah, Ah)
    _, evh = torch.linalg.eigh(AtAh)
    h = evh[..., 0].reshape(-1, 3, 3)                     # plane -> image
    # cheirality: the sample points must land in front (h is up to sign)
    zs = torch.einsum("hc,hnc->hn", h[:, 2], ph)
    h = h * torch.where(torch.mean(zs, -1) < 0, -1.0, 1.0)[:, None, None]
    lam = 2.0 / torch.clamp(torch.linalg.norm(h[:, :, 0], dim=-1)
                            + torch.linalg.norm(h[:, :, 1], dim=-1), min=1e-9)
    r1c = h[:, :, 0] * lam[:, None]
    r2c = h[:, :, 1] * lam[:, None]
    r3c = se3.cross(r1c, r2c)
    R_cp = se3.orthonormalize_rotation(torch.stack([r1c, r2c, r3c], -1))
    t_cp = h[:, :, 2] * lam[:, None]
    # plane frame -> world: X_w = c + e1*px + e2*py  =>  B = [e1 e2 n]
    B = torch.stack([e1, e2, n_h], -1)                    # (H, 3, 3)
    R_p = torch.einsum("hij,hkj->hik", R_cp, B)           # R_cp @ B^T
    t_p = t_cp - torch.einsum("hij,hj->hi", R_p, c_h)

    R = torch.cat([R, R_p], 0)
    t = torch.cat([t, t_p], 0)
    hyp_ok2 = torch.cat([hyp_ok, hyp_ok], 0)

    # score all hypotheses x all points
    Xc = torch.einsum("hij,nj->hni", R, pts_w) + t[:, None, :]
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u_pred = fx * Xc[..., 0] / zs + cx
    v_pred = fy * Xc[..., 1] / zs + cy
    err2 = (u_pred - uv[None, :, 0]) ** 2 + (v_pred - uv[None, :, 1]) ** 2
    inl = (err2 < px_threshold ** 2) & (z > 0.05) & valid[None, :]
    votes = torch.sum(inl, -1) * hyp_ok2
    best = torch.argmax(votes)
    T = se3.make_T(R[best], t[best])
    T = torch.where(torch.all(torch.isfinite(T)), T,
                    torch.eye(4, dtype=T.dtype, device=dev))
    return T, votes[best]
