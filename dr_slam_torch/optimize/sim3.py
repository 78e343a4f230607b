"""Batched Horn alignment inside RANSAC (the Sim3 / SE3 solver).

Counterpart of the JAX package's `optimize/sim3.py` (the capability of the
reference's Sim3Solver, src/Sim3Solver.cc: a closed-form similarity from
3-point samples inside RANSAC, the scale fixed for RGB-D). All H hypotheses
are solved and scored at once. The samples come from the same seeded numpy
keys as the reference package's, so both draw the same point triples.

Horn's rotation is the eigenvector of the largest eigenvalue of a 4x4
symmetric matrix (`torch.linalg.eigh`; cuSOLVER's batched solver on the
card). The quaternion's sign does not matter. The best hypothesis is the
first of the most votes; where two hypotheses tie within float rounding,
the port and the reference may pick different ones, so callers compare what
the pose leads to rather than the RANSAC pose itself."""

from __future__ import annotations

import functools

import numpy as np
import torch

from dr_slam_torch.geometry import se3
from dr_slam_torch.ops.select import top_k


def _rotation_from_correlation(S: torch.Tensor) -> torch.Tensor:
    """Horn's quaternion method: S = sum_n w_n a0[n] b0[n]^T (...,3,3) ->
    the rotation maximising sum w b0^T R a0. The 4x4 symmetric
    eigenproblem is well-posed even for the rank-2 S of a minimal sample."""
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], -2)
    _, vecs = torch.linalg.eigh(N)
    q_wxyz = vecs[..., -1]                      # largest eigenvalue
    q_xyzw = torch.cat([q_wxyz[..., 1:], q_wxyz[..., :1]], -1)
    return se3.quat_to_rot(q_xyzw)


def horn_align(a: torch.Tensor, b: torch.Tensor, w: torch.Tensor,
               with_scale: bool = False):
    """Weighted closed-form alignment b ~ s R a + t.

    a, b (..., N, 3); w (..., N) weights. -> (R (...,3,3), t (...,3),
    s (...))."""
    wn = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    ca = torch.sum(a * wn[..., None], -2)
    cb = torch.sum(b * wn[..., None], -2)
    a0 = a - ca[..., None, :]
    b0 = b - cb[..., None, :]
    S = torch.einsum("...ni,...nj,...n->...ij", a0, b0, wn)  # sum a0 b0^T
    R = _rotation_from_correlation(S)
    if with_scale:
        num = torch.einsum("...ni,...ij,...nj,...n->...", b0, R, a0, wn)
        den = torch.sum(torch.sum(a0 * a0, -1) * wn, -1)
        s = num / torch.clamp(den, min=1e-12)
    else:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    t = cb - s[..., None] * torch.einsum("...ij,...j->...i", R, ca)
    return R, t, s


@functools.lru_cache(maxsize=4)
def _keys(n_hyp: int, n_pts: int, seed: int = 11) -> np.ndarray:
    return np.random.RandomState(seed).rand(n_hyp, n_pts).astype(np.float32)


def sim3_ransac(pts_a: torch.Tensor, pts_b: torch.Tensor, valid: torch.Tensor,
                inlier_dist: float = 0.10, n_hyp: int = 64,
                with_scale: bool = False):
    """3D-3D RANSAC alignment b ~ s R a + t over matched point pairs.

    -> (T (4,4) with sR in the rotation block, s (), n_inliers ()), all on
    the device."""
    dev = pts_a.device
    N = pts_a.shape[0]
    keys = (torch.from_numpy(_keys(n_hyp, N)).to(dev)
            + torch.where(valid, 0.0, -10.0))
    _, picks = top_k(keys, 3)
    hyp_ok = torch.all(valid[picks], -1)

    A = pts_a[picks]
    B = pts_b[picks]
    w3 = torch.ones(picks.shape, dtype=pts_a.dtype, device=dev)
    R, t, s = horn_align(A, B, w3, with_scale)

    pred = s[:, None, None] * torch.einsum("hij,nj->hni", R, pts_a) + t[:, None]
    err = torch.linalg.norm(pred - pts_b[None], dim=-1)
    inl = (err < inlier_dist) & valid[None]
    votes = torch.sum(inl, -1) * hyp_ok
    best = torch.argmax(votes)

    # refine on the best hypothesis' inliers
    w = inl[best].to(pts_a.dtype)
    Rb, tb, sb = horn_align(pts_a, pts_b, w, with_scale)
    pred = sb * (pts_a @ Rb.T) + tb
    inl2 = (torch.linalg.norm(pred - pts_b, dim=-1) < inlier_dist) & valid
    T = se3.make_T(Rb * sb, tb)
    T = torch.where(torch.all(torch.isfinite(T)), T,
                    torch.eye(4, dtype=T.dtype, device=dev))
    return T, sb, torch.sum(inl2)
