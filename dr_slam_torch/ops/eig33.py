"""Closed-form eigendecomposition of batched symmetric 3x3 matrices.

Counterpart of the JAX package's `ops/eig33.py`: trigonometric (Cardano)
eigenvalues and cross-product eigenvectors, no iteration."""

from __future__ import annotations

import torch

from dr_slam_torch import device_const
from dr_slam_torch.geometry.se3 import cross

_EPS = 1e-12


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion (no LU launch)."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def eigvals_sym3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending (..., 3)."""
    q = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1) / 3.0
    B = A - q[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    r = det3(B) / torch.clamp(2.0 * p ** 3, min=_EPS)
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)                          # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)   # smallest
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1], -1)


def smallest_eigvec_sym3(A: torch.Tensor, eigval: torch.Tensor) -> torch.Tensor:
    """Unit eigenvector of (..., 3, 3) for the given eigenvalue: the cross
    product of the two most independent rows of A - lambda I."""
    M = A - eigval[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    r0, r1, r2 = M[..., 0, :], M[..., 1, :], M[..., 2, :]
    c01 = cross(r0, r1)
    c02 = cross(r0, r2)
    c12 = cross(r1, r2)
    n01 = torch.sum(c01 * c01, -1)
    n02 = torch.sum(c02 * c02, -1)
    n12 = torch.sum(c12 * c12, -1)
    best = torch.argmax(torch.stack([n01, n02, n12], -1), -1)
    cands = torch.stack([c01, c02, c12], -2)
    v = torch.gather(cands, -2, best[..., None, None].expand(
        best.shape + (1, 3)))[..., 0, :]
    norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = device_const((0.0, 0.0, 1.0), A.dtype, A.device).expand(v.shape)
    return torch.where(norm > 1e-10, v / torch.clamp(norm, min=_EPS), fallback)


def plane_from_cov(mean: torch.Tensor, cov: torch.Tensor):
    """(mean (...,3), cov (...,3,3)) -> (normal (...,3), d (...), mse (...));
    the normal faces the camera (n . mean < 0) and n.p + d = 0."""
    evals = eigvals_sym3(cov)
    lam0 = evals[..., 0]
    n = smallest_eigvec_sym3(cov, lam0)
    flip = torch.where(torch.sum(n * mean, -1) > 0, -1.0, 1.0).to(n.dtype)
    n = n * flip[..., None]
    d = -torch.sum(n * mean, -1)
    return n, d, torch.clamp(lam0, min=0.0)
