"""CAPE cylinder extraction on PyTorch.

Counterpart of the JAX package's `ops/cylinders.py` (the reference's CAPE
CylinderSeg, src/CAPE/CylinderSeg.cpp:6-246, gated by `cylinder_detection`;
the reference ships its call sites commented out, src/Frame.cc:129-132, and
here too it is off by default). The algorithm:

1. Candidate cells: grid blocks whose local plane fit is good but that no
   accepted plane segment claimed (curved surfaces shatter into small
   mutually incompatible planar cells).
2. Axis: the smallest-eigenvalue direction of the sign-symmetric normal
   scatter; lam_max / lam_min >= 100 is the reference's
   `cylinder_score_min` gate.
3. In the plane orthogonal to the axis a cylinder is a circle,
   P'_i ~ c + r N'_i, with a closed-form least-squares fit
   (CylinderSeg.cpp:118-126).
4. `max_cylinders` rounds of sequential RANSAC (a Python loop where the
   reference has a `lax.scan`): H triplet hypotheses, MSAC-truncated
   scoring (CylinderSeg.cpp:138-150), inlier refit, consume the inliers.

The triplets are drawn as the JAX package draws them, Gumbel noise from
`jax.random.gumbel(fold_in(PRNGKey(7), k), (H, NB))` and its top 3: this
module carries its own threefry-2x32 (JAX's default partitionable layout),
so both packages sample the same triplets and find the same cylinders. It
runs in int64 masked to 32 bits: `>>` on `torch.uint32` is not implemented
on the CPU."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.ops import eig33
from dr_slam_torch.ops.normals import depth_to_cloud
from dr_slam_torch.ops.planes import _block_moments
from dr_slam_torch.ops.select import top_k

CYL_SCORE_MIN = 100.0          # Params.h:8
CYL_SQR_MAX_DIST = 0.0225      # Params.h:9 (15% of radius, squared)
KEY = (0, 7)                   # jax.random.PRNGKey(7)

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


class CylinderSegmentation(NamedTuple):
    axis: torch.Tensor       # (C, 3) unit axis
    center: torch.Tensor     # (C, 3) point on axis (in the projection plane)
    radius: torch.Tensor     # (C,)
    mse: torch.Tensor        # (C,) mean squared point-to-surface distance
    n_cells: torch.Tensor    # (C,) int32 member cells
    valid: torch.Tensor      # (C,) bool
    cell_mask: torch.Tensor  # (C, NB) member cells over the flattened grid


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under the key
    (k0, k1). Works on Python ints and on int64 tensors holding 32-bit
    values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key: tuple, data: int) -> tuple:
    """jax.random.fold_in for a threefry key: the hash of (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def gumbel(key: tuple, shape: tuple, device) -> torch.Tensor:
    """jax.random.gumbel(key, shape) in float32: 32 random bits per element
    (the hash of its flat index, high and low words XORed), a uniform on
    [tiny, 1) from the top 23 bits, then -log(-log(u))."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    mant = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32)
    tiny = float(np.finfo(np.float32).tiny)
    # scaled to [tiny, 1): (maxval - minval) is 1.0 in float32
    u = torch.clamp(mant.view(torch.float32) - 1.0 + tiny, min=tiny)
    return -torch.log(-torch.log(u)).reshape(shape)


def extract_cylinders(mean, normal, active, max_cylinders: int = 3,
                      n_hyp: int = 48, min_cells: int = 6,
                      key: tuple = KEY) -> CylinderSegmentation:
    """mean / normal (NB, 3) cell centroids and unit normals (camera frame),
    active (NB,) candidate mask -> up to max_cylinders cylinders. `key` is
    the JAX key's (k0, k1) pair."""
    NB = mean.shape[0]
    dev = mean.device
    af = active.to(torch.float32)
    m_act = torch.clamp(torch.sum(af), min=1.0)

    # axis from the sign-symmetric normal scatter ([N, -N] is mean-free, so
    # the scatter is the second moment; CylinderSeg.cpp:35-58)
    scatter = torch.einsum("n,ni,nj->ij", af, normal, normal) / m_act
    evals = eig33.eigvals_sym3(scatter[None])[0]            # ascending
    score = evals[2] / torch.clamp(evals[0], min=1e-9)
    axis = eig33.smallest_eigvec_sym3(scatter[None], evals[None, 0])[0]
    axis_ok = (score >= CYL_SCORE_MIN) & (torch.sum(af) >= min_cells)

    # project to the plane orthogonal to the axis
    P = mean - torch.einsum("ni,i->n", mean, axis)[:, None] * axis
    N = normal - torch.einsum("ni,i->n", normal, axis)[:, None] * axis
    N = N / torch.clamp(torch.linalg.norm(N, dim=-1, keepdim=True), min=1e-9)
    ndp = torch.einsum("ni,ni->n", N, P)

    def lls(w):
        """Closed-form circle fit over weighted cells; w (H, NB)."""
        M = torch.clamp(torch.sum(w, -1), min=1e-9)
        e1 = w @ N
        e2 = w @ P
        a = 1.0 - torch.sum(e1 * e1, -1) / (M * M)
        b = (w @ ndp) / M - torch.sum(e1 * e2, -1) / (M * M)
        r = b / torch.where(torch.abs(a) < 1e-9, torch.full_like(a, 1e-9), a)
        c = (e2 - r[:, None] * e1) / M[:, None]
        return r, c

    def sqdist(r, c):
        """Normalized squared consensus distance (CylinderSeg.cpp:131).
        r (H,), c (H, 3) -> (H, NB)."""
        d = P[None] - r[:, None, None] * N[None] - c[:, None, :]
        return torch.sum(d * d, -1) / torch.clamp(r * r, min=1e-9)[:, None]

    remaining = active.clone()
    outs = []
    for k in range(max_cylinders):
        m_left = torch.sum(remaining.to(torch.float32))
        # H triplets from the remaining cells (Gumbel top-k: masked noise,
        # the 3 largest are uniform without replacement)
        g = gumbel(fold_in(key, k), (n_hyp, NB), dev)
        g = torch.where(remaining[None, :], g, torch.full_like(g, -torch.inf))
        _, tri = top_k(g, 3)                                   # (H, 3)
        w_tri = torch.zeros(n_hyp, NB, device=dev).scatter_(1, tri, 1.0)
        r_h, c_h = lls(w_tri)
        D = sqdist(r_h, c_h)                                   # (H, NB)
        inl = (D < CYL_SQR_MAX_DIST) & remaining[None, :]
        # MSAC truncated cost over the remaining cells
        trunc = torch.where(remaining, CYL_SQR_MAX_DIST, 0.0)[None, :]
        cost = torch.sum(torch.where(inl, D, trunc), -1)
        binl = inl[torch.argmin(cost)]
        # refit on all inliers (CylinderSeg.cpp:186-206)
        r, c = lls(binl.to(torch.float32)[None])
        Df = sqdist(r, c)[0]
        r, c = r[0], c[0]
        finl = (Df < CYL_SQR_MAX_DIST) & remaining
        n_fin = torch.sum(finl)
        r = torch.abs(r)
        ok = (n_fin >= min_cells) & (m_left >= min_cells) & axis_ok \
            & (r > 0.02) & (r < 2.0)
        # MSE of the radial point-to-surface distance (CylinderSeg.cpp:221-237)
        radial = torch.linalg.norm(P - c[None], dim=-1) - r
        mse = torch.sum(torch.where(finl, radial * radial, 0.0)) \
            / torch.clamp(n_fin, min=1)
        outs.append((axis, c, r, mse, n_fin.to(torch.int32), ok, finl & ok))
        remaining = remaining & ~(finl & ok)
    ax, c, r, mse, n_cells, ok, masks = (torch.stack(x) for x in zip(*outs))
    return CylinderSegmentation(axis=ax, center=c, radius=r, mse=mse,
                                n_cells=n_cells, valid=ok, cell_mask=masks)


def segment_cylinders(depth, K4, block_label, block: int = 8,
                      max_cylinders: int = 3, mse_factor: float = 2.5e-3,
                      max_depth: float = 5.0) -> CylinderSegmentation:
    """The CAPE cylinder pass over an organized depth map: tile moments,
    locally planar cells that no accepted plane claimed (block_label < 0
    from ops/planes.segment_planes), then the sequential RANSAC above."""
    valid = (depth > 1e-3) & (depth < max_depth)
    cloud = depth_to_cloud(torch.where(valid, depth, 0.0), K4)
    cnt, mean, cov = _block_moments(cloud, valid, block)
    n, _, mse = eig33.plane_from_cov(mean, cov)
    z = torch.clamp(mean[..., 2], min=0.3)
    sigma = mse_factor * z * z
    lam1 = eig33.eigvals_sym3(cov)[..., 1]
    locally_planar = ((cnt > 0.75 * block * block)
                      & (mse < torch.clamp(sigma * sigma, min=1e-8))
                      & (lam1 > 1e-7))
    active = locally_planar & (block_label < 0)
    return extract_cylinders(mean.reshape(-1, 3), n.reshape(-1, 3),
                             active.reshape(-1), max_cylinders=max_cylinders)
