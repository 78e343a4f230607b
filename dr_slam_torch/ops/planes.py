"""Organized-point-cloud plane segmentation: tile PCA + label propagation.

Counterpart of the JAX package's `ops/planes.py` (the role of PEAC/AHC): block
moments, closed-form block planes, iterated min-label propagation over the
block graph (a Python loop of fixed length where the reference has a
`fori_loop`), then the top segments by pixel support re-fitted from their
aggregated moments."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr_slam_torch.ops import eig33
from dr_slam_torch.ops.normals import depth_to_cloud
from dr_slam_torch.ops.select import top_k


class PlaneSegmentation(NamedTuple):
    coeffs: torch.Tensor        # (P, 4) normalized (n, d), camera frame
    valid: torch.Tensor         # (P,) bool
    n_blocks: torch.Tensor      # (P,) int32 member-block counts
    cloud: torch.Tensor         # (P, Q, 3) sample points (block centroids)
    cloud_valid: torch.Tensor   # (P, Q) bool
    mse: torch.Tensor           # (P,)
    block_label: torch.Tensor   # (gh, gw) int32 segment id in [0, P) or -1


def _block_moments(cloud, valid, block):
    """(H,W,3),(H,W) -> per-block (count, mean, cov): (gh,gw), (gh,gw,3),
    (gh,gw,3,3). Covariance is taken around the block mean (two-pass)."""
    h, w, _ = cloud.shape
    gh, gw = h // block, w // block
    c = cloud[:gh * block, :gw * block].reshape(gh, block, gw, block, 3)
    v = valid[:gh * block, :gw * block].reshape(gh, block, gw, block)
    c = c.permute(0, 2, 1, 3, 4).reshape(gh, gw, block * block, 3)
    v = v.permute(0, 2, 1, 3).reshape(gh, gw, block * block).to(torch.float32)
    cnt = torch.sum(v, -1)
    safe = torch.clamp(cnt, min=1.0)
    mean = torch.sum(c * v[..., None], -2) / safe[..., None]
    diff = (c - mean[..., None, :]) * v[..., None]
    cov = torch.einsum("...ni,...nj->...ij", diff, diff) / safe[..., None, None]
    return cnt, mean, cov


def _inbounds(gh: int, gw: int, shift, device) -> torch.Tensor:
    """Neighbour source (y - dy, x - dx) lies inside the grid (no wrap)."""
    yy = torch.arange(gh, device=device)[:, None]
    xx = torch.arange(gw, device=device)[None, :]
    return ((yy - shift[0] >= 0) & (yy - shift[0] < gh)
            & (xx - shift[1] >= 0) & (xx - shift[1] < gw))


def _compat(n, d, mean, ok, shift, angle_cos, dist_th):
    """Compatibility of each block with its neighbour at `shift` (dy, dx)."""
    roll = lambda x: torch.roll(x, shift, dims=(0, 1))
    n2, m2, ok2 = roll(n), roll(mean), roll(ok)
    ang = torch.sum(n * n2, -1) > angle_cos
    dist = torch.abs(torch.sum(n * m2, -1) + d) < dist_th
    gh, gw = ok.shape
    return ang & dist & ok & ok2 & _inbounds(gh, gw, shift, ok.device)


def segment_planes(depth: torch.Tensor, K4, block: int = 8, max_planes: int = 8,
                   min_blocks: int = 10, merge_angle_cos: float = 0.985,
                   merge_dist: float = 0.05, mse_factor: float = 2.5e-3,
                   max_depth: float = 5.0, cloud_points: int = 256,
                   n_prop_iters: int = 96) -> PlaneSegmentation:
    """Segment up to `max_planes` planes from an organized depth map."""
    dev = depth.device
    valid = (depth > 1e-3) & (depth < max_depth)
    cloud = depth_to_cloud(torch.where(valid, depth, torch.zeros_like(depth)), K4)
    cnt, mean, cov = _block_moments(cloud, valid, block)
    gh, gw = cnt.shape
    nb = gh * gw

    n, d, mse = eig33.plane_from_cov(mean, cov)
    z = torch.clamp(mean[..., 2], min=0.3)
    sigma = mse_factor * z * z
    lam1 = eig33.eigvals_sym3(cov)[..., 1]
    planar = ((cnt > 0.75 * block * block)
              & (mse < torch.clamp(sigma * sigma, min=1e-8))
              & (lam1 > 1e-7))

    # --- iterated min-label propagation --------------------------------------
    flat_idx = torch.arange(nb, dtype=torch.int32, device=dev).reshape(gh, gw)
    labels = torch.where(planar, flat_idx, torch.full_like(flat_idx, nb))
    shifts = ((1, 0), (-1, 0), (0, 1), (0, -1))
    masks = [_compat(n, d, mean, planar, s, merge_angle_cos, merge_dist)
             for s in shifts]
    for _ in range(n_prop_iters):
        out = labels
        for s, m in zip(shifts, masks):
            nl = torch.roll(labels, s, dims=(0, 1))
            out = torch.where(m, torch.minimum(out, nl), out)
        labels = out

    # --- top segments by pixel support --------------------------------------
    flat_labels = labels.reshape(-1).to(torch.int64)
    seg_px = torch.zeros(nb + 1, dtype=torch.float32, device=dev).index_add_(
        0, flat_labels, cnt.reshape(-1))
    seg_px[nb] = 0.0
    top_px, top_lab = top_k(seg_px, max_planes)
    member = ((flat_labels[None, :] == top_lab[:, None])
              & planar.reshape(-1)[None, :])
    memberf = member.to(torch.float32)                        # (P, nb)

    # --- aggregate moments per segment (parallel-axis form) ------------------
    cnt_f = cnt.reshape(-1)
    sum_p = (mean * cnt[..., None]).reshape(nb, 3)
    sum_cov = (cov * cnt[..., None, None]).reshape(nb, 9)
    feats = torch.cat([cnt_f[:, None], sum_p, sum_cov], -1)
    agg = memberf @ feats                                     # (P, 13)
    a_cnt = torch.clamp(agg[:, 0], min=1.0)
    a_mean = agg[:, 1:4] / a_cnt[:, None]
    mu_b = mean.reshape(nb, 3)
    d_b = mu_b[None, :, :] - a_mean[:, None, :]               # (P, nb, 3)
    w_b = memberf * cnt_f[None, :]
    spread = torch.einsum("pn,pni,pnj->pij", w_b, d_b, d_b)
    a_cov = (agg[:, 4:13].reshape(-1, 3, 3) + spread) / a_cnt[:, None, None]
    pn, pd, pmse = eig33.plane_from_cov(a_mean, a_cov)
    coeffs = torch.cat([pn, pd[:, None]], -1)

    nblocks = torch.sum(member, -1).to(torch.int32)
    plane_valid = (nblocks >= min_blocks) & (top_px > 0)

    # --- per-plane sample cloud: up to Q member-block centroids --------------
    order = -torch.arange(nb, dtype=torch.float32, device=dev)[None, :]
    order_score = torch.where(member, order, torch.full_like(order, -torch.inf))
    q = min(cloud_points, nb)
    top_scores, blk_idx = top_k(order_score, q)               # (P, Q)
    pc = mean.reshape(nb, 3)[blk_idx]
    pc_valid = torch.isfinite(top_scores)
    if q < cloud_points:
        pad = cloud_points - q
        pc = torch.cat([pc, pc.new_zeros((pc.shape[0], pad, 3))], 1)
        pc_valid = torch.cat([pc_valid, pc_valid.new_zeros((pc.shape[0], pad))], 1)

    # --- compact block label map in [0, P) --------------------------------------
    seg_of_block = torch.argmax(member.to(torch.uint8), 0).to(torch.int32)
    has = torch.any(member, 0)
    block_label = torch.where(has, seg_of_block,
                              torch.full_like(seg_of_block, -1)).reshape(gh, gw)

    return PlaneSegmentation(
        coeffs=coeffs, valid=plane_valid, n_blocks=nblocks,
        cloud=pc, cloud_valid=pc_valid & plane_valid[:, None],
        mse=pmse, block_label=block_label)


def max_point_distance_from_plane(coeffs: torch.Tensor, cloud: torch.Tensor,
                                  cloud_valid: torch.Tensor) -> torch.Tensor:
    """Largest |n.p + d| over a plane's sample cloud
    (Frame::MaxPointDistanceFromPlane, src/Frame.cc:1222)."""
    dist = torch.abs(torch.einsum("...qi,...i->...q", cloud, coeffs[..., :3])
                     + coeffs[..., 3:4])
    return torch.amax(torch.where(cloud_valid, dist, torch.zeros_like(dist)), -1)
