"""Depth-map surface normals (average-3D-gradient stencil).

Counterpart of the JAX package's `ops/normals.py`: box-smoothed cloud
derivatives, cross product, oriented toward the camera, decimated by 6."""

from __future__ import annotations

import torch

from dr_slam_torch.geometry.se3 import cross
from dr_slam_torch.ops import image as image_ops


def depth_to_cloud(depth: torch.Tensor, K4) -> torch.Tensor:
    """(H, W) depth -> (H, W, 3) camera-frame point cloud."""
    h, w = depth.shape
    fx, fy, cx, cy = K4
    xx = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    yy = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    x = (xx - cx) / fx * depth
    y = (yy - cy) / fy * depth
    return torch.stack([x, y, depth], -1)


def surface_normals(depth: torch.Tensor, K4, smooth_radius: int = 4,
                    step: int = 6):
    """-> (normals (H//step, W//step, 3), valid (H//step, W//step))."""
    valid = depth > 1e-3
    d = torch.where(valid, depth, torch.zeros_like(depth))
    cloud = depth_to_cloud(d, K4)

    vf = valid.to(torch.float32)
    wsum = image_ops.box_filter(vf, smooth_radius)
    sm = torch.stack(
        [image_ops.box_filter(cloud[..., c] * vf, smooth_radius)
         for c in range(3)], -1) / torch.clamp(wsum[..., None], min=1e-6)

    ddx = 0.5 * (torch.roll(sm, -1, dims=1) - torch.roll(sm, 1, dims=1))
    ddy = 0.5 * (torch.roll(sm, -1, dims=0) - torch.roll(sm, 1, dims=0))
    n = cross(ddx, ddy)
    norm = torch.linalg.norm(n, dim=-1, keepdim=True)
    n = n / torch.clamp(norm, min=1e-12)
    flip = torch.where(torch.sum(n * cloud, -1) > 0, -1.0, 1.0).to(n.dtype)
    n = n * flip[..., None]

    ok = valid & (norm[..., 0] > 1e-9) & (wsum > 0.5)
    n = n[step // 2::step, step // 2::step]
    ok = ok[step // 2::step, step // 2::step]
    return n, ok
