"""Brown-Conrady (k1, k2, p1, p2, k3) camera distortion.

Counterpart of the JAX package's `geometry/camera.py`: Frame::UndistortKeyPoints
(reference src/Frame.cc:835) as a fixed-point iteration from x_u = x_d."""

from __future__ import annotations

import torch


def distort_points(uv: torch.Tensor, K4, dist) -> torch.Tensor:
    """Ideal pinhole pixels -> distorted pixels. uv (..., 2)."""
    fx, fy, cx, cy = K4
    k1, k2, p1, p2, k3 = dist
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd * fx + cx, yd * fy + cy], -1)


def undistort_points(uv: torch.Tensor, K4, dist,
                     n_iters: int = 10) -> torch.Tensor:
    """Distorted pixels -> ideal pinhole pixels (cv::undistortPoints with
    P = K semantics)."""
    fx, fy, cx, cy = K4
    k1, k2, p1, p2, k3 = dist
    xd = (uv[..., 0] - cx) / fx
    yd = (uv[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(n_iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        inv = 1.0 / torch.clamp(radial, min=1e-6)
        x = (xd - dx) * inv
        y = (yd - dy) * inv
    return torch.stack([x * fx + cx, y * fy + cy], -1)
