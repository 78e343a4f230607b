"""Per-frame front-end: ORB keypoints, depth at keypoints, surface normals,
plane segmentation and line features of one RGB-D frame.

Counterpart of the JAX package's `frontend/frame.py`, with the CAPE
cylinders (`ops/cylinders.py`) when `plane.detect_cylinders` is set (off by
default, as in the reference). Depth sampling at keypoints mirrors ComputeStereoFromRGBD
(Frame.cc:893): uR = u - bf/z where depth is valid, -1 otherwise."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.ops import cylinders as cylinder_ops
from dr_slam_torch.ops import lines as line_ops
from dr_slam_torch.ops import normals as normal_ops
from dr_slam_torch.ops import orb as orb_ops
from dr_slam_torch.ops import planes as plane_ops


class FrameFeatures(NamedTuple):
    kp: orb_ops.Keypoints          # fixed-capacity ORB keypoints
    kp_depth: torch.Tensor         # (K,) depth in meters (0 = invalid)
    kp_ur: torch.Tensor            # (K,) stereo right coord (-1 = mono)
    kp_xyz: torch.Tensor           # (K, 3) camera-frame backprojection
    normals: torch.Tensor          # (Nn, 3) surface-normal field
    normals_valid: torch.Tensor    # (Nn,)
    planes: plane_ops.PlaneSegmentation
    lines: line_ops.LineFeatures
    cylinders: object = None       # CylinderSegmentation when enabled


def _sample_depth(depth: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Depth at keypoints: nearest pixel, with a 3x3 min-positive fallback
    so keypoints on depth edges still get a value."""
    h, w = depth.shape
    x = torch.clamp(torch.round(uv[:, 0]).to(torch.int64), 1, w - 2)
    y = torch.clamp(torch.round(uv[:, 1]).to(torch.int64), 1, h - 2)
    center = depth[y, x]
    best = torch.full_like(center, torch.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            v = depth[y + dy, x + dx]
            best = torch.where((v > 1e-3) & (v < best), v, best)
    zero = torch.zeros_like(center)
    return torch.where(center > 1e-3, center,
                       torch.where(torch.isfinite(best), best, zero))


def ingest(gray, depth, cam, device=None):
    """Camera-native frame ingestion: gray uint8 or float32 [0, 255]; depth
    integer sensor units (scaled by 1/DepthMapFactor on the device) or
    float32 meters. Accepts numpy arrays or tensors; returns float32
    tensors on `device` (default cuda)."""
    dev = resolve_device(device)
    if isinstance(gray, np.ndarray):
        gray = torch.from_numpy(np.array(gray))
    if isinstance(depth, np.ndarray):
        # torch has no uint16 arithmetic: widen sensor units to int32
        depth = torch.from_numpy(np.array(
            depth, dtype=np.int32 if depth.dtype == np.uint16 else depth.dtype))
    gray = gray.to(dev)
    depth = depth.to(dev)
    if gray.dtype != torch.float32:
        gray = gray.to(torch.float32)
    if not depth.is_floating_point():
        depth = depth.to(torch.float32) * (1.0 / cam.depth_factor)
    elif depth.dtype != torch.float32:
        depth = depth.to(torch.float32)
    return gray, depth


def extract_frame(gray, depth, cfg: SlamConfig, device=None) -> FrameFeatures:
    """gray (H, W) uint8 or [0,255] float32, depth (H, W) uint16 sensor
    units or float32 meters -> FrameFeatures on `device` (default cuda)."""
    gray, depth = ingest(gray, depth, cfg.camera, device)
    return _extract_frame(gray, depth, cfg.camera, cfg.orb, cfg.plane, cfg.line)


def _extract_frame(gray, depth, cam, orb, plane, line) -> FrameFeatures:
    """gray and depth as `ingest` returns them: float32 tensors on one
    device."""
    K4 = cam.K4
    kp = orb_ops.extract_orb(
        gray, n_features=orb.n_features, n_levels=orb.n_levels,
        scale=orb.scale_factor, max_keypoints=orb.max_keypoints,
        cell=orb.cell_size, ini_th=float(orb.ini_th_fast),
        min_th=float(orb.min_th_fast))
    # depth is sampled at the raw pixel (the depth image lives in distorted
    # pixel space), the geometry at the undistorted one
    d = _sample_depth(depth, kp.uv)
    dist = (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3)
    if any(c != 0.0 for c in dist):
        from dr_slam_torch.geometry.camera import undistort_points
        kp = kp._replace(uv=undistort_points(kp.uv, K4, dist))
    ur = torch.where(d > 1e-3, kp.uv[:, 0] - cam.bf / torch.clamp(d, min=1e-6),
                     torch.full_like(d, -1.0))
    fx, fy, cx, cy = K4
    xyz = torch.stack([(kp.uv[:, 0] - cx) / fx * d,
                       (kp.uv[:, 1] - cy) / fy * d,
                       d], -1)

    nrm, nrm_ok = normal_ops.surface_normals(depth, K4)
    seg = plane_ops.segment_planes(
        depth, K4, block=plane.block, max_planes=plane.max_planes,
        min_blocks=plane.min_blocks, merge_angle_cos=plane.merge_angle_cos,
        merge_dist=plane.merge_dist, mse_factor=plane.mse_factor,
        max_depth=plane.max_depth, cloud_points=plane.cloud_points)
    maxd = plane_ops.max_point_distance_from_plane(seg.coeffs, seg.cloud,
                                                   seg.cloud_valid)
    seg = seg._replace(valid=seg.valid & (maxd < plane.max_point_dist))

    lf = line_ops.extract_lines(
        gray, depth, K4, max_lines=line.max_lines,
        grad_threshold=line.grad_threshold,
        min_length=line.min_length, n_samples=line.n_samples)

    cyl = None
    if plane.detect_cylinders:
        cyl = cylinder_ops.segment_cylinders(
            depth, K4, seg.block_label, block=plane.block,
            max_cylinders=plane.max_cylinders, mse_factor=plane.mse_factor,
            max_depth=plane.max_depth)

    return FrameFeatures(kp=kp, kp_depth=d, kp_ur=ur, kp_xyz=xyz,
                         normals=nrm.reshape(-1, 3),
                         normals_valid=nrm_ok.reshape(-1),
                         planes=seg, lines=lf, cylinders=cyl)
