"""Occupancy-grid export.

Counterpart of the JAX package's `io/occupancy.py` (the capability of the
reference's octomap path, System::Save_OccupancyMap, src/System.cc:574-615):
the map's points, and the planes' sample clouds, counted into a 2D top-down
or a 3D voxel grid on the device, then saved as .npz and as a ROS map_server
PGM.

The grid is one `index_put_(..., accumulate=True)` into a tensor one cell
larger on each axis than the grid: points out of bounds or invalid are sent
to the extra cell and sliced away, as the reference's `mode="drop"` drops
them. The origin is computed on the host with the reference's numpy
expressions, and the cell index is `(p - origin) / resolution` in float32,
truncated toward zero, so the grids, and the files, are identical."""

from __future__ import annotations

import numpy as np
import torch

from dr_slam_torch import to_numpy


def _grid(points: torch.Tensor, ok: torch.Tensor, origin: np.ndarray,
          resolution: float, size: tuple) -> torch.Tensor:
    """Counts of `points` (N, D) float32 with `ok` over a grid of `size`
    (D axes) cells from `origin`; out-of-bounds points are dropped."""
    dev = points.device
    org = torch.from_numpy(np.asarray(origin, np.float32)).to(dev)
    dims = torch.tensor(size, dtype=torch.int32, device=dev)
    idx = ((points - org) / resolution).to(torch.int32)
    inb = ok & torch.all((idx >= 0) & (idx < dims), dim=1)
    idx = torch.where(inb[:, None], idx, dims).to(torch.int64)
    grid = torch.zeros(tuple(s + 1 for s in size), dtype=torch.int32,
                       device=dev)
    grid.index_put_(tuple(idx.T), torch.ones(idx.shape[0], dtype=torch.int32,
                                             device=dev), accumulate=True)
    return grid[tuple(slice(0, s) for s in size)]


def _on_device(points, valid) -> tuple[torch.Tensor, torch.Tensor]:
    """Points and mask as float32 and bool on the points' device (the CPU
    for host arrays)."""
    device = points.device if isinstance(points, torch.Tensor) else "cpu"
    p = torch.as_tensor(points).to(device=device, dtype=torch.float32)
    ok = torch.as_tensor(valid).to(device=device, dtype=torch.bool)
    return p, ok


def occupancy_grid_2d(points, valid, resolution: float = 0.05,
                      size: int = 256, origin=None, height_band=(-2.0, 2.0)):
    """Top-down (x, z) occupancy counts; points (N, 3) world, y vertical,
    counted on the points' device.

    -> (grid (size, size) int32 tensor, indexed [z, x], origin (2,) float32
    numpy)."""
    pts, ok = to_numpy(points), to_numpy(valid)
    ok = ok & (pts[:, 1] > height_band[0]) & (pts[:, 1] < height_band[1])
    if origin is None:
        sel = pts[ok] if ok.any() else np.zeros((1, 3))
        origin = sel[:, [0, 2]].min(0) - 2 * resolution
    origin = np.asarray(origin, np.float32)
    p, okd = _on_device(points, ok)
    # cells indexed [z, x], as the reference's grid.at[ij[:, 1], ij[:, 0]]
    grid = _grid(p[:, [2, 0]], okd, origin[::-1].copy(), resolution,
                 (size, size))
    return grid, origin


def occupancy_grid_3d(points, valid, resolution: float = 0.10,
                      size=(64, 32, 64), origin=None):
    """Voxel occupancy counts (the octomap capability) -> (grid (sx, sy, sz)
    int32 tensor, origin (3,) float32 numpy)."""
    pts, ok = to_numpy(points), to_numpy(valid)
    if origin is None:
        sel = pts[ok] if ok.any() else np.zeros((1, 3))
        origin = sel.min(0) - 2 * resolution
    origin = np.asarray(origin, np.float32)
    p, okd = _on_device(points, ok)
    return _grid(p, okd, origin, resolution, tuple(size)), origin


def save_occupancy_map(path: str, state, resolution: float = 0.05,
                       size: int = 256, min_hits: int = 1) -> None:
    """The 2D occupancy of the whole map (points and plane clouds) as
    `path`.npz (grid, origin, resolution) and `path`.pgm (ROS map_server
    grey: 0 occupied, 254 free)."""
    pts = torch.cat([state.pt_pos, state.pl_cloud.reshape(-1, 3)])
    ok = torch.cat([state.pt_valid, state.pl_cloud_valid.reshape(-1)])
    grid, origin = occupancy_grid_2d(pts, ok, resolution, size)
    grid = to_numpy(grid)
    np.savez(path + ".npz", grid=grid, origin=origin, resolution=resolution)
    occ = np.where(grid >= min_hits, 0, 254).astype(np.uint8)
    with open(path + ".pgm", "wb") as f:
        f.write(f"P5\n{size} {size}\n255\n".encode())
        f.write(occ[::-1].tobytes())
