"""Manhattan-frame rotation tracking on the Gaussian sphere.

Counterpart of the JAX package's `manhattan/tracker.py` (Tracking::
TrackManhattanFrame, src/Tracking.cc:1336-1527): per axis, cone mask, tangent
map, one Gaussian mean-shift step, back to the sphere; three passes per
frame; >= 2 recovered axes or the previous rotation is kept."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from dr_slam_torch.geometry import se3


class ManhattanResult(NamedTuple):
    R_cm: torch.Tensor        # (3, 3) refined Manhattan->camera rotation
    success: torch.Tensor     # () bool: >= 2 axes recovered
    n_members: torch.Tensor   # (3,) int cone membership per axis


def _axis_update(R_cm, dirs, weights, valid, axis, cone_sin, kernel,
                 min_members):
    """One mean-shift update of axis `axis` -> (new axis (3,), ok, count)."""
    a = R_cm[:, axis]
    other1 = R_cm[:, (axis + 1) % 3]
    other2 = R_cm[:, (axis + 2) % 3]
    Rp = torch.stack([other1, other2, a], dim=1)

    d = dirs @ Rp
    d = d * torch.where(d[:, 2:3] < 0, -1.0, 1.0).to(d.dtype)
    nz = torch.clamp(d[:, 2], min=1e-6)
    lam = torch.sqrt(d[:, 0] ** 2 + d[:, 1] ** 2)
    in_cone = valid & (lam < cone_sin)

    alpha = torch.arcsin(torch.clamp(lam, 0.0, 0.999))
    scale = torch.where(alpha > 1e-5, alpha / torch.tan(alpha + 1e-12),
                        torch.ones_like(alpha))
    m = scale[:, None] * d[:, :2] / nz[:, None]

    w = torch.exp(-kernel * torch.sum(m * m, -1)) * weights * in_cone
    wsum = torch.sum(w)
    s = torch.sum(m * w[:, None], 0) / torch.clamp(wsum, min=1e-9)

    new_local = torch.cat([s, torch.ones(1, dtype=s.dtype, device=s.device)])
    new_local = new_local / torch.linalg.norm(new_local)
    new_axis = Rp @ new_local

    count = torch.sum(in_cone & (weights > 0))
    ok = count >= min_members
    return torch.where(ok, new_axis, a), ok, count


def track_manhattan_frame(R_cm_prev: torch.Tensor,
                          normals: torch.Tensor, normals_valid: torch.Tensor,
                          line_dirs: torch.Tensor | None = None,
                          line_valid: torch.Tensor | None = None,
                          cone_normals: float = 0.2018,
                          cone_lines: float = 0.1018,
                          kernel: float = 20.0,
                          min_ratio: float = 0.05,
                          n_iterations: int = 3,
                          tol: float = 1e-3) -> ManhattanResult:
    """Refine R_cm from a surface-normal field (+ optional line directions)."""
    normals = normals.reshape(-1, 3)
    normals_valid = normals_valid.reshape(-1)
    if line_dirs is None:
        line_dirs = normals.new_zeros((1, 3))
        line_valid = torch.zeros((1,), dtype=torch.bool, device=normals.device)
    line_dirs = line_dirs.reshape(-1, 3)
    line_valid = line_valid.reshape(-1)

    dirs = torch.cat([normals, line_dirs], 0)
    nrm = torch.linalg.norm(dirs, dim=-1, keepdim=True)
    dirs = dirs / torch.clamp(nrm, min=1e-9)
    valid = torch.cat([normals_valid, line_valid], 0) & (nrm[:, 0] > 1e-6)
    weights = torch.ones(dirs.shape[0], dtype=dirs.dtype, device=dirs.device)

    n_valid_normals = torch.sum(normals_valid)
    min_members = torch.clamp((min_ratio * n_valid_normals).to(torch.int32),
                              min=1)

    sin_cone = torch.cat([
        torch.full((normals.shape[0],), math.sin(cone_normals),
                   dtype=dirs.dtype, device=dirs.device),
        torch.full((line_dirs.shape[0],), math.sin(cone_lines),
                   dtype=dirs.dtype, device=dirs.device)])

    R = R_cm_prev
    success = torch.zeros((), dtype=torch.bool, device=dirs.device)
    counts = torch.zeros(3, dtype=torch.int64, device=dirs.device)
    for _ in range(n_iterations):
        axes, oks, cnts = [], [], []
        for axis in range(3):
            na, ok, cnt = _axis_update(R, dirs, weights, valid, axis,
                                       sin_cone, kernel, min_members)
            axes.append(na)
            oks.append(ok)
            cnts.append(cnt)
        ax = torch.stack(axes, 1)
        ok3 = torch.stack(oks)
        n_ok = torch.sum(ok3)

        # exactly-2 recovery: rebuild the failed axis from the other two
        cols = [ax[:, i] for i in range(3)]
        for axis in range(3):
            other1 = cols[(axis + 1) % 3]
            other2 = cols[(axis + 2) % 3]
            rebuilt = se3.cross(other1, other2)
            rebuilt = rebuilt / torch.clamp(torch.linalg.norm(rebuilt), min=1e-9)
            use = (~ok3[axis]) & ok3[(axis + 1) % 3] & ok3[(axis + 2) % 3]
            cols[axis] = torch.where(use, rebuilt, cols[axis])
        ax = torch.stack(cols, 1)

        R_new = se3.orthonormalize_rotation(ax)
        success = n_ok >= 2
        R = torch.where(success, R_new, R)
        counts = torch.stack(cnts)
    return ManhattanResult(R_cm=R, success=success, n_members=counts)
