"""Manhattan-frame bootstrap from frame planes (and line directions).

Counterpart of the JAX package's `manhattan/bootstrap.py` (Map::FindManhattan,
src/Map.cc:178-404): the best pair of perpendicular planes, scored over all
pairs at once, with the best plane-line pair as the fallback; the third axis
is the cross product, then the rotation is orthonormalised."""

from __future__ import annotations

import torch

from dr_slam_torch.geometry import se3


def find_manhattan(plane_normals: torch.Tensor, plane_valid: torch.Tensor,
                   plane_weight: torch.Tensor,
                   line_dirs: torch.Tensor | None = None,
                   line_valid: torch.Tensor | None = None,
                   vertical_cos: float = 0.0871):
    """-> (R_cm (3, 3), success ()). plane_normals (P, 3) in the camera
    frame, plane_weight the support of each plane (member block counts)."""
    dev = plane_normals.device
    n = plane_normals / torch.clamp(
        torch.linalg.norm(plane_normals, dim=-1, keepdim=True), min=1e-9)
    P = n.shape[0]
    w = plane_weight * plane_valid

    # plane-plane pairs, scored over the strict upper triangle (row-major,
    # as jnp.triu_indices lists it; argmax takes the first best)
    dots = torch.abs(n @ n.T)
    perp = dots < vertical_cos
    pair_w = w[:, None] + w[None, :]
    iu = torch.triu_indices(P, P, offset=1, device=dev)
    score = torch.where(perp & (w[:, None] > 0) & (w[None, :] > 0), pair_w,
                        torch.full_like(pair_w, -1.0))
    score_flat = score[iu[0], iu[1]]
    best = torch.argmax(score_flat)
    ok_pp = score_flat[best] > 0
    a1_pp = n[iu[0][best]]
    a2_pp = n[iu[1][best]]

    # plane-line fallback (Map.cc:237-296)
    if line_dirs is None:
        line_dirs = torch.zeros((1, 3), device=dev)
        line_valid = torch.zeros((1,), dtype=torch.bool, device=dev)
    ld = line_dirs / torch.clamp(
        torch.linalg.norm(line_dirs, dim=-1, keepdim=True), min=1e-9)
    pl = torch.abs(n @ ld.T)
    perp_pl = (pl < vertical_cos) & (w[:, None] > 0) & line_valid[None, :]
    score_pl = torch.where(perp_pl, w[:, None].expand_as(pl),
                           torch.full_like(pl, -1.0))
    best_pl = torch.argmax(score_pl)
    L = ld.shape[0]
    ok_pl = score_pl.reshape(-1)[best_pl] > 0
    a1_fb = n[best_pl // L]
    a2_fb = ld[best_pl % L]

    a1 = torch.where(ok_pp, a1_pp, a1_fb)
    a2 = torch.where(ok_pp, a2_pp, a2_fb)
    success = ok_pp | ok_pl

    # Gram-Schmidt, cross product, orthonormalise (Map.cc:393-399)
    a2 = a2 - torch.dot(a1, a2) * a1
    a2 = a2 / torch.clamp(torch.linalg.norm(a2), min=1e-9)
    a3 = se3.cross(a1, a2)
    R = se3.orthonormalize_rotation(torch.stack([a1, a2, a3], dim=1))
    R = torch.where(success, R, torch.eye(3, dtype=R.dtype, device=dev))
    return R, success
