"""Pose-graph optimisation (the essential graph) by matrix-free Gauss-Newton,
and the conjugate gradients that bundle adjustment shares.

Counterpart of the JAX package's `optimize/pose_graph.py` (the capability of
Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:2894): after a loop
closure every keyframe pose relaxes against relative SE3 constraints
(temporal chain, covisibility and loop edges; the scale fixed for RGB-D).
The residuals are se3_log of the pose-cycle errors over an edge table.

The reference linearizes the residual function once per Gauss-Newton step
(`jax.linearize`) and runs 60 CG iterations on that linearization. Here each
edge's residual depends on its two poses only, so each step takes the
per-edge 6 x 12 Jacobians once (twelve forward-mode products over all
edges); a CG iteration is then a gather, two small batched products and a
scatter-add (J^T (J v)), and never evaluates the residual function again."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr_slam_torch.geometry import se3


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (NK, 4, 4) initial T_cw
    pose_valid: torch.Tensor   # (NK,)
    edge_i: torch.Tensor       # (E,) int
    edge_j: torch.Tensor       # (E,) int
    edge_T_ij: torch.Tensor    # (E, 4, 4) measured T_i @ inv(T_j)
    edge_valid: torch.Tensor   # (E,)
    edge_weight: torch.Tensor  # (E,)
    fixed: torch.Tensor        # (NK,) bool: poses to keep (the gauge)
    # robust (IRLS) eligibility per edge: odometry and covisibility edges
    # can carry a gauge jump; RANSAC-verified loop edges are exempt. None:
    # every edge is robust.
    edge_robust: torch.Tensor | None = None


def _cg(hvp, b: torch.Tensor, n_iters: int, damping: float) -> torch.Tensor:
    """Conjugate gradients on (H + damping I) x = b from x0 = 0, a fixed
    number of iterations; `hvp(v)` is H v. Runs without a host readback."""
    x = torch.zeros_like(b)
    r = b
    p = r
    rs = torch.dot(r, r)
    for _ in range(n_iters):
        Ap = hvp(p) + damping * p
        alpha = rs / torch.clamp(torch.dot(p, Ap), min=1e-12)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.dot(r, r)
        beta = rs_new / torch.clamp(rs, min=1e-12)
        p = r + beta * p
        rs = rs_new
    return x


def _edge_residual(xi_i, xi_j, T_i, T_j, T_ij):
    """One edge's residual under left updates of its two poses."""
    Ti = se3.se3_exp(xi_i) @ T_i
    Tj = se3.se3_exp(xi_j) @ T_j
    return se3.se3_log(T_ij @ Tj @ se3.inv_T(Ti))


def _edge_jacobians(Ti, Tj, T_ij):
    """(E, 6, 6) d r_e / d xi_i and d r_e / d xi_j at xi = 0: twelve
    forward-mode products over the whole edge batch, one per tangent basis
    vector, batched with vmap. (Per-edge vmap would make the rotations
    0-dim, where forward mode promotes a Python float to a float64
    tangent.)"""
    E = Ti.shape[0]
    zero = torch.zeros((E, 6), dtype=Ti.dtype, device=Ti.device)
    basis = torch.eye(6, dtype=Ti.dtype, device=Ti.device)[:, None, :]

    def column(v_i, v_j):
        return torch.func.jvp(
            lambda a, b: _edge_residual(a, b, Ti, Tj, T_ij),
            (zero, zero), (v_i.expand(E, 6), v_j.expand(E, 6)))[1]

    cols_i = torch.func.vmap(column)(basis, torch.zeros_like(basis))
    cols_j = torch.func.vmap(column)(torch.zeros_like(basis), basis)
    # (6 param, E, 6 residual) -> (E, 6 residual, 6 param)
    return cols_i.permute(1, 2, 0), cols_j.permute(1, 2, 0)


def optimize_pose_graph(g: PoseGraph, n_gn_iters: int = 10,
                        n_cg_iters: int = 60, damping: float = 1e-4,
                        huber_delta: float = 0.08) -> torch.Tensor:
    """-> optimised (NK, 4, 4) poses.

    huber_delta: IRLS width on the edge residual norm (robust-eligible
    edges only). The kernel is redescending (Tukey biweight, cut at 3 x
    delta): a gauge-jump edge drops out instead of pulling as hard as a
    healthy one; a 0.01 floor keeps a node whose edges are all poisoned
    weakly tied rather than singular."""
    NK = g.poses.shape[0]
    dev = g.poses.device
    w = g.edge_valid.to(torch.float32) * g.edge_weight
    robust = (torch.ones_like(w, dtype=torch.bool) if g.edge_robust is None
              else g.edge_robust)
    free = (g.pose_valid & ~g.fixed).to(torch.float32)[:, None]
    ei = g.edge_i.to(torch.int64)
    ej = g.edge_j.to(torch.int64)
    fi, fj = free[ei], free[ej]                                  # (E, 1)

    T_cur = g.poses
    for _ in range(n_gn_iters):
        Ti, Tj = T_cur[ei], T_cur[ej]
        r = se3.se3_log(g.edge_T_ij @ Tj @ se3.inv_T(Ti))        # (E, 6)
        # IRLS from the residuals at the current iterate
        rn = torch.linalg.norm(r, dim=-1)
        c = 3.0 * huber_delta
        tukey = torch.where(rn < c, (1.0 - (rn / c) ** 2) ** 2, 0.0)
        w_irls = torch.where(robust, torch.clamp(tukey, min=0.01), 1.0)
        sw = torch.sqrt(w * w_irls)[:, None]                     # (E, 1)
        J_i, J_j = _edge_jacobians(Ti, Tj, g.edge_T_ij)
        # weighted, with the fixed poses' columns zeroed (xi * free)
        A_i = J_i * (sw[:, :, None] * fi[:, None, :])            # (E, 6, 6)
        A_j = J_j * (sw[:, :, None] * fj[:, None, :])
        r_w = r * sw

        def jt(u):
            """J^T u for a (E, 6) residual-space vector -> (NK * 6,)."""
            out = torch.zeros((NK, 6), device=dev)
            out.index_add_(0, ei, torch.einsum("eki,ek->ei", A_i, u))
            out.index_add_(0, ej, torch.einsum("eki,ek->ei", A_j, u))
            return out.reshape(-1)

        def hvp(v):
            v = v.reshape(NK, 6)
            Jv = (torch.einsum("eki,ei->ek", A_i, v[ei])
                  + torch.einsum("eki,ei->ek", A_j, v[ej]))
            return jt(Jv)

        dx = _cg(hvp, -jt(r_w), n_cg_iters, damping)
        dx = torch.where(torch.all(torch.isfinite(dx)), dx, 0.0)
        T_cur = se3.se3_exp(dx.reshape(NK, 6) * free) @ T_cur
    return T_cur
