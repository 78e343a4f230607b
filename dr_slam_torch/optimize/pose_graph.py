"""Conjugate gradients for the matrix-free Gauss-Newton solvers.

Counterpart of `_cg` in the JAX package's `optimize/pose_graph.py`, which
bundle adjustment shares. The pose-graph optimisation itself belongs to loop
closing and is not ported yet."""

from __future__ import annotations

import torch


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
