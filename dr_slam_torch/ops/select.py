"""Deterministic selection helpers shared by the front-end and matchers.

`jax.lax.top_k` returns the lower index first among equal values, and
which keypoints, planes or lines fill a fixed capacity depends on it;
`torch.topk` promises no order for ties. A stable descending sort does."""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last axis, ties
    broken toward the lower index (lax.top_k order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
