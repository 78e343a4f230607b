"""FAST-9/16 corner score as dense tensor ops.

Counterpart of the JAX package's `ops/fast.py`: the closed-form score is the max
over the 16 circular arcs of 9 contiguous circle pixels of the min signed
difference, so a pixel is a FAST-9 corner at threshold t iff score > t."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 points in circular order, as (dy, dx).
CIRCLE_OFFSETS = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)


def _circle_stack(img: torch.Tensor) -> torch.Tensor:
    """(16, H, W) circle neighbours of every pixel (wrapping at borders;
    the caller masks the borders)."""
    return torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                        for dy, dx in CIRCLE_OFFSETS], 0)


def _arc_min9(d: torch.Tensor) -> torch.Tensor:
    """Min over each window of 9 circularly consecutive entries of axis 0."""
    m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
    m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
    m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
    return torch.minimum(m8, torch.roll(d, -8, dims=0))


def border_mask(h: int, w: int, border: int, device) -> torch.Tensor:
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return ((yy >= border) & (yy < h - border)
            & (xx >= border) & (xx < w - border))


def fast_score(img: torch.Tensor, border: int = 3) -> torch.Tensor:
    """Per-pixel FAST-9 corner score (H, W) float32, -inf on the border."""
    img = img.to(torch.float32)
    d = _circle_stack(img) - img[None]
    bright = torch.amax(_arc_min9(d), dim=0)
    dark = torch.amax(_arc_min9(-d), dim=0)
    score = torch.maximum(bright, dark)
    h, w = img.shape
    valid = border_mask(h, w, border, img.device)
    return torch.where(valid, score, torch.full_like(score, -torch.inf))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only 3x3 local maxima (SAME window, -inf padding)."""
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= pooled, score,
                       torch.full_like(score, -torch.inf))
