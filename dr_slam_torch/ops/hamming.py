"""Hamming distances between packed 256-bit descriptors.

Counterpart of the JAX package's `ops/hamming.py`. With descriptors as +/-1
vectors s, dot(s_a, s_b) = 256 - 2 * hamming, so one float32 matmul scores
every pair exactly (the sums are integers bounded by 256).
`hamming_popcount` is the exact XOR + popcount golden;
`mutual_best_matches` turns a distance table into mutual row-best matches."""

from __future__ import annotations

import torch

from dr_slam_torch.ops.orb import bits_to_signs, unpack_bits


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """desc_a (A, 8), desc_b (B, 8) int32 packed -> (A, B) float32."""
    sa = bits_to_signs(unpack_bits(desc_a))
    sb = bits_to_signs(unpack_bits(desc_b))
    return (256.0 - sa @ sb.T) * 0.5


def hamming_matrix_signs(signs_a: torch.Tensor,
                         signs_b: torch.Tensor) -> torch.Tensor:
    """The same from precomputed +/-1 float32 representations."""
    return (256.0 - signs_a @ signs_b.T) * 0.5


def mutual_best_matches(dist: torch.Tensor, max_dist: float,
                        ratio: float | None = None):
    """Row-best matches with an optional Lowe ratio test and the mutual
    check; argmin ties go to the first index on rows and on columns.
    -> (match (A,) int64 best column or -1, best distance (A,))."""
    best_j = torch.argmin(dist, 1)
    a_idx = torch.arange(dist.shape[0], device=dist.device)
    best_d = dist[a_idx, best_j]
    ok = best_d <= max_dist
    if ratio is not None:
        second = torch.amin(dist.scatter(1, best_j[:, None], torch.inf), 1)
        ok = ok & (best_d < ratio * second)
    best_i = torch.argmin(dist, 0)
    ok = ok & (best_i[best_j] == a_idx)
    return torch.where(ok, best_j, -1), best_d


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """Exact per-word popcount of 32-bit words held in int32 or int64
    (computed on the low 32 bits in int64, so the shifts are logical)."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def hamming_popcount(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Pairwise Hamming via XOR + popcount -> (A, B) int32."""
    x = torch.bitwise_xor(desc_a[:, None, :], desc_b[None, :, :])
    return torch.sum(popcount_u32(x), dim=-1).to(torch.int32)
