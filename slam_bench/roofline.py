"""The yardstick's arithmetic: the H100's published peaks and the least
time a kernel's work could take on them.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit: HBM3
at 3.35 TB/s, int8 tensor cores at 1,979 TOP/s."""

from __future__ import annotations

H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12


def matcher_bound_ms(K: int, NC: int, n_valid: int) -> float:
    """Least time of one gated top-2 Hamming match of K keypoints against NC
    candidate slots, n_valid of them valid. Bytes: every candidate's valid
    flag is read and its column best written; a valid candidate's
    descriptor, position, radius, level and scale flag are read; the
    keypoints' descriptor, position, validity and octave are read and their
    best, second and index written. Operations: the binary dot product of
    every keypoint with every valid candidate, 2 * 256 int8 operations
    each, at the int8 tensor-core rate. The larger of the two bounds."""
    nbytes = NC * (1 + 4) + n_valid * (32 + 8 + 4 + 4 + 1) \
        + K * (32 + 8 + 1 + 4) + K * 12
    ops = 2.0 * K * n_valid * 256
    return max(nbytes / H100_BYTES_PER_S, ops / H100_INT8_OPS_PER_S) * 1e3
