"""Oriented-FAST + rotated-BRIEF keypoints as dense fixed-shape tensor code.

Counterpart of the JAX package's `ops/orb.py`: FAST score map per pyramid level,
per-cell argmax winners (the role of DistributeOctTree), intensity-centroid
angle at the winners, steered 256-pair BRIEF on the sigma-2-blurred level,
then a global top-k into `max_keypoints` slots with a validity mask.

Packed descriptors are (..., 8) int32 words holding the bits the reference
holds as uint32."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.ops import fast as fast_ops
from dr_slam_torch.ops import image as image_ops
from dr_slam_torch.ops.select import top_k

HALF_PATCH = 15
PATCH = 31
ANGLE_BINS = 30  # ORB quantizes steering angle to 2*pi/30


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (level-0 pixel coordinates)."""
    uv: torch.Tensor        # (K, 2) float32
    response: torch.Tensor  # (K,) float32
    angle: torch.Tensor     # (K,) float32 radians
    octave: torch.Tensor    # (K,) int32
    valid: torch.Tensor     # (K,) bool
    desc: torch.Tensor      # (K, 8) int32 packed 256-bit
    sigma2: torch.Tensor    # (K,) float32 scale^(2*octave)


def brief_pattern(seed: int = 42, n: int = 256, sigma_frac: float = 5.0
                  ) -> np.ndarray:
    """Deterministic 256-pair BRIEF sampling pattern, (n, 4) = (x1,y1,x2,y2):
    Gaussian pairs clipped to the radius-13 disc (same draw as the JAX
    package, so descriptors agree bit for bit)."""
    rng = np.random.RandomState(seed)
    sigma = PATCH / sigma_frac
    pts = rng.randn(n, 4) * sigma
    for pair in (slice(0, 2), slice(2, 4)):
        p = pts[:, pair]
        r = np.linalg.norm(p, axis=1, keepdims=True)
        scale = np.minimum(1.0, 13.0 / np.maximum(r, 1e-6))
        pts[:, pair] = p * scale
    return np.round(pts).astype(np.float32)


def _moment_kernels() -> tuple[np.ndarray, np.ndarray]:
    """31x31 x-moment and y-moment kernels over the radius-15 disc."""
    ys, xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
    disc = (xs ** 2 + ys ** 2 <= HALF_PATCH ** 2).astype(np.float32)
    return (xs * disc).astype(np.float32), (ys * disc).astype(np.float32)


_PATTERN = brief_pattern()
_KX_MOMENT, _KY_MOMENT = _moment_kernels()
_TABLES = {"pattern": _PATTERN, "kx": _KX_MOMENT, "ky": _KY_MOMENT}


@functools.lru_cache(maxsize=16)
def _table(name: str, device: torch.device) -> torch.Tensor:
    """Device copy of a constant table, made once per device."""
    return torch.from_numpy(_TABLES[name]).to(device)


def orientation_maps(img: torch.Tensor):
    """Dense (m10, m01) intensity-moment maps via two 31x31 convolutions
    (IC_Angle, ORBextractor.cc:77, at every pixel). Zero padding, SAME."""
    import torch.nn.functional as F
    x = img[None, None].to(torch.float32)
    kx = _table("kx", img.device)[None, None]
    ky = _table("ky", img.device)[None, None]
    m10 = F.conv2d(x, kx, padding=HALF_PATCH)[0, 0]
    m01 = F.conv2d(x, ky, padding=HALF_PATCH)[0, 0]
    return m10, m01


def orientation_at_points(img: torch.Tensor, vi: torch.Tensor,
                          ui: torch.Tensor) -> torch.Tensor:
    """IC_Angle at integer keypoint locations: gather each 31x31 patch and
    dot it with the moment kernels."""
    h, w = img.shape
    offs = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device)
    ys = torch.clamp(vi[:, None, None] + offs[None, :, None], 0, h - 1)
    xs = torch.clamp(ui[:, None, None] + offs[None, None, :], 0, w - 1)
    patch = img[ys, xs]                                     # (k, 31, 31)
    m10 = torch.einsum("kij,ij->k", patch, _table("kx", img.device))
    m01 = torch.einsum("kij,ij->k", patch, _table("ky", img.device))
    return torch.atan2(m01, m10)


def level_feature_counts(n_features: int, n_levels: int, scale: float
                         ) -> list[int]:
    """Per-level budgets, geometric in 1/scale."""
    inv = 1.0 / scale
    raw = [inv ** l for l in range(n_levels)]
    s = sum(raw)
    counts = [int(round(n_features * r / s)) for r in raw]
    counts[0] += n_features - sum(counts)
    return counts


def _cell_winners(score: torch.Tensor, cell: int):
    """Per-cell argmax -> (scores (C,), row (C,), col (C,)) over the grid of
    cell x cell blocks (the last row/column of blocks padded with -inf)."""
    h, w = score.shape
    gh = -(-h // cell)
    gw = -(-w // cell)
    s = torch.nn.functional.pad(score, (0, gw * cell - w, 0, gh * cell - h),
                                value=-torch.inf)
    s4 = (s.reshape(gh, cell, gw, cell).permute(0, 2, 1, 3)
          .reshape(gh, gw, cell * cell))
    best_score = torch.amax(s4, dim=-1)
    best = torch.argmax(s4, dim=-1)
    cy = best // cell
    cx = best % cell
    yy = torch.arange(gh, device=score.device)[:, None] * cell + cy
    xx = torch.arange(gw, device=score.device)[None, :] * cell + cx
    return best_score.reshape(-1), yy.reshape(-1), xx.reshape(-1)


def _extract_level(img_l: torch.Tensor, blur_l: torch.Tensor, n_take: int,
                   min_th: float, cell: int, border: int):
    """One pyramid level -> (uv (n,2), score (n,), angle (n,), valid (n,),
    desc_bits (n,256) bool) in level coordinates."""
    h, w = img_l.shape
    score = fast_ops.fast_score(img_l)
    inb = fast_ops.border_mask(h, w, border, img_l.device)
    score0 = torch.where(inb, score, torch.full_like(score, -torch.inf))
    score = fast_ops.nms3x3(score0)

    cs, cy, cx = _cell_winners(score, cell)
    k = min(n_take, cs.shape[0])
    top_s, top_i = top_k(cs, k)
    ui0 = cx[top_i]
    vi0 = cy[top_i]
    valid = top_s > min_th

    # subpixel refinement: 1D quadratic fit on the raw score map
    g = image_ops.gather2d
    s_c = g(score0, vi0, ui0)
    s_l = g(score0, vi0, ui0 - 1)
    s_r = g(score0, vi0, ui0 + 1)
    s_u = g(score0, vi0 - 1, ui0)
    s_d = g(score0, vi0 + 1, ui0)
    denx = s_l - 2.0 * s_c + s_r
    deny = s_u - 2.0 * s_c + s_d
    one = torch.ones_like(denx)
    offx = torch.where(torch.isfinite(denx) & (torch.abs(denx) > 1e-6),
                       0.5 * (s_l - s_r) / torch.where(torch.abs(denx) > 1e-6,
                                                       denx, one),
                       torch.zeros_like(denx))
    offy = torch.where(torch.isfinite(deny) & (torch.abs(deny) > 1e-6),
                       0.5 * (s_u - s_d) / torch.where(torch.abs(deny) > 1e-6,
                                                       deny, one),
                       torch.zeros_like(deny))
    u = ui0.to(torch.float32) + torch.clamp(offx, -0.5, 0.5)
    v = vi0.to(torch.float32) + torch.clamp(offy, -0.5, 0.5)

    angle = orientation_at_points(img_l, vi0, ui0)

    # steered BRIEF from the blurred level image
    a_bin = torch.round(angle / (2 * math.pi / ANGLE_BINS))
    a_q = a_bin * (2 * math.pi / ANGLE_BINS)
    ca, sa = torch.cos(a_q), torch.sin(a_q)
    pat = _table("pattern", img_l.device)                   # (256, 4)
    x1 = pat[None, :, 0] * ca[:, None] - pat[None, :, 1] * sa[:, None]
    y1 = pat[None, :, 0] * sa[:, None] + pat[None, :, 1] * ca[:, None]
    x2 = pat[None, :, 2] * ca[:, None] - pat[None, :, 3] * sa[:, None]
    y2 = pat[None, :, 2] * sa[:, None] + pat[None, :, 3] * ca[:, None]
    uv1 = torch.stack([u[:, None] + x1, v[:, None] + y1], -1)
    uv2 = torch.stack([u[:, None] + x2, v[:, None] + y2], -1)
    s1 = image_ops.nearest_sample(blur_l, uv1)
    s2 = image_ops.nearest_sample(blur_l, uv2)
    bits = s1 < s2
    return torch.stack([u, v], -1), top_s, angle, valid, bits


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 (the uint32 words' bit patterns)."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(b << shifts, dim=-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 -> (..., 256) bool. Arithmetic shifts of the int32
    words leave bits 0..31 where logical shifts of uint32 would."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    b = (packed[..., None] >> shifts) & 1
    return b.reshape(packed.shape[:-1] + (256,)).to(torch.bool)


def bits_to_signs(bits: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """bool bits -> +/-1 for Hamming-as-matmul (exact in float32)."""
    return (bits.to(torch.float32) * 2.0 - 1.0).to(dtype)


def extract_orb(img: torch.Tensor, n_features: int = 1000, n_levels: int = 8,
                scale: float = 1.2, max_keypoints: int = 1024,
                cell: int = 16, ini_th: float = 20.0, min_th: float = 7.0
                ) -> Keypoints:
    """Full ORB extraction on one gray image (H, W) float32 [0, 255]."""
    del ini_th  # the score map subsumes the two-threshold scheme
    pyr = image_ops.build_pyramid(img, n_levels, scale)
    counts = level_feature_counts(n_features, n_levels, scale)
    border = HALF_PATCH + 1

    all_uv, all_s, all_a, all_v, all_b, all_o, all_sig = ([] for _ in range(7))
    for l in range(n_levels):
        img_l = pyr[l]
        blur_l = image_ops.gaussian_blur(img_l)
        uv, s, a, v, bits = _extract_level(
            img_l, blur_l, counts[l] + counts[l] // 2 + 8, min_th, cell, border)
        lvl_scale = scale ** l
        all_uv.append(uv * lvl_scale)
        all_s.append(torch.where(v, s, torch.full_like(s, -torch.inf)))
        all_a.append(a)
        all_v.append(v)
        all_b.append(bits)
        all_o.append(torch.full(s.shape, l, dtype=torch.int32, device=s.device))
        all_sig.append(torch.full(s.shape, lvl_scale * lvl_scale,
                                  dtype=torch.float32, device=s.device))

    uv = torch.cat(all_uv)
    s = torch.cat(all_s)
    a = torch.cat(all_a)
    v = torch.cat(all_v)
    bits = torch.cat(all_b)
    o = torch.cat(all_o)
    sig = torch.cat(all_sig)

    k = min(max_keypoints, s.shape[0])
    top_s, idx = top_k(s, k)
    pad = max_keypoints - k

    def take(arr):
        return take_pad(arr[idx], pad)

    finite = torch.isfinite(top_s)
    resp = torch.where(finite, top_s, torch.zeros_like(top_s))
    return Keypoints(
        uv=take(uv),
        response=take_pad(resp, pad),
        angle=take(a),
        octave=take(o),
        valid=take_pad(v[idx] & finite, pad),
        desc=pack_bits(take(bits)),
        sigma2=take(sig),
    )


def take_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad the leading axis by `pad` rows."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
