"""Core image ops: separable convolution, Gaussian blur, antialiased
bilinear resize, image pyramid, gradients, point sampling.

Counterpart of the JAX package's `ops/image.py`. The resize reproduces
`jax.image.resize(..., "bilinear")`, which widens its triangle filter by the
scale factor on downscale (antialiasing); `F.interpolate` does not, so the
per-axis weight matrices are built here the way
`jax.image.scale_and_translate` builds them and applied as two matmuls."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _const(key, device: torch.device) -> torch.Tensor:
    """Device copy of a constant numpy table, made once per device."""
    kind, args = key
    if kind == "gauss":
        arr = _gaussian_kernel1d(*args)
    elif kind == "box":
        r = args[0]
        arr = np.full((2 * r + 1,), 1.0 / (2 * r + 1), np.float32)
    elif kind == "resize":
        arr = _resize_weights(*args)
    elif kind == "array":
        arr = np.asarray(args, np.float32)
    else:
        raise KeyError(kind)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def sep_conv2d(img: torch.Tensor, kx, ky) -> torch.Tensor:
    """Separable 2D cross-correlation with replicate (edge) padding.
    img (H, W) float32; kx, ky 1-D kernels (odd length)."""
    kx = torch.as_tensor(kx, dtype=img.dtype, device=img.device)
    ky = torch.as_tensor(ky, dtype=img.dtype, device=img.device)
    rx = kx.shape[0] // 2
    ry = ky.shape[0] // 2
    x = F.pad(img[None, None], (rx, rx, ry, ry), mode="replicate")
    x = F.conv2d(x, kx.reshape(1, 1, 1, -1))
    x = F.conv2d(x, ky.reshape(1, 1, -1, 1))
    return x[0, 0]


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """7x7 sigma-2 Gaussian (ORBextractor.cc computeDescriptors)."""
    k = _const(("gauss", (sigma, radius)), img.device)
    return sep_conv2d(img, k, k)


def box_filter(img: torch.Tensor, radius: int) -> torch.Tensor:
    k = _const(("box", (radius,)), img.device)
    return sep_conv2d(img, k, k)


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.scale_and_translate with
    the triangle kernel, antialiased, translation 0 (float32 arithmetic in
    the same order as jax/_src/image/scale.py:compute_weight_mat)."""
    f32 = np.float32
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv_scale
                - f32(0.0) * inv_scale - f32(0.5)).astype(f32)
    x = (np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
         / kernel_scale).astype(f32)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of a (H, W) image, matching
    jax.image.resize(img, (out_h, out_w), "bilinear")."""
    h, w = img.shape
    x = img
    if out_h != h:
        wy = _const(("resize", (h, out_h)), img.device)      # (h, out_h)
        x = wy.T @ x
    if out_w != w:
        wx = _const(("resize", (w, out_w)), img.device)      # (w, out_w)
        x = x @ wx
    return x


def sobel_gradients(img: torch.Tensor):
    """(gx, gy) via Sobel; replicate edges."""
    smooth = _const(("array", (0.25, 0.5, 0.25)), img.device)
    diff = _const(("array", (-0.5, 0.0, 0.5)), img.device)
    gx = sep_conv2d(img, diff, smooth)
    gy = sep_conv2d(img, smooth, diff)
    return gx, gy


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static per-level (h, w) list."""
    shapes = []
    for l in range(n_levels):
        s = scale ** l
        shapes.append((max(int(round(h / s)), 16), max(int(round(w / s)), 16)))
    return shapes


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """ORB image pyramid: each level resized from the previous one."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(bilinear_resize(levels[-1], *shapes[l]))
    return tuple(levels)


def gather2d(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """img[y, x] with the index rules of a jnp gather: a negative index
    counts from the end, then the index is clamped into range."""
    h, w = img.shape
    y = torch.where(y < 0, y + h, y).clamp(0, h - 1)
    x = torch.where(x < 0, x + w, x).clamp(0, w - 1)
    return img[y, x]


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (H, W) image at continuous uv=(x, y) positions (..., 2)."""
    h, w = img.shape
    x = torch.clamp(uv[..., 0], 0.0, w - 1.001)
    y = torch.clamp(uv[..., 1], 0.0, h - 1.001)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


def nearest_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    x = torch.clamp(torch.round(uv[..., 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(uv[..., 1]).to(torch.int64), 0, h - 1)
    return img[y, x]
