"""Core image ops: separable convolution, Gaussian blur, antialiased
bilinear resize, image pyramid, gradients, point sampling.

Counterpart of the JAX package's `ops/image.py`. The resize reproduces
`jax.image.resize(..., "bilinear")`, which widens its triangle filter by the
scale factor on downscale (antialiasing); `F.interpolate` does not. The
per-axis weight matrices are the ones XLA compiles
`jax.image.scale_and_translate` into on the CPU, and each output sums its few
non-zero terms in the order of XLA's CPU dots, so the pyramid is the JAX
package's bit for bit, on the CPU and on the card."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from dr_slam_torch.utils.fmath import fma32


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


def _fma32(a, b, c) -> np.ndarray:
    """float32 fused multiply-add on numpy values: a * b + c rounded once
    to float32 (`fmath.fma32`)."""
    def t(x, dtype):
        return torch.from_numpy(np.asarray(x, dtype))

    return fma32(t(a, np.float64), t(b, np.float64),
                 t(c, np.float32)).numpy()


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of jax.image.resize(..., "bilinear")
    along one axis, bit-equal to what XLA compiles
    jax/_src/image/scale.py:compute_weight_mat into on an x86-64 CPU with
    AVX-512 (every (n_in, n_out) of the 640x480 and 320x240 pyramids and
    of YOLOX's 128, 256 and 640 inputs is checked in
    tests/test_torch_resize.py).

    The optimized HLO computes the matrix twice, in two loop fusions over
    (n_in, n_out), n_out the inner loop:
    - a `broadcast_maximum_fusion` whose output a reduce-window sums;
    - a `select_select_fusion` that recomputes it, divides by that sum and
      applies both `where`s.
    Both run, per element: add(iota, 0.5) -> multiply(inv_scale) ->
    add(-0.5) (the sample position); subtract(iota_in) -> abs ->
    multiply(1 / kernel_scale) (the algebraic simplifier's rewrite of the
    division) -> subtract from 1 -> maximum(0) (the triangle). LLVM then
    rounds the two fusions differently column by column:
    - in a vectorized loop body the sample position is one fused
      multiply-add (`vfmsub213ps`) and the triangle two roundings;
    - in the remainder, unrolled with constant trip count, LLVM folds the
      sample position as two roundings and fuses the triangle
      (`vfnmadd213ps`, 1 - |d| * recip).
    The vector loop of the sum's fusion takes 32 columns an iteration (8
    lanes, interleave 4), the select fusion's 8; its body covers the first
    32 * (n_out // 32), resp. 8 * (n_out // 8) columns, unless that is 10
    iterations or fewer, which LLVM unrolls whole: then every column is
    remainder.

    The sum: XLA's tree reduction rewriter splits the n_in reduction into a
    reduce-window of 32 rows (padded by ((-n_in) % 32) // 2 rows at the
    front) and a reduce of the window sums; each adds in order from 0.

    inv_scale is float32(1 / (n_out / n_in)) (the scale is a Python float)
    and the reciprocal float32(1) / inv_scale."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    recip = f32(1.0) / max(inv_scale, f32(1.0))
    centre = np.arange(n_out, dtype=f32) + f32(0.5)
    rows = np.arange(n_in, dtype=f32)[:, None]

    def fusion(body_end: int) -> tuple:
        body = np.arange(n_out) < body_end
        sample = np.where(body, _fma32(centre, inv_scale, f32(-0.5)),
                          (centre * inv_scale).astype(f32) - f32(0.5))
        d = np.abs(sample[None, :] - rows)
        tri = np.where(body[None, :], f32(1.0) - d * recip,
                       _fma32(-d, recip, f32(1.0)))
        return sample, np.maximum(tri, f32(0.0))

    def body_end(width: int) -> int:
        return width * (n_out // width) if n_out // width > 10 else 0

    _, w_sum = fusion(body_end(32))
    pad_front = ((-n_in) % 32) // 2
    total = np.zeros(n_out, f32)
    for start in range(-pad_front, n_in, 32):
        window = np.zeros(n_out, f32)
        for k in range(max(start, 0), min(start + 32, n_in)):
            window = window + w_sum[k]
        total = total + window
    sample, w = fusion(body_end(8))
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(f32).eps)),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= f32(-0.5)) & (sample <= f32(n_in - 0.5))
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def _contraction(n_in: int, n_out: int, lhs: bool) -> tuple:
    """The summation order XLA's CPU dot gives each output of a resize
    stage: (lanes, block starts). `lhs`: the weights are the dot's
    transposed left operand (the row stage, `dot(w, x)` contracting dim 0
    of both); else its right operand (the column stage, `dot(t, w)`).

    Each block of the contraction dimension is summed on its own and the
    block sums added in order. Inside a block, term k goes to lane
    (k - block start) % lanes; each lane is a chain of fused multiply-adds
    in k order from 0; the lanes are added pairwise, neighbours first.
    - Row stage (Eigen's contraction on two or more threads): one lane;
      blocks of ceil(n_in / ceil(n_in / 320)) rounded up to 8 once n_in >
      320. Not reproduced: for outputs under about 25,000 pixels Eigen's
      cost model may shard the contraction into blocks of 96 (the 240x320
      8-level pyramid's level 4 then differs by an ulp in places).
    - Column stage (YNNPACK's fp32 dot; checked for more than 48 output
      rows): the kernel is the widest of 64 columns x 1 lane, 32 x 2 and
      16 x 4 that pads n_out least; blocks of 512 x lanes."""
    if lhs:
        if n_in <= 320:
            return 1, (0,)
        nblocks = -(-n_in // 320)
        kc = -(-(-(-n_in // nblocks)) // 8) * 8
        return 1, tuple(range(0, n_in, kc))
    lanes = min(((64, 1), (32, 2), (16, 4)),
                key=lambda t: (-(-n_out // t[0]) * t[0], -t[0]))[1]
    return lanes, tuple(range(0, n_in, 512 * lanes))


def _tap_plan(n_in: int, n_out: int, lhs: bool) -> list:
    """The non-zero weights of `_resize_weights(n_in, n_out)` scheduled in
    `_contraction`'s order: blocks, each a list of lanes, each a list of
    steps (index (n_out,) int64, weight (n_out,) float32); a step pads the
    outputs with fewer terms with index 0, weight 0."""
    w = _resize_weights(n_in, n_out)
    lanes, starts = _contraction(n_in, n_out, lhs)
    ends = starts[1:] + (n_in,)
    plan = []
    for b0, b1 in zip(starts, ends):
        block = []
        for lane in range(lanes):
            ks = np.arange(b0 + lane, b1, lanes)
            nz = w[ks] != 0                                     # (len, n_out)
            steps = int(nz.sum(0).max()) if len(ks) else 0
            order = np.argsort(~nz, axis=0, kind="stable")[:steps]
            idx = np.where(np.take_along_axis(nz, order, 0), ks[order], 0)
            wt = np.take_along_axis(w[ks], order, 0)
            block.append([(idx[s], wt[s]) for s in range(steps)])
        plan.append(block)
    return plan


@functools.lru_cache(maxsize=128)
def _taps(n_in: int, n_out: int, lhs: bool, device: torch.device) -> tuple:
    """`_tap_plan` on the device, made once per device: the steps as
    (index, float32 weight, float64 weight)."""
    return tuple(tuple(tuple(
        (torch.from_numpy(i).to(device), torch.from_numpy(w).to(device),
         torch.from_numpy(w.astype(np.float64)).to(device))
        for i, w in lane) for lane in block)
        for block in _tap_plan(n_in, n_out, lhs))


def _resize_axis(x: torch.Tensor, n_out: int, dim: int) -> torch.Tensor:
    """One stage of the resize: x's `dim` (0: rows, the JAX dot's transposed
    left operand; 1: columns, its right operand) resized to n_out, every
    output summed from its non-zero terms in XLA's order (`_contraction`).
    Elementwise float32 and float64 arithmetic only, so the CPU and the card
    give the same bits."""
    plan = _taps(x.shape[dim], n_out, dim == 0, x.device)
    shape = (-1, 1) if dim == 0 else (1, -1)
    x64 = x.double()
    out = None
    for block in plan:
        sums = []
        for lane in block:
            acc = torch.zeros((), dtype=x.dtype, device=x.device)
            for s, (idx, w32, w64) in enumerate(lane):
                if s == 0:
                    acc = x.index_select(dim, idx) * w32.view(shape)
                else:
                    acc = fma32(x64.index_select(dim, idx),
                                w64.view(shape), acc)
            sums.append(acc)
        while len(sums) > 1:
            sums = [sums[i] + sums[i + 1] for i in range(0, len(sums), 2)]
        out = sums[0] if out is None else out + sums[0]
    return out


def bilinear_resize(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize of a (H, W) float32 image, bit-equal to
    the JAX package's jitted jax.image.resize(img, (out_h, out_w),
    "bilinear") on the CPU: XLA's weights (`_resize_weights`), rows first,
    then columns, each output summed in XLA's order (`_resize_axis`). Where
    opt_einsum finds the columns first cheaper (YOLOX's square 128 and 256
    inputs from 640x480; never a pyramid level of a landscape image), XLA
    runs other dots and the port lies an ulp or two off."""
    h, w = img.shape
    x = img
    if out_h != h:
        x = _resize_axis(x, out_h, 0)
    if out_w != w:
        x = _resize_axis(x, out_w, 1)
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
