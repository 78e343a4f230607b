"""The port's copy of JAX's default PRNG: threefry-2x32 with the
partitionable layout (`jax_threefry_partitionable`, the default since
jax 0.5), so the port draws the same numbers as the JAX package from the
same key.

A key is the pair (k0, k1) of 32-bit words; `jax.random.PRNGKey(i)` is
(0, i). Element j of a draw of 32-bit words is the hash of the counter
pair (j >> 32, j & 0xffffffff), its two output words XORed. Everything
runs in int64 masked to 32 bits: `>>` on `torch.uint32` is not
implemented on the CPU."""

from __future__ import annotations

import math

import numpy as np
import torch

from dr_slam_torch.utils.fmath import fma, sqrtf

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def PRNGKey(seed: int) -> tuple:
    """jax.random.PRNGKey(seed) for a seed in [0, 2^32)."""
    return (0, int(seed) & _M32)


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under the key
    (k0, k1). Works on Python ints and on int64 tensors holding 32-bit
    values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def fold_in(key: tuple, data: int) -> tuple:
    """jax.random.fold_in for a threefry key: the hash of (0, data)."""
    return threefry2x32(key[0], key[1], 0, data & _M32)


def random_bits(key: tuple, shape: tuple, device=None) -> torch.Tensor:
    """jax.random.bits(key, shape) (uint32) as int64 tensor of 32-bit
    values."""
    n = int(np.prod(shape))
    i = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(key[0], key[1], i >> 32, i & _M32)
    return (b0 ^ b1).reshape(shape)


def uniform(key: tuple, shape: tuple, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """jax.random.uniform(key, shape, float32, minval, maxval): the top 23
    bits as the mantissa of a float in [1, 2), minus 1, scaled and shifted
    in float32, then clamped below at minval."""
    mant = ((random_bits(key, shape, device) >> 9) | 0x3F800000).to(torch.int32)
    u = mant.view(torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32, device=device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=device)
    return torch.maximum(lo, u * (hi - lo) + lo)


_ERFINV_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# XLA's float32 erf_inv (Giles' polynomials, w < 5 and w >= 5), its log1p
# (Cephes' rational function below sqrt(2) - 1) and its CPU log (Cephes'
# polynomial, as Eigen's plog evaluates it)
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_LOG1P_NUM = (4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
              6.5787325942061044846969e0, 2.9911919328553073277375e1,
              6.0949667980987787057556e1, 5.7112963590585538103336e1,
              2.0039553499201281259648e1)
_LOG1P_DEN = (1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
              2.2176239823732856465394e2, 3.0909872225312059774938e2,
              2.1642788614495947685003e2, 6.0118660497603843919306e1)
_LOG_P = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
          -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
          2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def _horner(x: torch.Tensor, coefs) -> torch.Tensor:
    """Highest degree first, one fused multiply-add per step."""
    r = torch.zeros_like(x)
    for c in coefs:
        r = fma(r, x, c)
    return r


def _log(v: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log on the CPU, for normal v > 0: the mantissa m in
    [0.5, 1) and exponent e, m moved to [sqrt(1/2), sqrt(2)) - 1, then the
    Cephes polynomial and e * ln 2 in two parts, each product that feeds
    one add an FMA as LLVM contracts it."""
    bits = v.view(torch.int32)
    e = ((bits >> 23) & 0xFF).float() - 126.0
    x = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)
    low = x < 0.707106781186547524
    e = e - low.float()
    x = (x - 1.0) + torch.where(low, x, torch.zeros_like(x))
    x2 = x * x
    x3 = x2 * x
    y = fma(x, _LOG_P[0], _LOG_P[1])
    y1 = fma(x, _LOG_P[3], _LOG_P[4])
    y2 = fma(x, _LOG_P[6], _LOG_P[7])
    y = fma(y, x, _LOG_P[2])
    y1 = fma(y1, x, _LOG_P[5])
    y2 = fma(y2, x, _LOG_P[8])
    y = fma(fma(fma(y, x3, y1), x3, y2), x3, e * -2.12194440e-4)
    return fma(e, 0.693359375, (x - x2 * 0.5) + y)


def _log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 log1p: a rational function for |x| < sqrt(2) - 1,
    log(1 + x) above."""
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + fma(x2, -0.5, small)
    return torch.where(torch.abs(x) < 0.41421356237309504880, small,
                       _log(x + 1.0))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv for |x| < 1 (PyTorch's own erfinv is more
    exact and so differs from JAX's by up to 89 ulp)."""
    w = -_log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrtf(w) - 3.0)
    p = torch.zeros_like(x)
    for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
        p = fma(p, w, torch.where(lt, torch.full_like(x, a),
                                  torch.full_like(x, b)))
    return p * x


def normal(key: tuple, shape: tuple, device=None) -> torch.Tensor:
    """jax.random.normal(key, shape) in float32, bit for bit: a uniform on
    [nextafter(-1, 0), 1), then sqrt(2) * erf_inv(u)."""
    u = uniform(key, shape, _ERFINV_LO, 1.0, device)
    return erfinv(u) * np.float32(math.sqrt(2.0))
