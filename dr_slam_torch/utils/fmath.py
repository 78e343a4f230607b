"""Float arithmetic rounded as the JAX package's compiled CPU code rounds
it, in elementwise PyTorch ops only, so that the CPU and the card give the
same bits.

- `fma32`: a float32 fused multiply-add (LLVM contracts a product into
  the add that consumes it), rounded once.
- `fma64`: a float64 fused multiply-add, rounded once.
- `sqrtf`: a correctly rounded float32 square root.
- `sinf`, `cosf`: XLA's CPU code calls the C library's `sinf` / `cosf`
  for `jnp.sin` / `jnp.cos` on float32. These are glibc's (2.28 and
  later, `sysdeps/ieee754/flt-32/s_sinf.c`), as the x86-64 build with
  FMA runs them: float64 range reduction and polynomials, every
  `a + b * c` of the source one FMA, rounded to float32 at the end. They
  are not correctly rounded (up to 0.56 ulp), so neither `torch.sin`
  nor sin rounded from float64 gives their bits."""

from __future__ import annotations

import math

import numpy as np
import torch

_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for float64

# glibc's __sincosf_table[0] (sign of sine by quadrant, 2/pi * 2^24, pi/2,
# the cosine and sine polynomials); table 1 negates the cosine's
# coefficients and is used in quadrants 2 and 3
_SIGN = (1.0, -1.0, -1.0, 1.0)
_HPI_INV = float.fromhex("0x1.45f306dc9c883p+23")
_HPI = float.fromhex("0x1.921fb54442d18p+0")
_C = tuple(float.fromhex(h) for h in (
    "0x1p+0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_S = tuple(float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
# 4/pi to 192 bits (__inv_pio4), read 3 words at a time from (xi >> 26) & 15
_INV_PIO4 = (
    0xa2, 0xa2f9, 0xa2f983, 0xa2f9836e, 0xf9836e4e, 0x836e4e44, 0x6e4e4415,
    0x4e441529, 0x441529fc, 0x1529fc27, 0x29fc2757, 0xfc2757d1, 0x2757d1f5,
    0x57d1f534, 0xd1f534dd, 0xf534ddc0, 0x34ddc0db, 0xddc0db62, 0xc0db6295,
    0xdb629599, 0x6295993c, 0x95993c43, 0x993c4390, 0x3c439041)
_PI63 = float.fromhex("0x1.921fb54442d18p-62")  # 2 pi * 2^-64
_M32 = 0xFFFFFFFF


def _round_odd(s: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """s + e rounded to odd, for s = RN(s + e) and e its exact error: s
    if exact or odd, else s's neighbour toward e."""
    even = (s.view(torch.int64) & 1) == 0
    return torch.where((e != 0) & even, torch.nextafter(s, e * math.inf), s)


def _two_sum(a: torch.Tensor, b: torch.Tensor) -> tuple:
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def fma32(a64: torch.Tensor, w64, c) -> torch.Tensor:
    """float32 fused multiply-add: a64 * w64 + c rounded once to float32
    (a64, w64 float64 tensors or Python floats holding float32 values, c
    float32).

    The float32 product is exact in float64; the float64 sum s has an exact
    error e (TwoSum). Rounding s to float32 rounds a * w + c unless s is a
    float32 tie and e != 0; no odd float64 is a float32 tie, so an even s
    steps one float64 ulp toward a * w + c first."""
    p = a64 * w64
    s, e = _two_sum(p, c.double() if torch.is_tensor(c) else c)
    return _round_odd(s, e).float()


def _f64(x):
    """A float32 tensor or a Python number (taken as float32, as XLA takes
    JAX's weakly typed constants) as float64."""
    return x.double() if torch.is_tensor(x) else float(np.float32(x))


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """`fma32` of float32 values: a * b + c rounded once to float32."""
    return fma32(a.double(), _f64(b), _f64(c))


def sqrtf(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root of x >= 0 (XLA's `vsqrtps`;
    `torch.sqrt` on the CPU is not correctly rounded in float32 or
    float64). The float64 root rounded to float32 is off by at most an ulp;
    its two rounding boundaries are 25-bit numbers whose squares float64
    holds exactly, so comparing x with them settles it (no float32 lies on
    a boundary's square)."""
    s = torch.sqrt(x.double()).float()
    up = torch.nextafter(s, torch.full_like(s, math.inf))
    down = torch.nextafter(s, torch.zeros_like(s))
    x64, s64 = x.double(), s.double()
    hi = (s64 + up.double()) * 0.5
    lo = (s64 + down.double()) * 0.5
    return torch.where(x64 > hi * hi, up, torch.where(x64 < lo * lo, down, s))


def _split(a):
    t = _SPLIT * a
    hi = t - (t - a)
    return hi, a - hi


def fma64(a: torch.Tensor, b, c) -> torch.Tensor:
    """float64 fused multiply-add: a * b + c rounded once (a, c float64
    tensors, b a tensor or a Python float; no overflow).

    a * b is ph + pl exactly (Dekker's product); ph + c is s + e1 exactly
    and e1 + pl is t + e2 (TwoSum). Where e1 != 0 there was no cancellation,
    so |e1 + pl| is at most about 2 ulp(s) and t's ulp lies 50 binades
    below s's: rounding t to odd keeps it off every rounding boundary of
    s + t, whose one rounding is then a * b + c's. Where e1 = 0, s + pl is
    a * b + c exactly."""
    ph = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    pl = ((ah * bh - ph) + ah * bl + al * bh) + al * bl
    s, e1 = _two_sum(ph, c)
    t, e2 = _two_sum(e1, pl)
    return s + _round_odd(t, e2)


def _madd(a, b, c):
    """a * b + c with two roundings (`fma64`'s cheap stand-in)."""
    return a * b + c


def _poly(xr: torch.Tensor, odd: torch.Tensor, sgn: torch.Tensor,
          neg: torch.Tensor, madd) -> torch.Tensor:
    """glibc's sinf_poly on the reduced argument xr: the sine polynomial
    of xr * sgn in even quadrants, the cosine's (negated where `neg`,
    table 1) in odd ones, each `a + b * c` of the source one `madd`."""
    x2 = xr * xr
    x1 = xr * sgn
    s1 = madd(x2, _S[2], torch.full_like(x2, _S[1]))
    x3 = x2 * x1
    x7 = x2 * x3
    sin = madd(s1, x7, madd(x3, _S[0], x1))
    c = [(1.0 - 2.0 * neg.double()) * k for k in _C]
    x4 = x2 * x2
    c1 = madd(x2, c[1], c[0])
    c2 = madd(x2, c[4], c[3])
    x6 = x2 * x4
    cos = madd(c2, x6, madd(x4, c[2], c1))
    return torch.where(odd, cos, sin)


def _reduce_large(bits: torch.Tensor) -> tuple:
    """glibc's reduce_large for |y| >= 120 (bits: the float's 32-bit
    pattern in int64): (x, the reduced argument scaled to radians, in
    [-pi/4, pi/4]; n, the quadrant). The 64-bit integer arithmetic runs on
    32-bit halves held in int64."""
    table = torch.tensor(_INV_PIO4, dtype=torch.int64, device=bits.device)
    k = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    m = ((bits & 0x7FFFFF) | 0x800000) << shift               # < 2^31
    res0 = (m * table[k]) & _M32                              # 32-bit
    res1 = m * table[k + 4]                                   # < 2^63
    res2 = m * table[k + 8]
    lo = (res2 >> 32) + (res1 & _M32)
    hi = (res0 + (res1 >> 32) + (lo >> 32)) & _M32
    lo = lo & _M32
    n = ((hi + (1 << 29)) & _M32) >> 30
    hi = (hi - (n << 30)) & _M32
    hi = torch.where(hi >= 1 << 31, hi - (1 << 32), hi)       # signed
    x = hi.double() * 4294967296.0 + lo.double()
    return x * _PI63, n


def _sincosf(y: torch.Tensor, cos: bool) -> torch.Tensor:
    """glibc's sinf (cos False) or cosf of a float32 tensor.

    The argument reduction and the polynomial run first with two roundings
    per `a + b * c`, which moves the float64 result less than 2^-45 from
    glibc's; where a float32 rounding boundary lies within 2^-43 of it,
    they run again with `fma64`."""
    shape = y.shape
    y = y.reshape(-1)
    bits = y.view(torch.int32).to(torch.int64) & _M32
    top = (bits >> 20) & 0x7FF
    x = y.double()
    # |y| < 120: n = round(y * 2/pi) by the 2^24-scaled truncation, then
    # x - n pi/2 in one FMA; below 0.75 this is n = 0 and x, the small path
    n = ((x * _HPI_INV).trunc().to(torch.int64) + 0x800000) >> 24
    quad = n
    large = top >= 0x42F
    any_large = bool(large.any())
    if any_large:
        xl, nl = _reduce_large(bits)
        n = torch.where(large, nl, n)
        quad = torch.where(large, nl + (bits >> 31), n)
    odd = ((n & 1) == 1) ^ cos
    neg = (quad & 2) == 2
    sgn = torch.tensor(_SIGN, dtype=torch.float64, device=y.device)[quad & 3]

    def evaluate(i, madd):
        xr = madd(-n[i].double(), _HPI, x[i])
        if any_large:
            xr = torch.where(large[i], xl[i], xr)
        return _poly(xr, odd[i], sgn[i], neg[i], madd)

    r = evaluate(slice(None), _madd)
    unsure = ((r - 2.0 ** -43).float() != (r + 2.0 ** -43).float()).nonzero()
    r = r.float()
    if len(unsure):
        i = unsure[:, 0]
        r[i] = evaluate(i, fma64).float()
    tiny = top < 0x398
    r = torch.where(tiny, torch.ones_like(y) if cos else y, r)
    return torch.where(top > 0x7F7, y - y, r).reshape(shape)


def sinf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 sinf, bit for bit."""
    return _sincosf(y, False)


def cosf(y: torch.Tensor) -> torch.Tensor:
    """glibc's float32 cosf, bit for bit."""
    return _sincosf(y, True)
