"""dr_slam_torch/utils/fmath.py on the CPU: glibc's sinf and cosf, as the
JAX package's jitted `jnp.sin` / `jnp.cos` call them, bit for bit over each
of their three argument reductions; the float32 square root correctly
rounded (numpy's); the float32 and float64 fused multiply-adds rounded once
(against exact rational arithmetic), also where a plain multiply and add
round twice the other way."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_torch.utils import fmath

torch.set_num_threads(2)

# glibc's paths: |y| < 0.75 (no reduction), < 120 (one FMA), above (4/pi
# to 192 bits); the edges of each and tiny arguments
RANGES = {"small": (-0.75, 0.75), "fast": (-120.0, 120.0),
          "large": (-9000.0, 9000.0), "huge": (-3e7, 3e7)}
EDGES = np.array([0.0, -0.0, 1e-30, -1e-30, 2.4e-4, 0.7499999, 0.75,
                  -0.75, 119.99999, 120.0, -120.0, np.pi / 4, np.pi,
                  3e38, -3e38], np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("name", list(RANGES))
def test_sinf_cosf_match_jax(name):
    lo, hi = RANGES[name]
    x = np.random.default_rng(len(name)).uniform(lo, hi, 200_000)
    x = np.concatenate([x.astype(np.float32), EDGES])
    t = torch.from_numpy(x)
    for ours, theirs in ((fmath.sinf, jnp.sin), (fmath.cosf, jnp.cos)):
        want = np.asarray(jax.jit(theirs)(x))
        got = ours(t).numpy()
        bad = _bits(got) != _bits(want)
        assert not bad.any(), (theirs.__name__, x[bad][:5], got[bad][:5],
                               want[bad][:5])
    # and not correctly rounded: sin rounded from float64 differs
    rounded = np.sin(x.astype(np.float64)).astype(np.float32)
    if name != "small":
        assert (_bits(rounded) != _bits(np.asarray(jax.jit(jnp.sin)(x)))
                ).any()


def test_sinf_of_inf_and_nan():
    x = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    assert torch.isnan(fmath.sinf(x)).all()
    assert torch.isnan(fmath.cosf(x)).all()


def test_sqrtf_correctly_rounded():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(0, 100, 300_000),
                        rng.uniform(0, 1e-30, 1000),
                        [0.0, 1.0, 2.0, 4.0, 1e-45, 3.4e38]])
    x = x.astype(np.float32)
    got = fmath.sqrtf(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(np.sqrt(x)))


def _round32(q: Fraction) -> np.float32:
    """q rounded to the nearest float32, ties to even."""
    f = np.float32(float(q))
    cands = (np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf)))
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - q),
                                     int(np.asarray(v).view(np.int32)) & 1))


def test_fma64_rounds_once():
    rng = np.random.default_rng(5)
    a = rng.standard_normal(20_000)
    b = rng.standard_normal(20_000)
    c = -a * b + rng.standard_normal(20_000) * 1e-12    # cancellation
    a = np.concatenate([a, rng.standard_normal(20_000)])
    b = np.concatenate([b, rng.standard_normal(20_000) * 1e-3])
    c = np.concatenate([c, rng.standard_normal(20_000)])
    got = fmath.fma64(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    # float() of a Fraction rounds correctly (Python's int / int division)
    want = np.array([float(Fraction(x) * Fraction(y) + Fraction(z))
                     for x, y, z in zip(a, b, c)])
    assert ((a * b + c) != want).sum() > 0    # a plain madd rounds twice
    np.testing.assert_array_equal(got, want)
    # b a Python float, as the sine's polynomial coefficients are
    got = fmath.fma64(torch.from_numpy(a), float(b[0]),
                      torch.from_numpy(c)).numpy()
    want = np.array([float(Fraction(x) * Fraction(float(b[0])) + Fraction(z))
                     for x, z in zip(a, c)])
    np.testing.assert_array_equal(got, want)


def test_fma_takes_constants_as_float32():
    """`fma(a, b, c)` with Python numbers b, c takes them as float32, as XLA
    takes JAX's weakly typed constants."""
    a = np.random.default_rng(9).uniform(0, 10, 50_000).astype(np.float32)
    got = fmath.fma(torch.from_numpy(a), 12.9898, 0.05).numpy()
    b, c = np.float32(12.9898), np.float32(0.05)
    want = np.array([_round32(Fraction(float(x)) * Fraction(float(b))
                              + Fraction(float(c))) for x in a], np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
