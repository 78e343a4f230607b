"""The port's antialiased resize against the JAX package's compiled one, on
the CPU: `_resize_weights` bit-equal to XLA's weight matrices, the exact
float32 fused multiply-add it and the resize are built on, and the image
pyramids level by level against `jax.jit(build_pyramid)`."""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_torch import config as tconfig
from dr_slam_torch._smoke import FIXTURE
from dr_slam_torch.ops import image as timage
from dr_slam_torch.utils import fmath
from dr_slam_tpu.ops import image as jimage

PRESETS = ("tum_freiburg1", "tum_freiburg2", "tum_freiburg3", "icl_nuim",
           "tamu", "realsense", "tartanair")


def _pyramid_pairs(h, w, n_levels, scale):
    shapes = timage.pyramid_shapes(h, w, n_levels, scale)
    pairs = []
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        pairs += [(h0, h1), (w0, w1)]
    return pairs


def _pairs():
    """Every (n_in, n_out) of the presets' pyramids, of the 320x240
    4-level pyramid of tests/test_tracking_e2e.py and of YOLOX's inputs
    (480x640 to 128, 256 and 640)."""
    pyramids = set()
    for name in PRESETS:
        cfg = getattr(tconfig, name)()
        pyramids.add((cfg.camera.height, cfg.camera.width, cfg.orb.n_levels,
                      cfg.orb.scale_factor))
    pyramids.add((240, 320, 4, 1.2))
    pairs = set()
    for p in sorted(pyramids):
        pairs.update(_pyramid_pairs(*p))
    for s in (128, 256, 640):
        pairs.update({(480, s), (640, s)})
    return sorted(pairs - {(640, 640)})


def _xla_weights(n_in, n_out):
    """XLA's weight matrix, read out by resizing an identity matrix along
    one axis: every product is by 0 or 1, so nothing rounds."""
    eye = jnp.eye(n_in, dtype=jnp.float32)
    out = jax.jit(lambda x: jax.image.resize(x, (n_out, n_in), "bilinear"))(eye)
    return np.asarray(out).T


@pytest.mark.parametrize("n_in,n_out", _pairs())
def test_weights_bit_equal_to_xla(n_in, n_out):
    """Before, the port divided by kernel_scale and ignored LLVM's fused
    multiply-adds and XLA's window sums: 98-731 entries differed per pair of
    the 640x480 pyramid."""
    np.testing.assert_array_equal(timage._resize_weights(n_in, n_out),
                                  _xla_weights(n_in, n_out))


def _round_f32(x: Fraction) -> np.float32:
    """x rounded once to float32, ties to even."""
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x),
                                     int(np.float32(c).view(np.int32)) & 1))


def _fma_cases():
    """Random operands, and ones whose exact result lies a hair off a
    float32 tie, where rounding the float64 sum to float32 goes wrong: a * b
    is a tie (3 * (2**23 + 1) is odd and needs 25 bits) and c is below half
    a float64 ulp of it."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-300, 300, 400).astype(np.float32)
    b = rng.uniform(-1, 1, 400).astype(np.float32)
    c = rng.uniform(-300, 300, 400).astype(np.float32)
    ties = []
    for ta, tb, k0 in ((3.0, 2.0 ** 23 + 1, 30), (5.0, 2.0 ** 22 + 1, 30),
                       (-3.0, 2.0 ** 23 + 1, 30),
                       (3.0 * 2.0 ** -20, 2.0 ** 23 + 1, 50)):
        for sign in (1.0, -1.0):
            for k in (k0, k0 + 5, k0 + 10):
                ties.append((ta, tb, sign * 2.0 ** -k))
    ta, tb, tc = (np.array(v, np.float32) for v in zip(*ties))
    return (np.concatenate([a, ta]), np.concatenate([b, tb]),
            np.concatenate([c, tc]))


def test_fma32_rounds_once():
    """`_fma32` (numpy) and `fmath.fma32` (torch) round a * b + c once,
    also where the float64 sum is itself rounded onto a float32 tie."""
    a, b, c = _fma_cases()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).sum() > 0      # the cases reach a double rounding
    np.testing.assert_array_equal(timage._fma32(a, b, c), want)
    got = fmath.fma32(torch.from_numpy(a).double(),
                      torch.from_numpy(b).double(), torch.from_numpy(c))
    np.testing.assert_array_equal(got.numpy(), want)


def _levels_gap(gray, n_levels):
    port = timage.build_pyramid(torch.from_numpy(gray), n_levels, 1.2)
    ref = jimage.build_pyramid(jnp.asarray(gray), n_levels=n_levels,
                               scale=1.2)
    gaps, counts = [], []
    for p, r in zip(port, ref):
        p, r = p.numpy(), np.asarray(r)
        assert p.shape == r.shape
        gaps.append(float(np.abs(p - r).max()))
        counts.append(int((p != r).sum()))
    return gaps, counts


def test_pyramid_matches_jax_640x480():
    """Every level of the port's pyramid on smoke fixture frame 12 against
    the JAX package's jitted `build_pyramid`: bit-equal (0 differing pixels
    on each of the 8 levels; before, up to 2.7e-3 apart). The weights alone
    brought every level within 3.05e-5; the rest was the order XLA's dots
    sum in (`_contraction`)."""
    with np.load(FIXTURE) as fx:
        gray = fx["gray"][0].astype(np.float32)
    gaps, counts = _levels_gap(gray, 8)
    assert max(gaps) <= 3.1e-5, gaps
    assert counts == [0] * 8, counts


def test_pyramid_matches_jax_320x240():
    """The 4-level pyramid of a 320x240 frame (tests/test_tracking_e2e.py's
    size): bit-equal too."""
    with np.load(FIXTURE) as fx:
        gray = fx["gray"][1][::2, ::2].astype(np.float32)
    gaps, counts = _levels_gap(gray, 4)
    assert max(gaps) <= 3.1e-5, gaps
    assert counts == [0] * 4, counts


@pytest.mark.parametrize("size,bound", [(640, 0.0), (256, 1e-4),
                                        (128, 1e-4)])
def test_yolox_input_resize(size, bound):
    """YOLOX's (480, 640, 3) input resize, per channel, against JAX's one
    jax.image.resize of the three channels. At 640 only the rows change
    and the result is bit-equal. At 256 and 128 XLA contracts the columns
    first (opt_einsum's cheaper order) with both operands transposed, whose
    dot order the port does not reproduce: observed 4.58e-5 at both on this
    input."""
    from dr_slam_torch.models import yolox

    rgb = np.random.default_rng(3).uniform(0, 255, (480, 640, 3))
    rgb = rgb.astype(np.float32)
    det = yolox.YOLOX.__new__(yolox.YOLOX)
    det.device, det.input_size = torch.device("cpu"), size
    got = det.resize(rgb).permute(1, 2, 0).numpy()
    want = np.asarray(jax.jit(lambda x: jax.image.resize(
        x, (size, size, 3), "bilinear"))(jnp.asarray(rgb)))
    assert float(np.abs(got - want).max()) <= bound
