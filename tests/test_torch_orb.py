"""Parity of the port's image front-end (dr_slam_torch/ops/image.py, fast.py,
orb.py, hamming.py, select.py) with the JAX package, on a rendered
corridor frame at 320x240 and on numpy inputs made from a seed.

Integer outputs (FAST non-maximum suppression, cell winners, keypoint
validity, octaves, descriptor bits, Hamming distances) must match exactly.
Float tolerances, with their reasons:
- filters and samplers: 1e-4 on [0, 255] images, float32 sums of at most
  seven taps taken in another order;
- the antialiased pyramid: 1e-4. The port computes the weights XLA
  compiles (fused multiply-adds where LLVM vectorizes, a multiply by the
  reciprocal, column sums in 32-row windows) and sums each output in the
  order of XLA's dots, so the 640x480 pyramid is bit-equal; below about
  25,000 output pixels Eigen may shard a dot by its inner dimension, and
  where opt_einsum resizes the columns first (the 60x80 upsample) XLA runs
  other dots: observed 3.1e-5 there. Keypoints are compared exactly given
  the same level image, and on a whole frame where no response is
  near-tied;
- keypoint angles: 1e-4 rad (31x31 moment sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.ops import fast as jfast
from dr_slam_tpu.ops import hamming as jham
from dr_slam_tpu.ops import image as jimg
from dr_slam_tpu.ops import orb as jorb
from dr_slam_torch.ops import fast as tfast
from dr_slam_torch.ops import hamming as tham
from dr_slam_torch.ops import image as timg
from dr_slam_torch.ops import orb as torb
from dr_slam_torch.ops.select import top_k

torch.set_num_threads(2)

K4 = (267.7, 269.6, 160.0, 120.0)


@pytest.fixture(scope="module")
def frame():
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(4, step=0.03), K4=K4, height=240,
        width=320)
    gray, depth = seq.render(2)
    return np.array(gray, np.float32), np.array(depth, np.float32)


def close(port, ref, atol):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=0)


def same(port, ref, err_msg=""):
    a = port.numpy()
    b = np.asarray(ref)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    np.testing.assert_array_equal(a, b, err_msg=err_msg)


# --- image ops ------------------------------------------------------------------

def test_filters_match_jax(frame):
    gray, _ = frame
    g_t, g_j = torch.from_numpy(gray), jnp.asarray(gray)
    close(timg.gaussian_blur(g_t), jimg.gaussian_blur(g_j), 1e-4)
    close(timg.box_filter(g_t, 2), jimg.box_filter(g_j, 2), 1e-4)
    for a, b in zip(timg.sobel_gradients(g_t), jimg.sobel_gradients(g_j)):
        close(a, b, 1e-4)
    kx = np.array([0.1, 0.2, 0.4, 0.2, 0.1], np.float32)
    ky = np.array([0.25, 0.5, 0.25], np.float32)
    close(timg.sep_conv2d(g_t, kx, ky), jimg.sep_conv2d(g_j, kx, ky), 1e-4)


def test_samplers_match_jax(frame):
    gray, _ = frame
    rng = np.random.RandomState(0)
    uv = np.stack([rng.uniform(-5, 330, 400), rng.uniform(-5, 250, 400)],
                  -1).astype(np.float32)
    g_t, g_j = torch.from_numpy(gray), jnp.asarray(gray)
    close(timg.bilinear_sample(g_t, torch.from_numpy(uv)),
          jimg.bilinear_sample(g_j, jnp.asarray(uv)), 1e-3)
    same(timg.nearest_sample(g_t, torch.from_numpy(uv)),
         jimg.nearest_sample(g_j, jnp.asarray(uv)))


@pytest.mark.parametrize("hw", [(240, 320), (480, 640)])
def test_pyramid_matches_jax(hw):
    """Antialiased resize (a plain bilinear interpolation would be off by
    tens of grey levels on this texture)."""
    h, w = hw
    rng = np.random.RandomState(h)
    img = rng.randint(0, 256, (h, w)).astype(np.float32)
    assert timg.pyramid_shapes(h, w, 8, 1.2) == jimg.pyramid_shapes(h, w, 8, 1.2)
    pt = timg.build_pyramid(torch.from_numpy(img), 8, 1.2)
    pj = jimg.build_pyramid(jnp.asarray(img), 8, 1.2)
    assert len(pt) == len(pj)
    for a, b in zip(pt, pj):
        assert tuple(a.shape) == b.shape
        close(a, b, 1e-4)
    up = timg.bilinear_resize(torch.from_numpy(img[:60, :80]), 75, 100)
    close(up, jimg.bilinear_resize(jnp.asarray(img[:60, :80]), 75, 100), 1e-4)


# --- FAST, cell winners, top-k ----------------------------------------------------

def test_fast_and_nms_match_jax(frame):
    gray, _ = frame
    s_t = tfast.fast_score(torch.from_numpy(gray))
    s_j = jfast.fast_score(jnp.asarray(gray))
    same(s_t, s_j)
    same(tfast.nms3x3(s_t), jfast.nms3x3(s_j))
    cs_t = torb._cell_winners(tfast.nms3x3(s_t), 16)
    cs_j = jorb._cell_winners(jfast.nms3x3(s_j), 16)
    for a, b in zip(cs_t, cs_j):
        same(a, b)


def test_top_k_breaks_ties_like_lax_top_k():
    import jax
    rng = np.random.RandomState(1)
    x = rng.randint(0, 6, (3, 200)).astype(np.float32)
    x[0, 50:] = -np.inf
    vt, it = top_k(torch.from_numpy(x), 40)
    vj, ij = jax.lax.top_k(jnp.asarray(x), 40)
    same(vt, vj)
    same(it, ij)


# --- ORB --------------------------------------------------------------------------

def test_brief_pattern_and_counts_match_jax():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    assert (torb.level_feature_counts(1000, 8, 1.2)
            == jorb.level_feature_counts(1000, 8, 1.2))
    for a, b in zip(torb._moment_kernels(), jorb._moment_kernels()):
        np.testing.assert_array_equal(a, b)


def test_orientation_matches_jax(frame):
    gray, _ = frame
    rng = np.random.RandomState(2)
    vi = rng.randint(0, 240, 300).astype(np.int32)
    ui = rng.randint(0, 320, 300).astype(np.int32)
    g_t, g_j = torch.from_numpy(gray), jnp.asarray(gray)
    ang_t = torb.orientation_at_points(g_t, torch.from_numpy(vi).long(),
                                       torch.from_numpy(ui).long())
    ang_j = jorb.orientation_at_points(g_j, jnp.asarray(vi), jnp.asarray(ui))
    close(ang_t, ang_j, 1e-4)
    for a, b in zip(torb.orientation_maps(g_t), jorb.orientation_maps(g_j)):
        # dense 31x31 moment sums reach 1e6; float32 sums in another order
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1.0)


@pytest.mark.parametrize("level", [0, 2])
def test_extract_level_matches_jax(frame, level):
    """Given the same level image, the selected keypoints, their validity
    and their descriptor bits match exactly."""
    gray, _ = frame
    img = np.array(jimg.build_pyramid(jnp.asarray(gray), 4, 1.2)[level])
    blur = np.array(jimg.gaussian_blur(jnp.asarray(img)))
    uv_t, s_t, a_t, v_t, b_t = torb._extract_level(
        torch.from_numpy(img), torch.from_numpy(blur), 200, 7.0, 16, 16)
    uv_j, s_j, a_j, v_j, b_j = jorb._extract_level(
        jnp.asarray(img), jnp.asarray(blur), 200, 7.0, 16, 16)
    assert int(v_t.sum()) > 50
    same(v_t, v_j, "valid")
    same(s_t, s_j, "score")
    close(uv_t, uv_j, 1e-4)
    close(a_t, a_j, 1e-4)
    same(b_t, b_j, "bits")


def test_extract_orb_matches_jax(frame):
    gray, _ = frame
    kw = dict(n_features=400, n_levels=4, scale=1.2, max_keypoints=512)
    kt = torb.extract_orb(torch.from_numpy(gray), **kw)
    kj = jorb.extract_orb(jnp.asarray(gray), **kw)
    assert int(kt.valid.sum()) > 200
    for f in ("valid", "octave", "desc"):
        same(getattr(kt, f), getattr(kj, f), f)
    close(kt.uv, kj.uv, 1e-3)
    close(kt.response, kj.response, 1e-3)
    close(kt.angle, kj.angle, 1e-4)
    close(kt.sigma2, kj.sigma2, 1e-5)


def test_pack_unpack_bits_match_jax():
    rng = np.random.RandomState(3)
    bits = rng.rand(50, 256) < 0.5
    packed_j = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    packed_t = torb.pack_bits(torch.from_numpy(bits))
    same(packed_t, packed_j)
    same(torb.unpack_bits(packed_t), jorb.unpack_bits(jnp.asarray(packed_j)))
    np.testing.assert_array_equal(
        torb.bits_to_signs(torch.from_numpy(bits)).numpy(),
        np.asarray(jorb.bits_to_signs(jnp.asarray(bits), jnp.float32)))


# --- Hamming ------------------------------------------------------------------------

def test_hamming_matches_jax():
    rng = np.random.RandomState(4)
    a = rng.randint(0, 2 ** 32, (70, 8), dtype=np.uint32)
    b = rng.randint(0, 2 ** 32, (90, 8), dtype=np.uint32)
    b[:10] = a[:10]
    ta, tb = torch.from_numpy(a.view(np.int32)), torch.from_numpy(b.view(np.int32))
    gold = np.asarray(jham.hamming_popcount(jnp.asarray(a), jnp.asarray(b)))
    same(tham.hamming_popcount(ta, tb), gold)
    same(tham.hamming_matrix(ta, tb), np.asarray(
        jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)), np.float32))
    np.testing.assert_array_equal(tham.hamming_matrix(ta, tb).numpy(), gold)
    same(tham.popcount_u32(ta), jham.popcount_u32(jnp.asarray(a)))
