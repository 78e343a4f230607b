"""The port's copy of JAX's threefry PRNG (dr_slam_torch/utils/prng.py)
against jax.random on the same keys: 32-bit words, uniforms and normals
bit for bit (the port evaluates XLA's erf_inv, log1p and log polynomials
with XLA's fused multiply-adds and a correctly rounded square root), and
the cylinder RANSAC's Gumbel triplets unchanged since the threefry hash
moved out of ops/cylinders.py."""

import jax
import numpy as np
import pytest
import torch

from dr_slam_torch.ops import cylinders as tc
from dr_slam_torch.utils import prng

torch.set_num_threads(2)

KEYS = (0, 1, 7, 123)
SHAPES = ((7,), (120, 160), (480, 640))


@pytest.mark.parametrize("i", KEYS)
def test_bits_uniform_normal(i):
    key = jax.random.PRNGKey(i)
    assert tuple(np.asarray(jax.random.key_data(key))) == prng.PRNGKey(i)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(key, shape))
        got = prng.random_bits(prng.PRNGKey(i), shape).numpy()
        np.testing.assert_array_equal(got.astype(np.uint32), want)
        want = np.asarray(jax.random.uniform(key, shape))
        got = prng.uniform(prng.PRNGKey(i), shape).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
        want = np.asarray(jax.random.normal(key, shape))
        got = prng.normal(prng.PRNGKey(i), shape).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_fold_in():
    for i, d in ((7, 0), (7, 3), (123, 2 ** 31 + 5)):
        want = jax.random.key_data(jax.random.fold_in(jax.random.PRNGKey(i),
                                                      d))
        assert prng.fold_in(prng.PRNGKey(i), d) == tuple(np.asarray(want))


@pytest.mark.parametrize("k", [0, 1, 2])
def test_cylinder_triplets_unchanged(k):
    """The RANSAC's hypotheses: the top 3 of 48 x 300 Gumbel draws under
    fold_in(PRNGKey(7), k), as the JAX package samples them."""
    key = jax.random.fold_in(jax.random.PRNGKey(7), k)
    want = np.asarray(jax.lax.top_k(jax.random.gumbel(key, (48, 300)), 3)[1])
    g = tc.gumbel(tc.fold_in(tc.KEY, k), (48, 300), "cpu")
    got = torch.topk(g, 3, -1).indices.numpy()
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(want, -1))
