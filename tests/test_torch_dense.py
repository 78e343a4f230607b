"""Parity of the port's dense geometry front-end (dr_slam_torch/ops/eig33.py,
normals.py, planes.py, lines.py) with the JAX package, on a rendered
corridor frame at 320x240 (the small configuration of the tracking tests)
and on numpy inputs made from a seed.

Integer outputs (plane block labels, member-block counts, validity, line
validity, 3D-lift flags and descriptor bits) must match exactly. Float
tolerances, with their reasons:
- eigenvalues of well-conditioned 3x3 matrices: 1e-5 relative (the
  trigonometric closed form, acos and cos in another library);
- normals and plane coefficients: 1e-4 (block moments are sums of 64 to
  thousands of float32 terms taken in another order); 2e-3 for the
  coefficients of a frame whose smallest plane has few member blocks, so
  that its normal is ill-conditioned;
- line geometry: 1e-3 px and 1e-3 m (bilinear samples of the gradient
  magnitude and depth-weighted PCA, same float32 formulas, sums in another
  order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.ops import eig33 as jeig
from dr_slam_tpu.ops import lines as jlines
from dr_slam_tpu.ops import normals as jnormals
from dr_slam_tpu.ops import planes as jplanes
from dr_slam_torch.ops import eig33 as teig
from dr_slam_torch.ops import lines as tlines
from dr_slam_torch.ops import normals as tnormals
from dr_slam_torch.ops import planes as tplanes

torch.set_num_threads(2)

K4 = (267.7, 269.6, 160.0, 120.0)


@pytest.fixture(scope="module")
def corridor():
    return synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(8, step=0.03), K4=K4, height=240,
        width=320)


def render(seq, i):
    gray, depth = seq.render(i)
    return np.array(gray, np.float32), np.array(depth, np.float32)


@pytest.fixture(scope="module")
def frame(corridor):
    return render(corridor, 0)


def close(port, ref, atol, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol)


def same(port, ref, err_msg=""):
    b = np.asarray(ref)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    np.testing.assert_array_equal(port.numpy(), b, err_msg=err_msg)


def test_eig33_matches_jax():
    rng = np.random.RandomState(0)
    pts = rng.normal(size=(200, 50, 3)) * np.array([1.0, 0.3, 0.01])
    mean = pts.mean(1).astype(np.float32)
    cov = np.einsum("bni,bnj->bij", pts - pts.mean(1, keepdims=True),
                    pts - pts.mean(1, keepdims=True)).astype(np.float32) / 50
    ct, cj = torch.from_numpy(cov), jnp.asarray(cov)
    ev_t, ev_j = teig.eigvals_sym3(ct), jeig.eigvals_sym3(cj)
    # the smallest eigenvalue carries float32 rounding of the largest (~1)
    close(ev_t, ev_j, 2e-6, 1e-5)
    close(teig.smallest_eigvec_sym3(ct, ev_t[:, 0]),
          jeig.smallest_eigvec_sym3(cj, ev_j[:, 0]), 1e-4)
    for a, b in zip(teig.plane_from_cov(torch.from_numpy(mean), ct),
                    jeig.plane_from_cov(jnp.asarray(mean), cj)):
        close(a, b, 1e-4)


def test_normals_match_jax(frame):
    _, depth = frame
    d_t, d_j = torch.from_numpy(depth), jnp.asarray(depth)
    close(tnormals.depth_to_cloud(d_t, K4), jnormals.depth_to_cloud(d_j, K4),
          1e-6)
    n_t, ok_t = tnormals.surface_normals(d_t, K4)
    n_j, ok_j = jnormals.surface_normals(d_j, K4)
    same(ok_t, ok_j)
    assert int(ok_t.sum()) > 100
    close(n_t, n_j, 1e-4)


@pytest.mark.parametrize("index,holes,coeff_tol", [(0, False, 1e-4),
                                                   (0, True, 1e-4),
                                                   (5, False, 2e-3)])
def test_segment_planes_matches_jax(corridor, index, holes, coeff_tol):
    """Block labels, member counts and validity exactly; coefficients and
    sample clouds within tolerance. With holes, a block of depth is 0."""
    _, depth = render(corridor, index)
    if holes:
        depth[60:140, 100:220] = 0.0
    st = tplanes.segment_planes(torch.from_numpy(depth), K4)
    sj = jplanes.segment_planes(jnp.asarray(depth), K4)
    assert int(st.valid.sum()) >= 3
    for f in ("valid", "n_blocks", "block_label", "cloud_valid"):
        same(getattr(st, f), getattr(sj, f), f)
    close(st.coeffs, sj.coeffs, coeff_tol)
    for f in ("cloud", "mse"):
        close(getattr(st, f), getattr(sj, f), 1e-4)
    close(tplanes.max_point_distance_from_plane(st.coeffs, st.cloud,
                                                st.cloud_valid),
          jplanes.max_point_distance_from_plane(sj.coeffs, sj.cloud,
                                                sj.cloud_valid), 1e-4)


def test_segment_planes_on_empty_depth():
    depth = np.zeros((240, 320), np.float32)
    st = tplanes.segment_planes(torch.from_numpy(depth), K4)
    assert not bool(st.valid.any())
    assert bool(torch.isfinite(st.coeffs).all())


def test_extract_lines_matches_jax(frame):
    gray, depth = frame
    lt = tlines.extract_lines(torch.from_numpy(gray), torch.from_numpy(depth),
                              K4, max_lines=32)
    lj = jlines.extract_lines(jnp.asarray(gray), jnp.asarray(depth), K4,
                              max_lines=32)
    assert int(lt.valid.sum()) >= 4
    for f in ("valid", "has3d", "man_ok", "desc"):
        same(getattr(lt, f), getattr(lj, f), f)
    for f in ("seg2d", "lineq"):
        close(getattr(lt, f), getattr(lj, f), 1e-3)
    close(lt.response, lj.response, 0.0, 1e-5)       # support sums reach 1e5
    ok = lt.has3d.numpy()
    for f in ("dir3d", "ep3d", "man_dir"):
        close(getattr(lt, f)[ok], np.asarray(getattr(lj, f))[ok], 1e-3)


def test_line_refinement_and_vanishing_points_match_jax():
    rng = np.random.RandomState(1)
    L, S = 12, 32
    d = rng.normal(size=(L, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    mu = rng.uniform(-1, 1, (L, 3)) + np.array([0, 0, 3.0])
    t = np.linspace(-0.5, 0.5, S)
    X = (mu[:, None] + t[None, :, None] * d[:, None]
         + rng.normal(0, 0.004, (L, S, 3))).astype(np.float32)
    w = (rng.rand(L, S) < 0.8).astype(np.float32)
    mu0 = (mu + 0.01).astype(np.float32)
    d0 = (d + rng.normal(0, 0.05, d.shape)).astype(np.float32)
    d0 /= np.linalg.norm(d0, axis=1, keepdims=True)
    rt = tlines.refine_line_mle(*(torch.from_numpy(a) for a in (X, w, mu0, d0)))
    rj = jlines.refine_line_mle(*(jnp.asarray(a) for a in (X, w, mu0, d0)))
    for a, b in zip(rt, rj):
        close(a, b, 1e-4)

    # lines of two pencils (vanishing points) plus clutter
    seg = []
    for vp in ((900.0, 130.0), (160.0, -2000.0)):
        for _ in range(8):
            p = rng.uniform(20, 300), rng.uniform(20, 220)
            dvec = np.array([vp[0] - p[0], vp[1] - p[1]])
            dvec /= np.linalg.norm(dvec)
            seg.append([p[0], p[1], p[0] + 40 * dvec[0], p[1] + 40 * dvec[1]])
    seg += rng.uniform(0, 300, (8, 4)).tolist()
    seg = np.asarray(seg, np.float32)
    dvec = seg[:, 2:] - seg[:, :2]
    dvec /= np.linalg.norm(dvec, axis=1, keepdims=True)
    a, b = -dvec[:, 1], dvec[:, 0]
    lineq = np.stack([a, b, -(a * seg[:, 0] + b * seg[:, 1])], -1).astype(np.float32)
    valid = np.ones(len(seg), bool)
    dt, okt = tlines.vp_directions(torch.from_numpy(lineq), torch.from_numpy(seg),
                                   torch.from_numpy(valid), K4)
    dj, okj = jlines.vp_directions(jnp.asarray(lineq), jnp.asarray(seg),
                                   jnp.asarray(valid), K4)
    same(okt, okj)
    assert int(okt.sum()) >= 12
    close(dt[okt], np.asarray(dj)[okt.numpy()], 1e-4)
