"""The port's CAPE cylinders (dr_slam_torch/ops/cylinders.py) against the JAX
package's (dr_slam_tpu/ops/cylinders.py) on the CPU: the threefry Gumbel
noise that draws the RANSAC triplets, the golden cells of
tests/test_cylinders.py, the pass over a ray-cast depth map, and the frame
flag.

Tolerances: Gumbel values within 1e-6 (observed 4.8e-7: float32 logs) with
the top-3 indices exact; valid flags, cell masks and the valid slots' cell
counts exact; radius, centre and axis of the valid slots within CYL_TOL
(1e-2; observed 7e-7 on the golden cells, 3.5e-3 on the depth render,
where the closed-form float32 eigensolver is ill-conditioned on cells
whose two small eigenvalues are close). A rejected slot's count is that of
a rejected hypothesis and is not compared."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.frontend.frame import extract_frame as jextract
from dr_slam_tpu.ops import cylinders as jc
from dr_slam_tpu.ops.planes import segment_planes as jplanes
from dr_slam_torch._smoke import CYL_FIELDS, CYL_TOL, cylinder_gaps
from dr_slam_torch.config import tum_freiburg3
from dr_slam_torch.frontend.frame import extract_frame as textract
from dr_slam_torch.ops import cylinders as tc
from dr_slam_torch.ops.planes import segment_planes as tplanes
from test_cylinders import _cylinder_cells, _render_cylinder_depth
from torch_parity import small_cfg, to_port

torch.set_num_threads(2)


def _as_fixture(seg, prefix="want") -> dict:
    return {f"{prefix}__{k}": np.asarray(getattr(seg, k)) for k in CYL_FIELDS}


def _check(got, want) -> dict:
    gaps, fails = cylinder_gaps(got, _as_fixture(want), "want")
    assert not fails, (fails, gaps)
    return gaps


@pytest.mark.parametrize("k", [0, 1, 2])
def test_gumbel_matches_jax(k):
    key = jax.random.fold_in(jax.random.PRNGKey(7), k)
    want = np.asarray(jax.random.gumbel(key, (48, 300)))
    tkey = tc.fold_in(tc.KEY, k)
    assert list(tkey) == np.asarray(jax.random.key_data(key)).tolist()
    got = tc.gumbel(tkey, (48, 300), "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        torch.sort(torch.from_numpy(got), dim=-1, descending=True,
                   stable=True).indices[:, :3].numpy(),
        np.asarray(jax.lax.top_k(jnp.asarray(want), 3)[1]))


def _extract(pts, nrm):
    active = np.ones(len(pts), bool)
    want = jc.extract_cylinders(jnp.asarray(pts), jnp.asarray(nrm),
                                jnp.asarray(active))
    got = tc.extract_cylinders(torch.from_numpy(np.array(pts)),
                               torch.from_numpy(np.array(nrm)),
                               torch.from_numpy(active))
    return got, want


def test_extract_cylinders_golden():
    axis = np.array([0.1, 0.97, 0.05])
    axis /= np.linalg.norm(axis)
    pts, nrm = _cylinder_cells(axis, np.array([0.4, 0.1, 2.0]), 0.25)
    got, want = _extract(pts, nrm)
    gaps = _check(got, want)
    assert gaps["valid"] == [True, False, False]
    np.testing.assert_array_equal(got.n_cells.numpy(), np.asarray(want.n_cells))
    assert abs(float(got.radius[0]) - 0.25) < 0.02
    assert got.n_cells.dtype == torch.int32


def test_extract_two_cylinders_golden():
    p1, n1 = _cylinder_cells([0, 1, 0], [0.0, 0.0, 1.5], 0.20, seed=1)
    p2, n2 = _cylinder_cells([0, 1, 0], [1.5, 0.0, 3.0], 0.45, seed=2)
    got, want = _extract(np.concatenate([p1, p2]), np.concatenate([n1, n2]))
    gaps = _check(got, want)
    assert sum(gaps["valid"]) == 2


def test_flat_cells_yield_no_cylinder():
    rng = np.random.RandomState(0)
    pts = rng.uniform(-1, 1, (40, 3)).astype(np.float32)
    nrm = np.tile([0, 0, 1.0], (40, 1)) + rng.randn(40, 3) * 0.002
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32)
    got, want = _extract(pts, nrm)
    _check(got, want)
    assert not got.valid.any()


@pytest.mark.parametrize("size", [(240, 320), (480, 640)])
def test_segment_cylinders_from_depth(size):
    """tests/test_cylinders.py's cylinder before a wall at 320x240, and the
    same generator at 640x480 with tum_freiburg3()'s intrinsics (a radius
    of 0.12 m at 1.6 m, the wall 5 cm behind: phase 10's scene): the plane
    labels exact, then the cylinders."""
    h, w = size
    if w == 320:
        K4, scene = (250.0, 250.0, 160.0, 120.0), {"R": 0.30}
    else:
        K4 = tum_freiburg3().camera.K4
        scene = {"X0": 0.2, "Z0": 1.6, "R": 0.12, "zwall": 1.77}
    depth = _render_cylinder_depth(K4, h, w, **scene)
    jp, tp = jplanes(jnp.asarray(depth), K4), tplanes(torch.from_numpy(depth),
                                                      K4)
    np.testing.assert_array_equal(tp.block_label.numpy(),
                                  np.asarray(jp.block_label))
    want = jc.segment_cylinders(jnp.asarray(depth), K4, jp.block_label)
    got = tc.segment_cylinders(torch.from_numpy(depth), K4, tp.block_label)
    gaps = _check(got, want)
    assert gaps["valid"][0]
    assert abs(float(got.radius[0]) - scene["R"]) < 0.05
    assert abs(float(got.axis[0, 1])) > 0.99


def test_reference_geometry_finds_nothing_at_640():
    """The test generator's own geometry (radius 0.3 m at 2.2 m, the wall at
    4 m) at 640x480: the JAX pass finds no cylinder there (the plane
    segmentation claims the body: neighbouring cells' normals differ by
    less than the merge angle at this resolution), and neither does the
    port."""
    K4 = tum_freiburg3().camera.K4
    depth = _render_cylinder_depth(K4, 480, 640, R=0.30)
    want = jc.segment_cylinders(jnp.asarray(depth), K4,
                                jplanes(jnp.asarray(depth), K4).block_label)
    got = tc.segment_cylinders(torch.from_numpy(depth), K4,
                               tplanes(torch.from_numpy(depth), K4).block_label)
    assert not np.asarray(want.valid).any()
    assert not got.valid.any()


def test_frame_flag():
    """detect_cylinders=True threads the cylinders through extract_frame
    (Frame::ExtractCylinder); the default leaves them None."""
    cfg0 = small_cfg()
    K4 = cfg0.camera.K4
    depth = _render_cylinder_depth(K4, 240, 320, R=0.30)
    gray = np.tile(np.linspace(0, 255, 320, dtype=np.float32), (240, 1))
    assert textract(gray, depth, to_port(cfg0), "cpu").cylinders is None
    cfg = cfg0.replace(plane=dataclasses.replace(cfg0.plane,
                                                 detect_cylinders=True))
    want = jextract(jnp.asarray(gray), jnp.asarray(depth), cfg).cylinders
    got = textract(gray, depth, to_port(cfg), "cpu").cylinders
    gaps = _check(got, want)
    assert gaps["valid"][0]
    assert max(gaps[k] for k in ("axis", "center", "radius")) < CYL_TOL
