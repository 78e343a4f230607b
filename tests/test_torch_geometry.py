"""Parity of the port's configuration and geometry (dr_slam_torch/config.py,
geometry/se3.py, geometry/camera.py) with the JAX package.

Inputs are made with numpy from a seed and handed to both packages. Floats
agree within 2e-5 absolute plus 2e-5 relative: both sides run the same
float32 formulas, but the transcendental functions (sin, cos, atan2, sqrt)
of XLA and of PyTorch may differ in the last bit, and a few chained 3x3
products carry that forward."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu import config as jconfig
from dr_slam_tpu.geometry import camera as jcam
from dr_slam_tpu.geometry import se3 as jse3
from dr_slam_torch import config as tconfig
from dr_slam_torch.geometry import camera as tcam
from dr_slam_torch.geometry import se3 as tse3

torch.set_num_threads(2)

TOL = dict(atol=2e-5, rtol=2e-5)


def close(port, ref, **kw):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), **(kw or TOL))


def random_poses(rng, n):
    xi = np.concatenate([rng.normal(0, 0.5, (n, 3)), rng.normal(0, 0.8, (n, 3))],
                        1).astype(np.float32)
    return np.array(jse3.se3_exp(jnp.asarray(xi)), np.float32), xi


# --- configuration ----------------------------------------------------------

@pytest.mark.parametrize("preset", ["default", "tum_freiburg3", "yaml_dict"])
def test_config_matches_jax(preset):
    """The port's trimmed copy keeps every field of every group, with the
    reference's defaults and the TUM3 preset's values."""
    if preset == "default":
        j, t = jconfig.SlamConfig(), tconfig.SlamConfig()
    elif preset == "tum_freiburg3":
        j, t = jconfig.tum_freiburg3(), tconfig.tum_freiburg3()
    else:
        d = {"Camera.fx": 517.3, "Camera.width": 320, "ORBextractor.nLevels": 4,
             "Map.MaxPoints": 4096, "Plane.Chi2": 60.0, "Map.VocabWords": 512}
        j, t = jconfig.load_config(d), tconfig.load_config(d)
    assert t.detector is None     # a group the JAX package has not
    for f in dataclasses.fields(t):
        if f.name == "detector":
            continue
        tv, jv = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(tv):
            assert dataclasses.asdict(tv) == dataclasses.asdict(jv), f.name
        else:
            assert tv == jv, f.name
    assert t.camera.K4 == j.camera.K4
    assert t.camera.depth_factor == j.camera.depth_factor


# --- SE(3) / SO(3) -----------------------------------------------------------

def test_so3_se3_exp_log_match_jax():
    rng = np.random.RandomState(0)
    w = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    w[:4] *= 1e-5                                    # small-angle branch
    close(tse3.hat(torch.from_numpy(w)), jse3.hat(jnp.asarray(w)))
    R = np.array(jse3.so3_exp(jnp.asarray(w)))
    close(tse3.so3_exp(torch.from_numpy(w)), R)
    close(tse3.vee(torch.from_numpy(R)), jse3.vee(jnp.asarray(R)))
    close(tse3.so3_log(torch.from_numpy(R)), jse3.so3_log(jnp.asarray(R)),
          atol=1e-4, rtol=1e-4)
    T, xi = random_poses(rng, 64)
    close(tse3.se3_exp(torch.from_numpy(xi)), T)
    close(tse3.se3_log(torch.from_numpy(T)), jse3.se3_log(jnp.asarray(T)),
          atol=1e-4, rtol=1e-4)


def test_pose_algebra_and_projection_match_jax():
    rng = np.random.RandomState(1)
    T, _ = random_poses(rng, 8)
    Tt, Tj = torch.from_numpy(T), jnp.asarray(T)
    close(tse3.inv_T(Tt), jse3.inv_T(Tj))
    close(tse3.make_T(Tt[:, :3, :3], Tt[:, :3, 3]),
          jse3.make_T(Tj[:, :3, :3], Tj[:, :3, 3]))
    pts = rng.uniform(-2, 2, (8, 100, 3)).astype(np.float32)
    pts[..., 2] += 4.0
    close(tse3.transform_points(Tt, torch.from_numpy(pts)),
          jse3.transform_points(Tj, jnp.asarray(pts)))
    K4 = (535.4, 539.2, 320.1, 247.6)
    uv = tse3.project(K4, torch.from_numpy(pts))
    close(uv, jse3.project(jnp.asarray(K4), jnp.asarray(pts)), atol=1e-3)
    depth = rng.uniform(0.5, 4, (8, 100)).astype(np.float32)
    close(tse3.backproject(K4, uv, torch.from_numpy(depth)),
          jse3.backproject(jnp.asarray(K4), jnp.asarray(uv.numpy()),
                           jnp.asarray(depth)))


def test_orthonormalize_rotation_matches_jax():
    rng = np.random.RandomState(2)
    T, _ = random_poses(rng, 16)
    M = T[:, :3, :3] + rng.normal(0, 0.05, (16, 3, 3)).astype(np.float32)
    M[0] = -M[0]                                     # improper input
    out = tse3.orthonormalize_rotation(torch.from_numpy(M))
    close(out, jse3.orthonormalize_rotation(jnp.asarray(M)))
    R = out.numpy()
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), R.shape), atol=1e-5)


def test_plane_helpers_match_jax():
    rng = np.random.RandomState(3)
    T, _ = random_poses(rng, 1)
    T = T[0]
    p = rng.normal(size=(32, 4)).astype(np.float32)
    Tt, Tj = torch.from_numpy(T), jnp.asarray(T)
    pt, pj = torch.from_numpy(p), jnp.asarray(p)
    close(tse3.normalize_plane(pt), jse3.normalize_plane(pj))
    close(tse3.plane_to_camera(Tt, pt), jse3.plane_to_camera(Tj, pj))
    close(tse3.plane_to_world(Tt, pt), jse3.plane_to_world(Tj, pj))
    a = np.asarray(jse3.normalize_plane(pj))
    b = np.asarray(jse3.normalize_plane(jnp.asarray(
        p + rng.normal(0, 0.1, p.shape).astype(np.float32))))
    close(tse3.plane_ominus(torch.from_numpy(a), torch.from_numpy(b)),
          jse3.plane_ominus(jnp.asarray(a), jnp.asarray(b)), atol=1e-4)


# --- camera distortion --------------------------------------------------------

def test_distortion_round_trip_matches_jax():
    rng = np.random.RandomState(4)
    K4 = (517.3, 516.5, 318.6, 255.3)
    dist = (0.2624, -0.9531, -0.0054, 0.0026, 1.1633)    # TUM fr1 (ORB-SLAM)
    uv = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 480, 500)],
                  -1).astype(np.float32)
    d_t = tcam.distort_points(torch.from_numpy(uv), K4, dist)
    d_j = jcam.distort_points(jnp.asarray(uv), K4, dist)
    close(d_t, d_j, atol=1e-3)
    u_t = tcam.undistort_points(d_t, K4, dist)
    close(u_t, jcam.undistort_points(jnp.asarray(d_t.numpy()), K4, dist),
          atol=1e-3)
    np.testing.assert_allclose(u_t.numpy(), uv, atol=0.05)
