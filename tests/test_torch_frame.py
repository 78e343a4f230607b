"""Parity of the port's per-frame front-end and tracking math
(dr_slam_torch/frontend/frame.py, manhattan/tracker.py,
optimize/residuals.py, optimize/pose_opt.py) with the JAX package.

The whole front-end runs on rendered corridor frames at the small
configuration of tests/test_tracking_e2e.py (320x240, 512 keypoints), in
float32 as the JAX `System` is fed in its tests. (On uint8 images the FAST
responses of level 0 are integers and those of coarser levels land within
1e-5 of integers, where any last-bit difference reorders near-tied
keypoints; the ingestion of uint8 / uint16 frames is compared on its
own.) Integer outputs
(keypoint validity, octaves, descriptors, plane labels and validity, line
validity and descriptors, solver inlier masks and counts, Manhattan success
and cone memberships) must match exactly. Float tolerances, with their
reasons:
- keypoint and line pixel coordinates 1e-3 px, depths 1e-4 m, 3D points
  and directions 1e-3: float32 sums in another order (see the per-module
  tests);
- residuals 1e-4 relative; the port's analytic Jacobians against
  `jax.jacfwd` of the JAX residuals 1e-3 relative (forward-mode and closed
  form round differently);
- poses after the 4 x 10 Gauss-Newton solve 1e-4 (the iteration contracts,
  so per-step rounding does not grow)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.frontend import frame as jframe
from dr_slam_tpu.geometry import se3 as jse3
from dr_slam_tpu.io import synthetic
from dr_slam_tpu.manhattan import tracker as jman
from dr_slam_tpu.optimize import pose_opt as jpose
from dr_slam_tpu.optimize import residuals as jres
from dr_slam_torch.frontend import frame as tframe
from dr_slam_torch.manhattan import tracker as tman
from dr_slam_torch.optimize import pose_opt as tpose
from dr_slam_torch.optimize import residuals as tres

from torch_parity import small_cfg, to_port

torch.set_num_threads(2)

K4 = (267.7, 269.6, 160.0, 120.0)
BF = 20.0


def close(port, ref, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), atol=atol,
                               rtol=rtol, err_msg=err_msg)


def same(port, ref, err_msg=""):
    b = np.asarray(ref)
    if b.dtype == np.uint32:
        b = b.view(np.int32)
    np.testing.assert_array_equal(port.numpy(), b, err_msg=err_msg)


# --- the whole front-end ----------------------------------------------------------

@pytest.mark.parametrize("index", [0, 7])
def test_extract_frame_matches_jax(index):
    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(8, step=0.03), K4=cfg.camera.K4,
        height=240, width=320)
    gray, depth = (np.array(x, np.float32) for x in seq.render(index))
    fj = jframe.extract_frame(jnp.asarray(gray), jnp.asarray(depth), cfg)
    ft = tframe.extract_frame(gray, depth, to_port(cfg), device="cpu")

    assert int(ft.kp.valid.sum()) > 200
    for f in ("valid", "octave", "desc"):
        same(getattr(ft.kp, f), getattr(fj.kp, f), "kp." + f)
    for f in ("uv", "response", "angle", "sigma2"):
        close(getattr(ft.kp, f), getattr(fj.kp, f), 1e-3, err_msg="kp." + f)
    close(ft.kp_depth, fj.kp_depth, 1e-4)
    close(ft.kp_ur, fj.kp_ur, 1e-2)
    close(ft.kp_xyz, fj.kp_xyz, 1e-3)
    same(ft.normals_valid, fj.normals_valid)
    close(ft.normals, fj.normals, 1e-4)
    for f in ("valid", "n_blocks", "block_label", "cloud_valid"):
        same(getattr(ft.planes, f), getattr(fj.planes, f), "planes." + f)
    close(ft.planes.coeffs, fj.planes.coeffs, 1e-3)
    for f in ("valid", "has3d", "man_ok", "desc"):
        same(getattr(ft.lines, f), getattr(fj.lines, f), "lines." + f)
    close(ft.lines.seg2d, fj.lines.seg2d, 1e-3)
    ok = ft.lines.man_ok.numpy()
    close(ft.lines.man_dir[ok], np.asarray(fj.lines.man_dir)[ok], 1e-3)


def test_ingest_matches_jax():
    """uint8 gray and uint16 sensor depth become the same float32 frame."""
    cfg = small_cfg()
    rng = np.random.RandomState(9)
    gray = rng.randint(0, 256, (24, 32)).astype(np.uint8)
    depth = rng.randint(0, 2 ** 16, (24, 32)).astype(np.uint16)
    gj, dj = jframe.ingest(jnp.asarray(gray), jnp.asarray(depth), cfg.camera)
    gt, dt = tframe.ingest(gray, depth, to_port(cfg).camera, "cpu")
    assert gt.dtype == dt.dtype == torch.float32
    same(gt, gj)
    same(dt, dj)


# --- Manhattan mean shift ---------------------------------------------------------

@pytest.mark.parametrize("with_lines", [False, True])
def test_track_manhattan_frame_matches_jax(with_lines):
    rng = np.random.RandomState(5 + with_lines)
    R_true = np.array(jse3.so3_exp(jnp.asarray([0.1, -0.2, 0.15])), np.float32)
    axes = R_true.T                                   # rows: Manhattan axes
    lab = rng.randint(0, 3, 600)
    n = axes[lab] * np.sign(rng.randn(600, 1)) + rng.normal(0, 0.05, (600, 3))
    n = (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)
    n_ok = rng.rand(600) < 0.9
    n[:60] = rng.normal(size=(60, 3)).astype(np.float32)   # clutter
    R0 = np.array(jse3.so3_exp(jnp.asarray([0.13, -0.17, 0.12])) @ axes,
                  np.float32).T @ axes @ R_true           # a nearby start
    R0 = np.array(jse3.orthonormalize_rotation(jnp.asarray(R0)), np.float32)
    kw = {}
    if with_lines:
        ld = axes[rng.randint(0, 3, 20)] + rng.normal(0, 0.02, (20, 3))
        kw = dict(line_dirs=ld.astype(np.float32), line_valid=rng.rand(20) < 0.8)
    rj = jman.track_manhattan_frame(jnp.asarray(R0), jnp.asarray(n),
                                    jnp.asarray(n_ok),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
    rt = tman.track_manhattan_frame(torch.from_numpy(R0), torch.from_numpy(n),
                                    torch.from_numpy(n_ok),
                                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert bool(rt.success)
    same(rt.success, rj.success)
    same(rt.n_members, rj.n_members)
    close(rt.R_cm, rj.R_cm, 1e-4)


# --- residuals and pose optimization ----------------------------------------------

def scene(seed, n_pts=200, outliers=20):
    """Points (stereo and mono, some outliers), lines and planes seen from a
    known pose; the JAX pose-solver test's construction."""
    rng = np.random.RandomState(seed)
    T_true = np.array(jse3.se3_exp(jnp.asarray([0.1, -0.05, 0.2, 0.02, -0.03,
                                                0.05])), np.float32)
    pts = rng.uniform([-2, -1.5, 2.0], [2, 1.5, 6.0], (n_pts, 3)).astype(np.float32)
    Xc = pts @ T_true[:3, :3].T + T_true[:3, 3]
    uv = np.stack([K4[0] * Xc[:, 0] / Xc[:, 2] + K4[2],
                   K4[1] * Xc[:, 1] / Xc[:, 2] + K4[3]], -1)
    uv += 0.3 * rng.randn(n_pts, 2)
    ur = uv[:, 0] - BF / (Xc[:, 2] * (1 + 0.003 * rng.randn(n_pts)))
    ur[::3] = -1.0                                     # monocular rows
    uv[:outliers] += rng.uniform(20, 60, (outliers, 2))
    pt_obs = np.concatenate([uv, ur[:, None]], -1).astype(np.float32)

    ends = np.concatenate([rng.uniform([-2, -1, 3], [2, 1, 5], (12, 3)),
                           rng.uniform([-2, -1, 3], [2, 1, 5], (12, 3))],
                          1).astype(np.float32)
    lq = []
    for e in ends:
        p = [e[:3] @ T_true[:3, :3].T + T_true[:3, 3],
             e[3:] @ T_true[:3, :3].T + T_true[:3, 3]]
        h = [np.array([K4[0] * q[0] / q[2] + K4[2], K4[1] * q[1] / q[2] + K4[3],
                       1.0]) for q in p]
        l = np.cross(h[0], h[1])
        lq.append(l / np.linalg.norm(l[:2]))
    ln_obs = (np.asarray(lq) + rng.normal(0, 1e-3, (12, 3))).astype(np.float32)

    pl_w = np.array([[1, 0, 0, 2.0], [0, 1, 0, 1.5], [0, 0, 1, -7.0],
                     [0, 0, 0, 0]], np.float32)
    pl_c = np.array(jse3.plane_to_camera(jnp.asarray(T_true), jnp.asarray(pl_w)))
    pl_c = (pl_c + rng.normal(0, 1e-3, pl_c.shape)).astype(np.float32)
    pl_valid = np.array([True, True, True, False])
    return T_true, dict(
        pt_world=pts, pt_obs=pt_obs,
        pt_inv_sigma2=rng.choice([1.0, 1 / 1.44], n_pts).astype(np.float32),
        pt_valid=rng.rand(n_pts) < 0.95,
        ln_world=ends, ln_obs=ln_obs,
        ln_inv_sigma2=np.full(12, 0.25, np.float32), ln_valid=rng.rand(12) < 0.9,
        pl_world=pl_w, pl_obs=pl_c, pl_valid=pl_valid,
        par_world=pl_w[[0, 1]], par_obs=pl_c[[0, 1]], par_valid=np.ones(2, bool),
        ver_world=pl_w[[1, 2]], ver_obs=pl_c[[0, 0]], ver_valid=np.ones(2, bool))


def perturbed(T, seed):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.02, 3)])
    return np.array(jse3.se3_exp(jnp.asarray(xi, jnp.float32)) @ T, np.float32)


def test_residuals_and_jacobians_match_jax():
    T_true, o = scene(0)
    T = perturbed(T_true, 1)
    Tt = torch.from_numpy(T)
    t = {k: torch.from_numpy(v) for k, v in o.items()}
    j = {k: jnp.asarray(v) for k, v in o.items()}

    def lift(f):
        return lambda xi: f(jse3.se3_exp(xi) @ jnp.asarray(T))

    cases = [
        (lambda TT: jres.point_residuals(TT, j["pt_world"], j["pt_obs"],
                                         j["pt_inv_sigma2"], j["pt_valid"], K4, BF),
         lambda jac: tres.point_residuals(Tt, t["pt_world"], t["pt_obs"],
                                          t["pt_inv_sigma2"], t["pt_valid"], K4,
                                          BF, jac=jac), 4),
        (lambda TT: jres.line_residuals(TT, j["ln_world"], j["ln_obs"],
                                        j["ln_inv_sigma2"], j["ln_valid"], K4),
         lambda jac: tres.line_residuals(Tt, t["ln_world"], t["ln_obs"],
                                         t["ln_inv_sigma2"], t["ln_valid"], K4,
                                         jac=jac), 3),
    ]
    for fj, ft, n_out in cases:
        ref = fj(jnp.asarray(T))
        out = ft(True)
        for a, b in zip(out[:n_out - 1], ref[:n_out - 1]):
            close(a, b, 1e-4, 1e-4)
        J_ref = jax.jacfwd(lambda xi: lift(fj)(xi)[0])(jnp.zeros(6))
        close(out[-1], J_ref, 1e-2, 1e-3)
    ref = jres.plane_residuals(jnp.asarray(T), j["pl_world"], j["pl_obs"],
                               j["pl_valid"], 0.5, 50.0)
    out = tres.plane_residuals(Tt, t["pl_world"], t["pl_obs"], t["pl_valid"],
                               0.5, 50.0)
    for a, b in zip(out, ref):
        close(a, b, 1e-5, 1e-4)
    for name, world, obs in (("parallel", "par_world", "par_obs"),
                             ("vertical", "ver_world", "ver_obs")):
        valid = "par_valid" if name == "parallel" else "ver_valid"
        ref = getattr(jres, name + "_residuals")(jnp.asarray(T), j[world],
                                                 j[obs], j[valid], 0.5)
        out = getattr(tres, name + "_residuals")(Tt, t[world], t[obs],
                                                 t[valid], 0.5)
        for a, b in zip(out, ref):
            close(a, b, 1e-5, 1e-4)
    # the structural Jacobian against forward-mode differentiation
    st_w, st_o = tres._sanitize_planes(t["pl_world"], t["pl_obs"], t["pl_valid"])
    _, Je = tres.structural_terms(Tt, st_w, st_o, jac=True)
    Jp = jax.jacfwd(lambda xi: jres.plane_residuals(
        jse3.se3_exp(xi) @ jnp.asarray(T), j["pl_world"], j["pl_obs"],
        j["pl_valid"], 0.5, 50.0)[0])(jnp.zeros(6))
    valid = o["pl_valid"]
    close(Je[:, :3][valid], np.asarray(Jp)[valid], 1e-3, 1e-3)


@pytest.mark.parametrize("mode", ["full", "translation_only", "struct_prior"])
def test_pose_optimize_matches_jax(mode):
    T_true, o = scene(2)
    T0 = perturbed(T_true, 3)
    kw = dict(n_rounds=4, n_iters=10)
    if mode == "translation_only":
        kw.update(translation_only=True)
    elif mode == "struct_prior":
        kw.update(struct_on=True, prior_sigma_t=0.3, prior_sigma_r=0.03)
    ref = jpose.pose_optimize(jnp.asarray(T0), jpose.PoseObservations(
        **{k: jnp.asarray(v) for k, v in o.items()}), K4, BF, **kw)
    out = tpose.pose_optimize(torch.from_numpy(T0), tpose.PoseObservations(
        **{k: torch.from_numpy(v) for k, v in o.items()}), K4, BF, **kw)
    for f in ("pt_inlier", "ln_inlier", "pl_inlier", "n_inliers"):
        same(getattr(out, f), getattr(ref, f), f)
    assert int(out.n_inliers) > 100
    close(out.T_cw, ref.T_cw, 1e-4)
    close(out.chi2, ref.chi2, 1e-2, 1e-3)
