"""The pose solve's CUDA kernel (`csrc/pose_gn.cu`, `optimize/pose_gn.py`)
against `pose_optimize`'s plain body on the card, and its dispatch and input
checks on the CPU.

The kernel tests are marked `cuda` and skip without a GPU. On a machine with
one (which has no JAX, so the JAX test configuration is left out):

    python -m pytest --noconftest tests/test_torch_pose_kernel.py -q

Tolerances, kernel against plain body on the same card, are
`dr_slam_torch._smoke`'s POSE_T_TOL, POSE_MASK_REL and POSE_CHI2_REL, held
by its `pose_gaps`: the kernel sums J^T W J and J^T W r per thread and then
over the block, where the plain body leaves them to cuBLAS and ATen's
reductions, so the float32 sums differ in order, and 40 dependent steps
carry that forward; a mask may flip only for an edge whose chi2 at the
plain body's pose lies within POSE_MASK_REL of its threshold. Two launches
on the same input agree bit for bit (fixed reduction order, no atomics).

This file imports nothing of the JAX package."""

import numpy as np
import pytest
import torch

from dr_slam_torch._smoke import pose_gaps, pose_solves
from dr_slam_torch.geometry import se3
from dr_slam_torch.optimize import pose_gn, pose_opt

torch.set_num_threads(2)

K4 = (535.4, 539.2, 320.1, 247.6)   # tum_freiburg3
BF = 40.0
# track_step's solves: the weak prior around the predicted pose
PRIOR = dict(prior_sigma_t=0.3, prior_sigma_r=0.03)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene(seed, n_pts=1024, n_ln=64, n_pl=8, n_st=16, outliers=0.1):
    """(T_true, observation set) at the main path's capacities: stereo and
    monocular points (a share `outliers` of them moved 10-60 px), lines
    through projected segments, four of the planes observed, two parallel
    and two vertical relations; about a tenth of the points and a fifth of
    the lines invalid."""
    rng = np.random.RandomState(seed)
    T_true = se3.se3_exp(torch.tensor([0.1, -0.05, 0.2, 0.02, -0.03, 0.05]))
    R, t = T_true[:3, :3].numpy(), T_true[:3, 3].numpy()
    pts = rng.uniform([-2, -1.5, 1.0], [2, 1.5, 6.0], (n_pts, 3))
    Xc = pts @ R.T + t
    uv = np.stack([K4[0] * Xc[:, 0] / Xc[:, 2] + K4[2],
                   K4[1] * Xc[:, 1] / Xc[:, 2] + K4[3]], -1)
    uv += 0.5 * rng.randn(n_pts, 2)
    ur = uv[:, 0] - BF / (Xc[:, 2] * (1 + 0.003 * rng.randn(n_pts)))
    ur[::3] = -1.0                                     # monocular rows
    n_out = int(outliers * n_pts)
    uv[:n_out] += (rng.uniform(10, 60, (n_out, 2))
                   * rng.choice([-1, 1], (n_out, 2)))
    ends = np.concatenate([rng.uniform([-2, -1, 2], [2, 1, 5], (n_ln, 3)),
                           rng.uniform([-2, -1, 2], [2, 1, 5], (n_ln, 3))], 1)
    lq = []
    for e in ends:
        h = [np.array([K4[0] * q[0] / q[2] + K4[2],
                       K4[1] * q[1] / q[2] + K4[3], 1.0])
             for q in (e[:3] @ R.T + t, e[3:] @ R.T + t)]
        line = np.cross(h[0], h[1])
        lq.append(line / np.linalg.norm(line[:2]))
    ln_obs = np.asarray(lq) + rng.normal(0, 1e-3, (n_ln, 3))
    pl_w = np.zeros((n_pl, 4))
    pl_w[:4] = [[1, 0, 0, 2.0], [0, 1, 0, 1.5], [0, 0, 1, -7.0],
                [-1, 0, 0, 2.0]]
    pl_c = se3.plane_to_camera(T_true, torch.tensor(pl_w, dtype=torch.float32))
    pl_c = pl_c.numpy() + rng.normal(0, 1e-3, (n_pl, 4))
    live = np.arange(n_pl) < 4
    par_w, par_o, ver_w, ver_o = (np.zeros((n_st, 4)) for _ in range(4))
    par_w[:2], par_o[:2] = pl_w[[0, 3]], pl_c[[3, 0]]
    ver_w[:2], ver_o[:2] = pl_w[[1, 2]], pl_c[[0, 0]]
    rel = np.arange(n_st) < 2
    o = dict(pt_world=pts, pt_obs=np.concatenate([uv, ur[:, None]], -1),
             pt_inv_sigma2=rng.choice([1.0, 1 / 1.44, 1 / 2.0736], n_pts),
             pt_valid=rng.rand(n_pts) < 0.9,
             ln_world=ends, ln_obs=ln_obs, ln_inv_sigma2=np.full(n_ln, 0.25),
             ln_valid=rng.rand(n_ln) < 0.8,
             pl_world=pl_w, pl_obs=pl_c, pl_valid=live,
             par_world=par_w, par_obs=par_o, par_valid=rel,
             ver_world=ver_w, ver_obs=ver_o, ver_valid=rel.copy())
    return T_true, pose_opt.PoseObservations(**{
        k: torch.tensor(v, dtype=torch.bool if v.dtype == bool
                        else torch.float32) for k, v in o.items()})


def perturbed(T, seed):
    rng = np.random.RandomState(seed)
    xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.02, 3)])
    return se3.se3_exp(torch.tensor(xi, dtype=torch.float32)) @ T


def to(obs, dev):
    return pose_opt.PoseObservations(*(x.to(dev) for x in obs))


def loop_obs(obs):
    """The loop transform's refinement: K points, one line, plane and
    structural slot, all invalid (`loop_closing._refine_loop_rel`)."""
    K = obs.pt_valid.shape[0]
    return pose_opt.PoseObservations.empty(K, 1, 1, 1)._replace(
        pt_world=obs.pt_world, pt_obs=obs.pt_obs,
        pt_inv_sigma2=obs.pt_inv_sigma2, pt_valid=obs.pt_valid)


def hold(T0, obs, **kw):
    """The kernel against the plain body on the card, one launch counted;
    returns the kernel's result."""
    before = pose_opt.pose_optimize.launches
    out = pose_opt.pose_optimize(T0, obs, K4, BF, **kw)
    torch.cuda.synchronize()
    assert pose_opt.pose_optimize.launches == before + 1
    args = _args(T0, obs, **kw)
    plain = pose_opt._pose_optimize_plain(*args)
    for f in pose_opt.PoseOptResult._fields:
        a, b = getattr(out, f), getattr(plain, f)
        assert (a.dtype, a.shape, a.device) == (b.dtype, b.shape, b.device), f
    gaps, fails = pose_gaps(args, out, plain)
    assert not fails, (fails, gaps)
    return out


# pose_optimize's keywords and defaults, in order
DEFAULTS = dict(translation_only=False, struct_on=False, n_rounds=4,
                n_iters=10, angle_info=0.5, dist_info=50.0, plane_chi2=100.0,
                vp_chi2=50.0, damping=1e-5, prior_sigma_t=0.0,
                prior_sigma_r=0.0)


def _args(T0, obs, **kw):
    return (T0, obs, K4, BF, *dict(DEFAULTS, **kw).values())


CASES = {
    # track_step's first solve (structural edges off) and second (on)
    "first_solve": (0, 0.1, False, dict(PRIOR)),
    "second_solve": (1, 0.1, False, dict(PRIOR, struct_on=True)),
    "translation_only": (2, 0.1, False, dict(PRIOR, translation_only=True)),
    "loop_closing": (3, 0.1, True, dict(n_rounds=2, n_iters=8)),
    "gross_outliers": (4, 0.3, False, dict(PRIOR, struct_on=True)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_matches_the_plain_body(cuda_device, case):
    seed, outliers, loop, kw = CASES[case]
    T_true, obs = scene(seed, outliers=outliers)
    if loop:
        obs = loop_obs(obs)
    T0 = perturbed(T_true, seed + 10).to(cuda_device)
    out = hold(T0, to(obs, cuda_device), **kw)
    assert int(out.n_inliers) > 300 or kw.get("translation_only")


@pytest.mark.cuda
@pytest.mark.parametrize("prior", [False, True])
def test_kernel_all_invalid_keeps_the_pose(cuda_device, prior):
    T_true, _ = scene(5)
    T0 = perturbed(T_true, 6).to(cuda_device)
    obs = pose_opt.PoseObservations.empty(1024, 64, 8, 16, cuda_device)
    out = hold(T0, obs, **(PRIOR if prior else {}))
    if prior:  # log(T T^-1) is rounding, not 0
        assert float((out.T_cw - T0).abs().max()) < 1e-6
    else:
        assert torch.equal(out.T_cw, T0)
    assert int(out.n_inliers) == 0 and not bool(out.pt_inlier.any())


@pytest.mark.cuda
def test_kernel_repeats_bit_for_bit(cuda_device):
    T_true, obs = scene(7)
    T0, obs = perturbed(T_true, 8).to(cuda_device), to(obs, cuda_device)
    a = pose_opt.pose_optimize(T0, obs, K4, BF, struct_on=True, **PRIOR)
    b = pose_opt.pose_optimize(T0, obs, K4, BF, struct_on=True, **PRIOR)
    for f in pose_opt.PoseOptResult._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.cuda
def test_kernel_on_the_main_path_observations(cuda_device):
    """The observation sets `map_ops.build_pose_obs` makes on the smoke
    fixture's four frames (640x480, the JAX package's map): two launches a
    tracked frame, each held against the plain body."""
    from dr_slam_torch._smoke import load_fixture, shipped_codebooks
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.slam import track_step as ts

    cfg = tum_freiburg3()
    with shipped_codebooks(), pose_solves() as solves:
        fx = load_fixture(cuda_device)
        st, T, V, R = fx.state, fx.T_last, fx.velocity, fx.R_cm
        before = pose_opt.pose_optimize.launches
        for g, d in fx.frames:
            _, out = ts.extract_and_track(g, d, st, T, V, R, fx.ref_kf, cfg,
                                          device="cuda")
            st, T, V, R = (out.new_map_state, out.T_cw, out.velocity,
                           out.R_cm)
        torch.cuda.synchronize()
    assert pose_opt.pose_optimize.launches == before + 2 * len(fx.frames)
    assert len(solves) == 2 * len(fx.frames)
    for T0, obs, K4_, bf, *rest in solves:
        assert (tuple(K4_), bf) == (cfg.camera.K4, cfg.camera.bf)
        kw = dict(zip(DEFAULTS, rest))
        out = hold(T0, obs, **kw)
        assert int(out.n_inliers) > 100


# --- on the CPU: dispatch and input checks ----------------------------------

def test_cpu_tensors_take_the_plain_body():
    T_true, obs = scene(0, n_pts=128, n_ln=8)
    T0 = perturbed(T_true, 1)
    before = pose_opt.pose_optimize.launches
    out = pose_opt.pose_optimize(T0, obs, K4, BF, struct_on=True, **PRIOR)
    assert pose_opt.pose_optimize.launches == before
    plain = pose_opt._pose_optimize_plain(*_args(T0, obs, struct_on=True,
                                                 **PRIOR))
    for f in pose_opt.PoseOptResult._fields:
        assert torch.equal(getattr(out, f), getattr(plain, f)), f
    assert int(out.n_inliers) > 80


def test_kernel_entry_raises_without_a_gpu():
    """No silent CPU fallback: the kernel's entry refuses CPU tensors, with
    the reason, and launches nothing."""
    T_true, obs = scene(0, n_pts=64, n_ln=4)
    before = pose_opt.pose_optimize.launches
    with pytest.raises(ValueError, match="takes CUDA tensors"):
        pose_gn.solve(*_args(T_true, obs, **PRIOR))
    assert pose_opt.pose_optimize.launches == before


def test_pose_gaps_hold_the_bounds():
    """The comparison the card tests and the smoke run make: the plain body
    against itself passes; a moved pose, a mask flipped far from its
    threshold, a count that is not the mask's and a moved chi2 each fail."""
    T_true, obs = scene(0, n_pts=128, n_ln=8)
    args = _args(perturbed(T_true, 1), obs, struct_on=True, **PRIOR)
    plain = pose_opt._pose_optimize_plain(*args)
    gaps, fails = pose_gaps(args, plain, plain)
    assert fails == [] and gaps["dT"] == 0.0
    assert gaps["flips"] == {"pt_inlier": 0, "ln_inlier": 0, "pl_inlier": 0}
    i = int(torch.nonzero(plain.pt_inlier)[0])
    flipped = plain.pt_inlier.clone()
    flipped[i] = False
    bad = plain._replace(T_cw=plain.T_cw + 1e-3, pt_inlier=flipped,
                         chi2=plain.chi2 * 1.01)
    gaps, fails = pose_gaps(args, bad, plain)
    assert gaps["flips"]["pt_inlier"] == 1
    assert [f.split()[0] for f in fails] == ["|dT|", "pt_inlier:",
                                             "n_inliers", "chi2"], fails


BAD_INPUTS = {
    "dtype": lambda T, o: (T, o._replace(pt_world=o.pt_world.double())),
    "bool_as_float": lambda T, o: (T, o._replace(ln_valid=o.ln_valid.float())),
    "shape": lambda T, o: (T, o._replace(pt_obs=o.pt_obs[:, :2].contiguous())),
    "rows": lambda T, o: (T, o._replace(ln_obs=o.ln_obs[:-1])),
    "non_contiguous": lambda T, o: (
        T, o._replace(pl_world=o.pl_world.t().contiguous().t())),
    "pose": lambda T, o: (T[:3].contiguous(), o),
    "pose_non_contiguous": lambda T, o: (T.t(), o),
}


@pytest.mark.parametrize("bad", sorted(BAD_INPUTS))
def test_input_checks_refuse_before_any_launch(bad):
    T_true, obs = scene(0, n_pts=64, n_ln=4)
    T, obs = BAD_INPUTS[bad](T_true, obs)
    with pytest.raises(ValueError, match="^pose_gn: (?!the kernel)"):
        pose_gn.solve(*_args(T, obs))
    with pytest.raises(ValueError, match="^pose_gn: (?!the kernel)"):
        pose_gn.check_inputs(T, obs)


def test_main_path_observations_pass_the_checks():
    """What `extract_and_track` hands `pose_optimize` on a fixture frame
    (640x480, on the CPU) is what the kernel takes: the checks pass, with
    the preset's capacities."""
    from dr_slam_torch._smoke import load_fixture, shipped_codebooks
    from dr_slam_torch.config import tum_freiburg3
    from dr_slam_torch.slam import track_step as ts

    cfg = tum_freiburg3()
    with shipped_codebooks(), pose_solves() as solves:
        fx = load_fixture("cpu")
        g, d = fx.frames[0]
        ts.extract_and_track(g, d, fx.state, fx.T_last, fx.velocity,
                             fx.R_cm, fx.ref_kf, cfg, device="cpu")
    counts = [pose_gn.check_inputs(*args[:2]) for args in solves]
    assert counts == [{"NP": cfg.orb.max_keypoints, "NL": cfg.line.max_lines,
                       "NF": cfg.plane.max_planes,
                       "NS": cfg.map.max_kf_planes}] * 2
