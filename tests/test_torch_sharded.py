"""The port's multi-device paths (dr_slam_torch/parallel/sharded_ba.py and
sharded_place.py) on a mesh of eight CPU entries, the port's counterpart of
JAX's eight virtual host devices, against the single-device solve and scan
and against the JAX package (tests/test_backend.py's cases).

Tolerances: a one-shard solve is `bundle_adjust` bit for bit (the same
operations in the same order), and two solves of one problem are equal bit
for bit at any CPU thread count (the gathers' derivatives add their rows
in a fixed order, `global_ba._rows`); eight shards sum J^T r and J^T J v in
another order, so the solve moves within 2e-3 (the JAX test's bound); the
port against JAX's `bundle_adjust` within 5e-3, tests/test_torch_ba.py's
bound for multi-step solves. Place-recognition scores and common-word
counts, the candidate lists and ORB's outputs are exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.associate import keyframe_db as jkdb
from dr_slam_tpu.associate.vocabulary import bow_scores as j_bow_scores
from dr_slam_tpu.io.synthetic import SyntheticSequence as JSeq
from dr_slam_tpu.io.synthetic import corridor_trajectory
from dr_slam_tpu.io.synthetic import synthetic_map_state as j_map_state
from dr_slam_tpu.optimize import global_ba as jba
from dr_slam_torch.associate import keyframe_db as tkdb
from dr_slam_torch.associate.vocabulary import bow_scores
from dr_slam_torch.io.synthetic import synthetic_map_state
from dr_slam_torch.ops.orb import extract_orb
from dr_slam_torch.optimize import global_ba as tba
from dr_slam_torch.parallel import sharded_ba, sharded_place

from torch_parity import small_cfg, to_port

K4 = (267.7, 269.6, 160.0, 120.0)
CPU8 = ["cpu"] * 8


def _toy_problem():
    """tests/test_backend.py's toy: 3 fixed keyframes, 32 free points."""
    rng = np.random.RandomState(5)
    NK, NP = 3, 32
    pts = rng.uniform([-1, -1, 2], [1, 1, 4], (NP, 3)).astype(np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (NK, 1, 1))
    for k in range(NK):
        poses[k, 0, 3] = 0.05 * k
    obs_kf = np.repeat(np.arange(NK, dtype=np.int32), NP)
    obs_pt = np.tile(np.arange(NP, dtype=np.int32), NK)
    Xc = np.einsum("mij,mj->mi", poses[obs_kf][:, :3, :3], pts[obs_pt]) \
        + poses[obs_kf][:, :3, 3]
    uv = np.stack([K4[0] * Xc[:, 0] / Xc[:, 2] + K4[2],
                   K4[1] * Xc[:, 1] / Xc[:, 2] + K4[3]], -1).astype(np.float32)
    pts0 = pts + 0.03 * rng.randn(NP, 3).astype(np.float32)
    M = len(obs_kf)
    arrays = dict(kf_pose=poses, pt_pos=pts0, obs_kf=obs_kf, obs_pt=obs_pt,
                  obs_uv=uv, obs_z=np.zeros(M, np.float32),
                  obs_inv_sigma2=np.ones(M, np.float32),
                  obs_valid=np.ones(M, bool), kf_free=np.zeros(NK, bool),
                  pt_free=np.ones(NP, bool))
    jp = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tp = tba.BAProblem(**{k: torch.from_numpy(v).to(torch.int64)
                          if k in ("obs_kf", "obs_pt") else torch.from_numpy(v)
                          for k, v in arrays.items()})
    return jp, tp


def _bits_equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy().view(np.int32),
                                      y.numpy().view(np.int32))


def test_toy_ba_sharded_matches_single_and_jax():
    jp, tp = _toy_problem()
    kw = dict(n_gn_iters=3, n_cg_iters=15)
    T1, X1 = tba.bundle_adjust(tp, K4, **kw)
    mesh = sharded_ba.make_mesh(8, axis="obs", devices=CPU8)
    T8, X8 = sharded_ba.sharded_bundle_adjust(tp, K4, mesh, **kw)
    np.testing.assert_allclose(X8.numpy(), X1.numpy(), rtol=0, atol=2e-3)
    np.testing.assert_allclose(T8.numpy(), T1.numpy(), rtol=0, atol=2e-3)
    Tj, Xj = jba.bundle_adjust(jp, K4, **kw)
    np.testing.assert_allclose(X8.numpy(), np.asarray(Xj), rtol=0, atol=5e-3)
    moved = float(np.abs(X1.numpy() - tp.pt_pos.numpy()).max())
    assert moved > 0.01
    one = sharded_ba.make_mesh(devices=["cpu"])
    _bits_equal(sharded_ba.sharded_bundle_adjust(tp, K4, one, **kw),
                (T1, X1))


@pytest.fixture(scope="module")
def realistic():
    """24 keyframes of synthetic_map_state at the small config, struct
    blocks included, in both packages."""
    jcfg = small_cfg()
    tcfg = to_port(jcfg)
    jst, poses_true = j_map_state(jcfg, n_kfs=24, seed=3)
    tst, _ = synthetic_map_state(tcfg, n_kfs=24, seed=3, device="cpu")
    return jst, tst, poses_true


def test_realistic_map_sharded_matches_single_and_jax(realistic):
    jst, tst, poses_true = realistic
    tp = tba.problem_from_state(tst)
    assert int(tp.obs_valid.sum()) > 5000 and tp.struct is not None
    kw = dict(n_gn_iters=2, n_cg_iters=8)
    out1 = tba.bundle_adjust(tp, K4, **kw)
    mesh = sharded_ba.make_mesh(8, axis="obs", devices=CPU8)
    shards = sharded_ba.shard_problem(tp, mesh)
    assert len(shards) == 8
    assert sum(int(q.obs_valid.sum()) for q in shards) == int(tp.obs_valid.sum())
    out8 = sharded_ba.sharded_bundle_adjust(tp, K4, mesh, **kw)
    outj = jba.bundle_adjust(jba.problem_from_state(jst), K4, **kw)
    for name, a, b, j in zip(("kf_pose", "pt_pos", "pl_coef", "ln_ep"),
                             out1, out8, outj):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=2e-3,
                                   err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(j), rtol=0,
                                   atol=5e-3, err_msg=name)
    e0 = np.linalg.norm(tst.kf_pose[:24, :3, 3].numpy()
                        - poses_true[:, :3, 3], axis=1).mean()
    e1 = np.linalg.norm(out8[0][:24, :3, 3].numpy()
                        - poses_true[:, :3, 3], axis=1).mean()
    assert e1 < 0.7 * e0, (e0, e1)
    one = sharded_ba.make_mesh(devices=["cpu"])
    _bits_equal(sharded_ba.sharded_bundle_adjust(tp, K4, one, **kw), out1)


@pytest.fixture
def threads():
    """torch.set_num_threads for one test, the old count restored after it
    (a count set when a module is imported does not hold at run time: under
    pytest-xdist every worker imports every module first)."""
    old = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(old)


@pytest.mark.parametrize("n_threads", [1, 2, 4, 8])
def test_bundle_adjust_run_to_run_bit_equal(realistic, threads, n_threads):
    threads(n_threads)
    tp = tba.problem_from_state(realistic[1])
    kw = dict(n_gn_iters=2, n_cg_iters=8)
    _bits_equal(tba.bundle_adjust(tp, K4, **kw),
                tba.bundle_adjust(tp, K4, **kw))


def _bows(seed, NK, W, sparsity):
    rng = np.random.RandomState(seed)
    kf_bows = rng.rand(NK, W).astype(np.float32)
    kf_bows[rng.rand(NK, W) < sparsity] = 0.0
    kf_bows /= np.maximum(kf_bows.sum(1, keepdims=True), 1e-6)
    return rng, kf_bows


def test_sharded_place_scores_exact():
    """NK = 203 does not divide by 8: the last block is shorter."""
    rng, kf_bows = _bows(5, 203, 256, 0.85)
    kf_valid = rng.rand(203) < 0.8
    bow = kf_bows[17] * 0.7 + kf_bows[90] * 0.3
    mesh = sharded_ba.make_mesh(8, axis="kf", devices=CPU8)
    sharded = sharded_place.shard_keyframe_bows(
        torch.from_numpy(kf_bows), torch.from_numpy(kf_valid), mesh, axis="kf")
    assert len(sharded[0]) == 8 and sharded[1] == 203
    s8, c8 = sharded_place.sharded_place_scores(torch.from_numpy(bow),
                                                sharded, mesh)
    tb, tv, tq = (torch.from_numpy(x) for x in (kf_bows, kf_valid, bow))
    s1 = bow_scores(tq, tb, tv)
    c1 = tkdb.common_word_counts(tq, tb, tv)
    np.testing.assert_array_equal(s8.numpy(), s1.numpy())
    np.testing.assert_array_equal(c8.numpy(), c1.numpy())
    sj = np.asarray(j_bow_scores(jnp.asarray(bow), jnp.asarray(kf_bows),
                                 jnp.asarray(kf_valid)))
    cj = np.asarray(jkdb.common_word_counts(
        jnp.asarray(bow), jnp.asarray(kf_bows), jnp.asarray(kf_valid)))
    np.testing.assert_array_equal(c8.numpy(), cj)
    np.testing.assert_allclose(s8.numpy(), sj, rtol=0, atol=1e-6)
    order = np.argsort(-s8.numpy())
    assert 17 in order[:3] or 90 in order[:3]


def test_sharded_place_scores_drive_group_candidates():
    rng, kf_bows = _bows(11, 96, 256, 0.8)
    kf_valid = rng.rand(96) < 0.9
    covis = rng.randint(0, 40, (96, 96))
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    allowed = kf_valid & (np.arange(96) < 92)
    bow = kf_bows[40] * 0.6 + kf_bows[41] * 0.4
    mesh = sharded_ba.make_mesh(8, axis="kf", devices=CPU8)
    sharded = sharded_place.shard_keyframe_bows(
        torch.from_numpy(kf_bows), torch.from_numpy(kf_valid), mesh, axis="kf")
    s8, c8 = sharded_place.sharded_place_scores(torch.from_numpy(bow),
                                                sharded, mesh)
    reps8 = tkdb.group_candidates(s8.numpy(), c8.numpy(), covis, allowed,
                                  min_score=0.01)
    sj = j_bow_scores(jnp.asarray(bow), jnp.asarray(kf_bows),
                      jnp.asarray(kf_valid))
    cj = jkdb.common_word_counts(jnp.asarray(bow), jnp.asarray(kf_bows),
                                 jnp.asarray(kf_valid))
    repsj = jkdb.group_candidates(np.asarray(sj), np.asarray(cj), covis,
                                  allowed, min_score=0.01)
    assert list(reps8) == list(repsj) and len(reps8) > 0
    assert 40 in reps8 or 41 in reps8


def test_batched_frontend_equals_per_frame():
    seq = JSeq(corridor_trajectory(5), K4=K4, height=240, width=320)
    imgs = np.stack([np.asarray(seq.render(i)[0]) for i in range(5)])
    kw = dict(n_features=400, n_levels=4, max_keypoints=512)
    mesh = sharded_ba.make_mesh(4, axis="data", devices=["cpu"] * 4)
    uv, desc, valid = sharded_ba.batched_frontend(torch.from_numpy(imgs),
                                                  mesh, **kw)
    assert uv.shape == (5, 512, 2) and desc.shape == (5, 512, 8)
    for i in range(5):
        kp = extract_orb(torch.from_numpy(imgs[i]), **kw)
        np.testing.assert_array_equal(uv[i].numpy(), kp.uv.numpy())
        np.testing.assert_array_equal(desc[i].numpy(), kp.desc.numpy())
        np.testing.assert_array_equal(valid[i].numpy(), kp.valid.numpy())
    assert int(valid.sum()) > 1000


def test_make_mesh_raises():
    with pytest.raises(ValueError, match="requested 9 devices"):
        sharded_ba.make_mesh(9, devices=CPU8)
    mesh = sharded_ba.make_mesh(devices=CPU8, axis="kf")
    assert mesh.shape["kf"] == 8 and mesh.axis_names == ("kf",)
    if torch.cuda.is_available():
        assert len(sharded_ba.make_mesh().devices) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharded_ba.make_mesh()
