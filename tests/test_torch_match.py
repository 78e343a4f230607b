"""Parity of the port's matcher module and per-frame map association with
the JAX package (dr_slam_torch/ops/match_cuda.py, slam/map_ops.py).

The plain version of the gated top-2 Hamming matcher must equal, bit for
bit, both the Pallas kernel in interpret mode and the JAX scan path,
including on equal-distance ties built across tiles and chunks. Integer
outputs of the association functions must match exactly; floats (plane
world coefficients) within 1e-5, float32 rounding of a 4x4 product."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dr_slam_tpu.config import (CameraConfig, LineConfig, MapConfig,
                                ORBConfig, SlamConfig)
from dr_slam_tpu.ops.match_pallas import gated_top2_hamming as jax_pallas
from dr_slam_tpu.ops.orb import bits_to_signs, unpack_bits
from dr_slam_tpu.slam import map_ops as jmap
from dr_slam_torch.ops import match_cuda
from dr_slam_torch.slam import map_ops as tmap

torch.set_num_threads(2)


def matcher_inputs(K, NC, seed, n_ties=16):
    """Keypoints and candidates with realistic gating plus ties: pairs of
    candidates in different 512-wide tiles (and 4096-wide scan chunks) with
    the same descriptor and position as a keypoint, and duplicated
    keypoints that tie on a column."""
    rng = np.random.RandomState(seed)
    kp_desc = rng.randint(0, 2 ** 32, (K, 8), dtype=np.uint64).astype(np.uint32)
    kp_uv = np.stack([rng.uniform(0, 320, K), rng.uniform(0, 240, K)],
                     1).astype(np.float32)
    kp_valid = rng.rand(K) < 0.9
    kp_oct = rng.randint(0, 4, K).astype(np.int32)
    src = rng.randint(0, K, NC)
    flips = rng.rand(NC, 8, 32) < 0.08
    words = (flips * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1)
    pt_desc = kp_desc[src] ^ words.astype(np.uint32)
    pt_uv = (kp_uv[src] + rng.normal(0, 4, (NC, 2))).astype(np.float32)
    pt_rad = (12.0 * 1.2 ** rng.randint(0, 3, NC)).astype(np.float32)
    pt_lvl = kp_oct[src] + rng.randint(-2, 3, NC).astype(np.int32)
    pt_si = rng.rand(NC) < 0.8
    pt_valid = rng.rand(NC) < 0.6
    pt_valid[NC // 2:NC // 2 + 512] = False          # one dead tile
    for _ in range(n_ties):
        k = rng.randint(0, K)
        kp_valid[k] = True
        for c in (rng.randint(0, 512), rng.randint(NC - 512, NC)):
            pt_desc[c], pt_uv[c], pt_lvl[c] = kp_desc[k], kp_uv[k], kp_oct[k]
            pt_valid[c] = True
    for _ in range(n_ties):
        k1, k2 = sorted(rng.choice(K, 2, replace=False))
        kp_desc[k2], kp_uv[k2] = kp_desc[k1], kp_uv[k1]
        kp_oct[k2], kp_valid[k2] = kp_oct[k1], kp_valid[k1]
    return (kp_desc, kp_uv, kp_valid, kp_oct, pt_desc, pt_uv, pt_rad, pt_lvl,
            pt_si, pt_valid)


def torch_args(a):
    (kp_desc, kp_uv, kp_valid, kp_oct, pt_desc, pt_uv, pt_rad, pt_lvl, pt_si,
     pt_valid) = a
    t = torch.from_numpy
    return (t(kp_desc.view(np.int32)), t(kp_uv), t(kp_valid), t(kp_oct),
            t(pt_desc.view(np.int32)), t(pt_uv), t(pt_rad), t(pt_lvl),
            t(pt_si), t(pt_valid))


def assert_same(port, ref):
    for name, a, b in zip(("best", "idx", "second", "colk"), port, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("K,NC,seed", [(64, 1024, 0), (64, 1024, 1),
                                       (64, 9216, 2)])
def test_plain_matcher_bit_exact_vs_jax(K, NC, seed):
    a = matcher_inputs(K, NC, seed)
    (kp_desc, kp_uv, kp_valid, kp_oct, pt_desc, pt_uv, pt_rad, pt_lvl, pt_si,
     pt_valid) = a
    before = match_cuda.gated_top2_hamming.launches
    port = match_cuda.gated_top2_hamming(*torch_args(a))
    # CPU tensors take the plain version and launch nothing
    assert match_cuda.gated_top2_hamming.launches == before
    assert_same(port, match_cuda.gated_top2_hamming_ref(*torch_args(a)))

    pallas = jax_pallas(
        bits_to_signs(unpack_bits(jnp.asarray(kp_desc))), jnp.asarray(kp_uv),
        jnp.asarray(kp_valid), jnp.asarray(kp_oct),
        bits_to_signs(unpack_bits(jnp.asarray(pt_desc))), jnp.asarray(pt_uv),
        jnp.asarray(pt_rad), jnp.asarray(pt_lvl), jnp.asarray(pt_si),
        jnp.asarray(pt_valid), interpret=True)
    assert_same(port, pallas)

    best, best_pt, second, pbest_k, _, _ = jmap._match_scan_path(
        jnp.asarray(kp_desc), jnp.asarray(kp_uv), jnp.asarray(kp_valid),
        jnp.asarray(kp_oct), jnp.asarray(pt_desc), jnp.zeros(NC),
        jnp.asarray(pt_uv), jnp.asarray(pt_rad), jnp.asarray(pt_lvl),
        jnp.asarray(pt_si), jnp.asarray(pt_valid), NC)
    assert_same(port, (best, best_pt, second, pbest_k))
    # the ties were hit: some rows have best == second
    b, s = port[0].numpy(), port[2].numpy()
    assert np.any(np.isfinite(b) & (b == s))


def test_matcher_rejects_unpadded_candidates():
    a = torch_args(matcher_inputs(8, 1024, 3))
    a = a[:4] + tuple(x[:1000] for x in a[4:])
    with pytest.raises(ValueError):
        match_cuda.gated_top2_hamming(*a)


# --- per-frame association on a synthetic map -------------------------------

def small_cfg():
    return SlamConfig(
        camera=CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                            width=320, height=240, bf=20.0),
        orb=ORBConfig(n_features=400, n_levels=4, max_keypoints=256),
        line=LineConfig(max_lines=8),
        map=MapConfig(max_points=8192, max_lines=16, max_planes=8,
                      max_keyframes=64, vocab_words=64))


@pytest.fixture(scope="module")
def scene():
    """The map and query of test_map_ops' candidate-compaction test: a
    48-keyframe synthetic room with descriptors, angles and scale bounds."""
    from dr_slam_tpu.io.synthetic import synthetic_map_state
    from dr_slam_torch.io.map_io import from_jax_state

    cfg = small_cfg()
    st, poses = synthetic_map_state(cfg, n_kfs=48, seed=7)
    rng = np.random.RandomState(0)
    NP = cfg.map.max_points
    d0 = jnp.linalg.norm(st.pt_pos @ jnp.asarray(poses[0][:3, :3]).T
                         + jnp.asarray(poses[0][:3, 3]), axis=1)
    pt_desc = rng.randint(0, 2 ** 32, (NP, 8), dtype=np.uint32)
    st = st._replace(
        pt_desc=jnp.asarray(pt_desc),
        # keyframe rows describe the points they observe
        kf_desc=jnp.asarray(pt_desc[np.clip(np.asarray(st.kf_mp), 0, None)]),
        pt_angle=jnp.asarray(rng.uniform(0, 2 * np.pi, NP), jnp.float32),
        pt_dist_min=(d0 / 1.2 ** 3).astype(jnp.float32),
        pt_dist_max=d0.astype(jnp.float32),
        pt_normal=st.pt_pos / jnp.maximum(
            jnp.linalg.norm(st.pt_pos, axis=1, keepdims=True), 1e-6))
    ids = jnp.clip(st.kf_mp[0], 0)
    q = dict(kp_uv=st.kf_uv[0] + 0.5, kp_valid=st.kf_kp_valid[0],
             kp_desc=st.pt_desc[ids], kp_angle=st.pt_angle[ids],
             kp_octave=jnp.zeros((cfg.orb.max_keypoints,), jnp.int32))
    tst = from_jax_state({k: np.asarray(v) for k, v in st._asdict().items()},
                         "cpu")
    tq = {k: torch.from_numpy(np.array(v).view(np.int32) if k == "kp_desc"
                              else np.array(v)) for k, v in q.items()}
    return cfg, st, tst, q, tq, np.asarray(poses[0], np.float32)


@pytest.mark.parametrize("max_candidates", [0, 2048])
def test_match_points_projection_matches_jax(scene, max_candidates):
    cfg, st, tst, q, tq, T = scene
    kw = dict(radius=12.0, width=320, height=240, pt_scale=1.2, n_levels=4,
              max_candidates=max_candidates)
    ref = jmap.match_points_projection(
        st, q["kp_uv"], q["kp_desc"], q["kp_valid"], jnp.asarray(T),
        cfg.camera.K4, kp_angle=q["kp_angle"], kp_octave=q["kp_octave"], **kw)
    out = tmap.match_points_projection(
        tst, tq["kp_uv"], tq["kp_desc"], tq["kp_valid"], torch.from_numpy(T),
        cfg.camera.K4, kp_angle=tq["kp_angle"], kp_octave=tq["kp_octave"], **kw)
    assert int(ref.n_matches) > 50
    np.testing.assert_array_equal(out.mp_idx.numpy(), np.asarray(ref.mp_idx))
    np.testing.assert_array_equal(out.visible.numpy(), np.asarray(ref.visible))
    assert int(out.n_matches) == int(ref.n_matches)


def test_rotation_consistency_matches_jax():
    rng = np.random.RandomState(4)
    ok = rng.rand(300) < 0.7
    dangle = rng.normal(0.3, 0.4, 300).astype(np.float32)
    dangle[:40] = rng.uniform(-7, 7, 40)
    ref = jmap.rotation_consistency(jnp.asarray(ok), jnp.asarray(dangle))
    out = tmap.rotation_consistency(torch.from_numpy(ok), torch.from_numpy(dangle))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_reference_kf_match_matches_jax(scene):
    cfg, st, tst, q, tq, T = scene
    kf = 3
    rng = np.random.RandomState(5)
    # a query that sees keyframe 3's features with some bits flipped
    kdesc = np.asarray(st.kf_desc[kf])
    flips = (rng.rand(*kdesc.shape, 32) < 0.03)
    words = (flips * (np.uint64(1) << np.arange(32, dtype=np.uint64))).sum(-1)
    qdesc = kdesc ^ words.astype(np.uint32)
    valid = np.asarray(st.kf_kp_valid[kf])
    kpw = rng.randint(0, 4, len(valid)).astype(np.int32)
    kfw = kpw.copy()
    kfw[::7] = 5
    ref = jmap.match_reference_kf(st, kf, jnp.asarray(qdesc), jnp.asarray(valid),
                                  kp_word=jnp.asarray(kpw),
                                  kf_word=jnp.asarray(kfw))
    out = tmap.match_reference_kf(tst, torch.tensor(kf),
                                  torch.from_numpy(qdesc.view(np.int32)),
                                  torch.from_numpy(valid),
                                  kp_word=torch.from_numpy(kpw),
                                  kf_word=torch.from_numpy(kfw))
    assert int(ref.n_matches) > 20
    np.testing.assert_array_equal(out.mp_idx.numpy(), np.asarray(ref.mp_idx))


def test_planes_lines_obs_and_stats_match_jax(scene):
    """match_planes, match_lines_projection, build_pose_obs and
    update_point_stats on keyframe 0's observations."""
    from dr_slam_tpu.frontend.frame import FrameFeatures as JF
    from dr_slam_tpu.ops.lines import LineFeatures as JL
    from dr_slam_tpu.ops.orb import Keypoints as JK
    from dr_slam_tpu.ops.planes import PlaneSegmentation as JP
    from dr_slam_torch.frontend.frame import FrameFeatures as TF
    from dr_slam_torch.ops.lines import LineFeatures as TL
    from dr_slam_torch.ops.orb import Keypoints as TK
    from dr_slam_torch.ops.planes import PlaneSegmentation as TP

    cfg, st, tst, q, tq, T = scene
    rng = np.random.RandomState(6)
    Tj, Tt = jnp.asarray(T), torch.from_numpy(T)
    # observed planes: the map planes seen from keyframe 0, slightly noisy
    P = 8
    coef = np.asarray(st.pl_coef)[:P] @ np.linalg.inv(T)
    coef = coef / np.linalg.norm(coef[:, :3], axis=1, keepdims=True)
    coef = (coef + rng.normal(0, 1e-3, coef.shape)).astype(np.float32)
    pvalid = np.asarray(st.pl_valid)[:P] | (rng.rand(P) < 0.5)
    ref_p = jmap.match_planes(st, jnp.asarray(coef), jnp.asarray(pvalid), Tj)
    out_p = tmap.match_planes(tst, torch.from_numpy(coef),
                              torch.from_numpy(pvalid), Tt)
    for f in ("match_idx", "par_idx", "ver_idx"):
        np.testing.assert_array_equal(getattr(out_p, f).numpy(),
                                      np.asarray(getattr(ref_p, f)), err_msg=f)
    np.testing.assert_allclose(out_p.obs_world.numpy(),
                               np.asarray(ref_p.obs_world), atol=1e-5)

    # observed lines: projected map-line midpoints with the map descriptors
    L = 8
    ep = np.asarray(st.ln_ep)[:L]
    uv = [np.asarray(jnp.stack([x[:, 0] / x[:, 2] * 267.7 + 160.0,
                                x[:, 1] / x[:, 2] * 269.6 + 120.0], -1))
          for x in (ep[:, :3] @ T[:3, :3].T + T[:3, 3],
                    ep[:, 3:] @ T[:3, :3].T + T[:3, 3])]
    seg = np.concatenate(uv, -1).astype(np.float32)
    ldesc = np.asarray(st.ln_desc)[:L]
    lvalid = np.ones(L, bool)
    ref_l = jmap.match_lines_projection(st, jnp.asarray(seg), jnp.asarray(ldesc),
                                        jnp.asarray(lvalid), Tj, cfg.camera.K4,
                                        width=320, height=240)
    out_l = tmap.match_lines_projection(tst, torch.from_numpy(seg),
                                        torch.from_numpy(ldesc.view(np.int32)),
                                        torch.from_numpy(lvalid), Tt,
                                        cfg.camera.K4, width=320, height=240)
    np.testing.assert_array_equal(out_l.ml_idx.numpy(), np.asarray(ref_l.ml_idx))

    # pose observations and point statistics
    K = cfg.orb.max_keypoints
    kp = dict(uv=np.asarray(q["kp_uv"]), response=np.ones(K, np.float32),
              angle=np.asarray(q["kp_angle"]), octave=np.zeros(K, np.int32),
              valid=np.asarray(q["kp_valid"]), desc=np.asarray(q["kp_desc"]),
              sigma2=np.full(K, 1.44, np.float32))
    lf = dict(seg2d=seg, lineq=rng.normal(size=(L, 3)).astype(np.float32),
              desc=ldesc, dir3d=np.zeros((L, 3), np.float32),
              ep3d=np.zeros((L, 6), np.float32), has3d=lvalid, valid=lvalid,
              response=np.ones(L, np.float32), man_dir=np.zeros((L, 3), np.float32),
              man_ok=lvalid)
    pl = dict(coeffs=coef, valid=pvalid, n_blocks=np.ones(P, np.int32),
              cloud=np.zeros((P, 4, 3), np.float32),
              cloud_valid=np.zeros((P, 4), bool), mse=np.zeros(P, np.float32),
              block_label=np.zeros((2, 2), np.int32))
    extra = dict(kp_depth=np.ones(K, np.float32),
                 kp_ur=np.where(rng.rand(K) < 0.5, 100.0, -1.0).astype(np.float32),
                 kp_xyz=np.zeros((K, 3), np.float32),
                 normals=np.zeros((4, 3), np.float32),
                 normals_valid=np.zeros(4, bool))

    def to_t(d):
        return {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32
                                    else v) for k, v in d.items()}

    jfeat = JF(kp=JK(**{k: jnp.asarray(v) for k, v in kp.items()}),
               planes=JP(**{k: jnp.asarray(v) for k, v in pl.items()}),
               lines=JL(**{k: jnp.asarray(v) for k, v in lf.items()}),
               **{k: jnp.asarray(v) for k, v in extra.items()})
    tfeat = TF(kp=TK(**to_t(kp)), planes=TP(**to_t(pl)), lines=TL(**to_t(lf)),
               **to_t(extra))
    mp = np.asarray(jmap.match_points_projection(
        st, q["kp_uv"], q["kp_desc"], q["kp_valid"], Tj, cfg.camera.K4,
        radius=12.0, width=320, height=240).mp_idx)
    ref_o = jmap.build_pose_obs(st, jfeat, jnp.asarray(mp), ref_p,
                                ref_l.ml_idx, n_struct=16)
    out_o = tmap.build_pose_obs(tst, tfeat, torch.from_numpy(mp), out_p,
                                out_l.ml_idx, n_struct=16)
    for f in ref_o._fields:
        a, b = np.asarray(getattr(ref_o, f)), getattr(out_o, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype == np.bool_:
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, atol=1e-5, err_msg=f)

    vis = np.asarray(st.pt_valid)
    ref_s = jmap.update_point_stats(st, jnp.asarray(vis), jnp.asarray(mp))
    out_s = tmap.update_point_stats(tst, torch.from_numpy(vis),
                                    torch.from_numpy(mp))
    for f in ("pt_visible", "pt_found"):
        np.testing.assert_array_equal(getattr(out_s, f).numpy(),
                                      np.asarray(getattr(ref_s, f)))
