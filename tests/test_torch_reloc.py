"""Relocalization: its solvers and candidate selection against the JAX
package on seeded numpy inputs, then the reference's localization scenario
(tests/test_localization_mode.py) and the young-map reset through both
`System`s at the small config.

- Horn alignment and Sim3-RANSAC: inlier counts exact, poses within 1e-4
  (observed 6e-8). PnP-RANSAC on non-planar and on coplanar points: the
  same winning hypothesis and inlier count, poses within 1e-2 of each other
  (observed 3.7e-3 and 1e-5): a noisy 6-point DLT sample is ill-conditioned,
  and LAPACK's and XLA's 12x12 eigenvectors differ by that much. The
  relocalization refines that pose with pose_optimize, after which the two
  agree within 2e-3 (below).
- Shared-word counts, group candidates and mutual best matches (with ties)
  exact; BoW scores within 1e-6 (float32 sums of 512 terms in another
  order). Where scores tie within that, the candidate order could differ;
  on these inputs it does not. Sign-form Hamming tables exact. A codebook
  registered with `set_vocabulary` or `load_vocabulary` replaces the
  cached one, and word ids then equal the JAX package's.
- Localization: the JAX System builds an 18-frame map and saves it; a fresh
  System of each package loads it (LOST), switches to localization mode and
  takes frames 14-25. Per frame the states, reference keyframes and counts
  are equal and T_cw agrees within 2e-3; both maps stay bit-identical.
- Young-map reset: both load the 3-keyframe map of frame 21 and take black
  frames; the third failed relocalization resets both to NOT_INITIALIZED,
  and the next frame initializes a new map in both.
After each frame the JAX side waits for its pending bundles, so the
deferred decision lags by exactly one frame in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.associate import keyframe_db as jkdb
from dr_slam_tpu.associate.vocabulary import bow_scores as jbow_scores
from dr_slam_tpu.io import synthetic
from dr_slam_tpu.ops.hamming import mutual_best_matches as jmutual
from dr_slam_tpu.optimize import pnp as jpnp
from dr_slam_tpu.optimize import sim3 as jsim3
from dr_slam_torch._smoke import map_fingerprint
from dr_slam_torch.associate import keyframe_db as tkdb
from dr_slam_torch.associate.vocabulary import bow_scores as tbow_scores
from dr_slam_torch.ops.hamming import mutual_best_matches as tmutual
from dr_slam_torch.optimize import pnp as tpnp
from dr_slam_torch.optimize import sim3 as tsim3
from dr_slam_torch.slam.system import System as TSystem

from torch_parity import small_cfg, to_port, wait_pending

torch.set_num_threads(2)

T_TOL = 2e-3
K4 = (267.7, 269.6, 160.0, 120.0)


def _rot(ax: int, ang: float) -> np.ndarray:
    c, s = np.cos(ang), np.sin(ang)
    i, j = [k for k in range(3) if k != ax]
    R = np.eye(3)
    R[i, i], R[i, j], R[j, i], R[j, j] = c, -s, s, c
    return R


def _pair_cloud(seed: int, n: int = 200, outliers: int = 40):
    rng = np.random.RandomState(seed)
    a = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    R = _rot(1, 0.3) @ _rot(0, -0.2)
    b = a @ R.T + np.array([0.1, 0.2, 0.3]) + rng.normal(0, 0.01, (n, 3))
    b[:outliers] += rng.normal(0, 0.5, (outliers, 3))
    return a, b.astype(np.float32), rng.rand(n) < 0.9


def test_horn_align_matches():
    rng = np.random.RandomState(1)
    a = rng.normal(size=(5, 30, 3)).astype(np.float32)
    b = (np.einsum("ij,hnj->hni", _rot(2, 0.7), a) * 1.3 + 0.4
         + rng.normal(0, 0.02, a.shape)).astype(np.float32)
    w = rng.rand(5, 30).astype(np.float32)
    for with_scale in (False, True):
        Rj, tj, sj = jsim3.horn_align(jnp.asarray(a), jnp.asarray(b),
                                      jnp.asarray(w), with_scale)
        Rt, tt, st = tsim3.horn_align(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(w), with_scale)
        for x, y in ((Rj, Rt), (tj, tt), (sj, st)):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim3_ransac_matches(seed):
    a, b, valid = _pair_cloud(seed)
    Tj, sj, nj = jsim3.sim3_ransac(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(valid))
    Tt, st, nt = tsim3.sim3_ransac(torch.from_numpy(a), torch.from_numpy(b),
                                   torch.from_numpy(valid))
    assert int(nt) == int(nj) > 100
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-4)
    assert float(st) == float(sj) == 1.0


def _pnp_inputs(seed: int, planar: bool):
    rng = np.random.RandomState(seed)
    n = 200
    R = _rot(1, 0.3) @ _rot(0, 0.1)
    t = np.array([0.1, -0.05, 0.2])
    pw = rng.uniform(-1, 1, (n, 3))
    pw[:, 2] = 3.0 if planar else pw[:, 2] + 3.0
    pc = pw @ R.T + t
    uv = np.stack([K4[0] * pc[:, 0] / pc[:, 2] + K4[2],
                   K4[1] * pc[:, 1] / pc[:, 2] + K4[3]], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    # outliers at least 10 px off, inliers within ~2 px: no count sits at
    # the 4 px threshold, where the eigensolvers' rounding could move it
    uv[:30] += rng.choice([-1, 1], (30, 2)) * rng.uniform(10, 40, (30, 2))
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return (pw.astype(np.float32), uv.astype(np.float32), rng.rand(n) < 0.9,
            T)


@pytest.mark.parametrize("planar", [False, True], ids=["general", "coplanar"])
def test_pnp_ransac_matches(planar):
    pw, uv, valid, T_true = _pnp_inputs(3, planar)
    Tj, nj = jpnp.pnp_ransac(jnp.asarray(pw), jnp.asarray(uv),
                             jnp.asarray(valid), K4)
    Tt, nt = tpnp.pnp_ransac(torch.from_numpy(pw), torch.from_numpy(uv),
                             torch.from_numpy(valid), K4)
    assert int(nt) == int(nj) > 120
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), rtol=0, atol=1e-2)
    assert np.abs(Tt.numpy() - T_true).max() < 0.1


def test_bow_candidates_match():
    rng = np.random.RandomState(5)
    NK, W = 32, 512
    kf_bows = np.where(rng.rand(NK, W) < 0.15, rng.rand(NK, W), 0.0)
    kf_bows = (kf_bows / kf_bows.sum(1, keepdims=True)).astype(np.float32)
    bow = kf_bows[7] * (rng.rand(W) < 0.6)
    bow = (bow / bow.sum()).astype(np.float32)
    kf_valid = rng.rand(NK) < 0.85
    covis = rng.randint(0, 60, (NK, NK))
    covis = np.triu(covis, 1) + np.triu(covis, 1).T
    sj = np.asarray(jbow_scores(jnp.asarray(bow), jnp.asarray(kf_bows),
                                jnp.asarray(kf_valid)))
    st = tbow_scores(torch.from_numpy(bow), torch.from_numpy(kf_bows),
                     torch.from_numpy(kf_valid)).numpy()
    np.testing.assert_allclose(st, sj, rtol=0, atol=1e-6)
    cj = np.asarray(jkdb.common_word_counts(
        jnp.asarray(bow), jnp.asarray(kf_bows), jnp.asarray(kf_valid)))
    ct = tkdb.common_word_counts(torch.from_numpy(bow),
                                 torch.from_numpy(kf_bows),
                                 torch.from_numpy(kf_valid)).numpy()
    np.testing.assert_array_equal(ct, cj)
    for min_score, allowed in ((0.0, kf_valid), (0.05, kf_valid & (covis[7] < 30))):
        want = jkdb.group_candidates(sj, cj, covis, allowed, min_score=min_score)
        got = tkdb.group_candidates(st, ct, covis, allowed, min_score=min_score)
        assert got == want and len(got) > 0


def test_mutual_best_matches_with_ties():
    rng = np.random.RandomState(6)
    D = rng.randint(0, 40, (64, 80)).astype(np.float32)
    D[rng.rand(64, 80) < 0.2] = np.inf
    D[5, :] = np.inf                       # a row with nothing
    D[9, 3] = D[9, 17] = 0.0               # a row tie
    D[11, 3] = D[12, 3] = 0.0              # a column tie
    for ratio in (None, 0.8):
        mj, dj = jmutual(jnp.asarray(D), max_dist=30.0, ratio=ratio)
        mt, dt = tmutual(torch.from_numpy(D), max_dist=30.0, ratio=ratio)
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
        np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_hamming_matrix_signs_matches():
    from dr_slam_tpu.ops.hamming import hamming_matrix_signs as jham
    from dr_slam_torch.ops.hamming import hamming_matrix_signs as tham

    rng = np.random.RandomState(7)
    a = np.where(rng.rand(50, 256) < 0.5, -1.0, 1.0).astype(np.float32)
    b = np.where(rng.rand(70, 256) < 0.5, -1.0, 1.0).astype(np.float32)
    np.testing.assert_array_equal(
        tham(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jham(jnp.asarray(a), jnp.asarray(b))))


def test_vocabulary_registry_replaces_cached_codebooks(tmp_path):
    """A codebook registered with `set_vocabulary`, or read from a file
    by `load_vocabulary`, replaces the one already cached for its word
    count (the signs and the device copy behind `word_ids`); word ids then
    equal the JAX package's under the same registration. Done at 64 words,
    a count no configuration uses."""
    from dr_slam_tpu.associate import vocabulary as jvoc
    from dr_slam_torch.associate import vocabulary as tvoc

    rng = np.random.RandomState(8)
    W = 64
    desc = rng.randint(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(
        np.uint32)
    try:
        before = tvoc.word_ids(torch.from_numpy(desc.view(np.int32)), W)
        np.testing.assert_array_equal(tvoc.get_codebook_signs(W),
                                      jvoc.get_codebook_signs(W))
        for seed in (1, 2):
            words = np.random.RandomState(seed).randint(
                0, 2 ** 32, (W, 8), dtype=np.uint64).astype(np.uint32)
            if seed == 1:
                tvoc.set_vocabulary(words)
                jvoc.set_vocabulary(words)
            else:
                np.savez(tmp_path / "words.npz", words=words)
                tvoc.load_vocabulary(str(tmp_path / "words.npz"))
                jvoc.load_vocabulary(str(tmp_path / "words.npz"))
            np.testing.assert_array_equal(tvoc.get_codebook_signs(W),
                                          jvoc.get_codebook_signs(W))
            got = tvoc.word_ids(torch.from_numpy(desc.view(np.int32)), W)
            np.testing.assert_array_equal(
                got.numpy(), np.asarray(jvoc.word_ids(jnp.asarray(desc), W)))
            assert not torch.equal(got, before)
            before = got
    finally:
        tvoc._trained_signs.pop(W, None)
        jvoc._trained_signs.pop(W, None)
        tvoc.get_codebook_signs.cache_clear()
        tvoc._codebook.cache_clear()


# --- the localization scenario and the young-map reset -------------------

@pytest.fixture(scope="module")
def maps(tmp_path_factory):
    """The JAX System's map after frames 0-17 (2 keyframes) and after 0-20
    (3 keyframes), saved."""
    from dr_slam_tpu.slam.system import System

    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(30, step=0.03), K4=cfg.camera.K4,
        height=240, width=320)
    frames = [tuple(np.asarray(x, np.float32) for x in seq.render(i))
              for i in range(30)]
    out = tmp_path_factory.mktemp("relocmap")
    sysm = System(cfg, enable_loop_closing=False)
    paths = {}
    for i in range(21):
        sysm.track_rgbd(*frames[i], i / 30.0)
        wait_pending(sysm)
        if i + 1 in (18, 21):
            sysm.tracker.flush()
            paths[i + 1] = str(out / f"map{i + 1}.npz")
            sysm.save_map(paths[i + 1])
    return cfg, frames, paths


def test_localization_in_both(maps):
    from dr_slam_tpu.slam.system import System

    cfg, frames, paths = maps
    js = System(cfg, enable_loop_closing=False)
    ts = TSystem(to_port(cfg), enable_loop_closing=False, device="cpu")
    fps = []
    for s in (js, ts):
        s.load_map(paths[18])
        s.activate_localization_mode()
        assert s.track_state.name == "LOST"
    fps.append((map_fingerprint(ts.tracker.map_state),
                {k: np.asarray(v).sum() for k, v in
                 js.tracker.map_state._asdict().items()}))
    got, want = [], []
    for i in range(14, 26):
        jr = js.track_rgbd(*frames[i], i / 30.0)
        wait_pending(js)
        tr = ts.track_rgbd(*frames[i], i / 30.0)
        want.append((jr.state.name, js.tracker.ref_kf, jr.n_inliers,
                     jr.n_matches))
        got.append((tr.state.name, ts.tracker.ref_kf, tr.n_inliers,
                    tr.n_matches))
        Tt = tr.T_cw.numpy() if isinstance(tr.T_cw, torch.Tensor) \
            else np.asarray(tr.T_cw)
        np.testing.assert_allclose(Tt, np.asarray(jr.T_cw), rtol=0,
                                   atol=T_TOL, err_msg=f"frame {i}")
    assert got == want
    assert got[0][0] == "OK"                  # relocalized on the first frame
    assert all(g[0] == "OK" for g in got)
    for s in (js, ts):
        s.tracker.flush()
    fps.append((map_fingerprint(ts.tracker.map_state),
                {k: np.asarray(v).sum() for k, v in
                 js.tracker.map_state._asdict().items()}))
    assert fps[0][0] == fps[1][0]             # the port's map is unchanged
    for k, v in fps[0][1].items():            # and so is the JAX one
        assert np.array_equal(v, fps[1][1][k]), k


def test_localization_without_a_map_raises():
    ts = TSystem(to_port(small_cfg()), enable_loop_closing=False, device="cpu")
    ts.activate_localization_mode()
    black = np.zeros((240, 320), np.float32)
    with pytest.raises(RuntimeError, match="needs a loaded map"):
        ts.track_rgbd(black, black, 0.0)


def test_young_map_reset_in_both(maps):
    from dr_slam_tpu.slam.system import System

    cfg, frames, paths = maps
    js = System(cfg, enable_loop_closing=False)
    ts = TSystem(to_port(cfg), enable_loop_closing=False, device="cpu")
    for s in (js, ts):
        s.load_map(paths[21])
        assert s.tracker._n_kfs_host == 3
    black = np.zeros_like(frames[0][0]), np.zeros_like(frames[0][1])
    got, want = [], []
    for n in range(3):
        want.append(js.track_rgbd(*black, (30 + n) / 30.0).state.name)
        got.append(ts.track_rgbd(*black, (30 + n) / 30.0).state.name)
        assert ts.track_state.name == js.track_state.name
    assert got == want == ["LOST"] * 3
    assert ts.track_state.name == "NOT_INITIALIZED"
    assert int(ts.tracker.map_state.n_kfs) == 0
    # the next frame initializes a fresh map in both
    jr = js.track_rgbd(*frames[25], 33 / 30.0)
    tr = ts.track_rgbd(*frames[25], 33 / 30.0)
    assert (tr.state.name, tr.is_keyframe, tr.n_inliers) == \
        (jr.state.name, jr.is_keyframe, jr.n_inliers) == ("OK", True,
                                                          jr.n_inliers)
    assert ts.tracker.kf_seq_host == js.tracker.kf_seq_host == {0: 0}
