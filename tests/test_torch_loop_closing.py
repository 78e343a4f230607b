"""Loop closing: the port's pose-graph solve, landmark re-anchoring,
covisibility, `LoopCloser.process` and its global BA against the JAX
package.

- `optimize_pose_graph` on a seeded 20-pose circle: odometry edges with
  noise, two of them poisoned by a 0.5 m gauge jump (robust), covisibility
  edges, and a weight-10 loop edge (not robust), the first pose fixed.
  Within 1e-4 of the JAX solve (observed 7e-7): 10 Gauss-Newton steps of
  60 float32 CG iterations, summed in another order.
- `_covis_full` exact and `_reanchor_map` within 1e-5 on
  `synthetic_map_state`, with keyframe sequences shuffled and two keyframes
  dead, so the newest observer is not the highest slot.
- `LoopCloser.process` on the loop fixture (dr_slam_torch/data/
  loop_small.npz, the JAX package's loop scenario, made by
  scripts/make_torch_loop_fixture.py): the call that fired in the JAX run
  fires here with the same loop keyframe, the same accepted-loop sequences,
  the same surviving points (so the same fused count) and observation
  table, T_rel within 1e-3 (observed 4.5e-7), and the corrected map within
  LOOP_CORR_TOL of dr_slam_torch/_smoke.py (observed <= 1e-6; the headroom
  is for the GPU, where `chip_smoke.py` phase 6 holds the port to the same
  bounds). The codebook in effect in that run is the shipped vocab512.npz,
  which the JAX System registered over the trained one; the port's, with
  the shipped codebooks registered, is equal to it.
- The global BA dispatched after the correction, resolved blocking, against
  the JAX one within LOOP_GBA_TOL (observed 6.3e-4 on poses, 8.6e-3 on one
  point): 4 Gauss-Newton steps of 30 float32 CG iterations over the whole
  map.
- The call before the firing one, which does not fire: the same group
  candidates, the same trials (keyframe, matched pairs, Horn inliers,
  reprojection inliers) and the same consistency state after it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.io.synthetic import synthetic_map_state
from dr_slam_tpu.optimize import pose_graph as jpg
from dr_slam_tpu.slam import loop_closing as jlc
from dr_slam_tpu.slam.state import MapState as JMapState
from dr_slam_torch._smoke import (LOOP_CORR_TOL, LOOP_FIXTURE, LOOP_GBA_TOL,
                                  load_npz, loop_call, loop_closer,
                                  loop_gaps, loop_small_cfg)
from dr_slam_torch.associate import vocabulary as tvoc
from dr_slam_torch.io.map_io import from_jax_state
from dr_slam_torch.optimize import pose_graph as tpg
from dr_slam_torch.slam import loop_closing as tlc

from torch_parity import (loop_cfg, shipped_codebooks, small_cfg,
                          state_to_port, to_port)

torch.set_num_threads(2)


def _se3(rng, scale_t, scale_r):
    from dr_slam_torch.geometry import se3
    xi = np.concatenate([rng.normal(0, scale_t, 3), rng.normal(0, scale_r, 3)])
    return se3.se3_exp(torch.tensor(xi, dtype=torch.float32)).numpy()


def test_pose_graph_matches():
    rng = np.random.RandomState(0)
    n = 20
    th = 2 * np.pi * np.arange(n) / n
    T_true = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    T_true[:, 0, 3], T_true[:, 2, 3] = 2 * np.cos(th), 2 * np.sin(th)
    # drifted initial estimates
    poses = np.stack([_se3(rng, 0.02 * k, 0.004 * k) @ T_true[k]
                      for k in range(n)]).astype(np.float32)
    ei, ej, meas, w, robust = [], [], [], [], []

    def edge(i, j, noise, weight=1.0, rob=True, jump=0.0):
        M = T_true[i] @ np.linalg.inv(T_true[j]) @ _se3(rng, noise, noise / 5)
        M[:3, 3] += jump
        ei.append(i), ej.append(j), meas.append(M), w.append(weight)
        robust.append(rob)
    for k in range(n - 1):
        edge(k, k + 1, 0.01, jump=0.5 if k in (6, 13) else 0.0)
    for k in range(n - 2):
        edge(k, k + 2, 0.01)
    edge(0, n - 1, 0.002, weight=10.0, rob=False)
    fixed = np.zeros(n, bool)
    fixed[0] = True
    args = dict(poses=poses, pose_valid=np.ones(n, bool), edge_i=np.array(ei),
                edge_j=np.array(ej),
                edge_T_ij=np.stack(meas).astype(np.float32),
                edge_valid=np.ones(len(ei), bool),
                edge_weight=np.array(w, np.float32), fixed=fixed,
                edge_robust=np.array(robust))
    want = np.asarray(jpg.optimize_pose_graph(jpg.PoseGraph(
        **{k: jnp.asarray(v) for k, v in args.items()})))
    got = tpg.optimize_pose_graph(tpg.PoseGraph(
        **{k: torch.from_numpy(v) for k, v in args.items()})).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # the solve did move the chain toward the truth
    assert (np.abs(got[:, :3, 3] - T_true[:, :3, 3]).max()
            < 0.5 * np.abs(poses[:, :3, 3] - T_true[:, :3, 3]).max())


@pytest.fixture(scope="module")
def synth():
    cfg = small_cfg()
    st, _ = synthetic_map_state(cfg, 24, seed=2)
    rng = np.random.RandomState(3)
    seq = np.asarray(st.kf_seq).copy()
    seq[:24] = rng.permutation(24)
    valid = np.asarray(st.kf_valid).copy()
    valid[[4, 9]] = False
    seq[[4, 9]] = -1
    st = st._replace(kf_seq=jnp.asarray(seq), kf_valid=jnp.asarray(valid))
    new_poses = np.asarray(st.kf_pose).copy()
    for k in range(24):
        new_poses[k] = _se3(rng, 0.05, 0.01) @ new_poses[k]
    return st, new_poses


def test_covis_full_exact(synth):
    st, _ = synth
    want = np.asarray(jlc._covis_full(st))
    got = tlc._covis_full(state_to_port(st)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.max() > 50
    np.testing.assert_array_equal(
        tlc._covis_counts(state_to_port(st), 7).numpy(),
        np.asarray(jlc._covis_counts(st, jnp.asarray(7))))


def test_reanchor_map_matches(synth):
    st, new_poses = synth
    want = jlc._reanchor_map(st, jnp.asarray(new_poses))
    got = tlc._reanchor_map(state_to_port(st), torch.from_numpy(new_poses))
    for f in ("pt_pos", "pl_coef", "pl_cloud", "ln_ep", "ln_dir", "kf_pose"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=1e-5, err_msg=f)
    assert np.abs(np.asarray(want.pt_pos) - np.asarray(st.pt_pos)).max() > 0.01


# --- the loop fixture ------------------------------------------------------

@pytest.fixture(scope="module")
def fixture():
    return load_npz(LOOP_FIXTURE)


def test_config_and_codebook(fixture):
    """The fixture's scenario config is loop_small_cfg, and its codebook
    is the port's for 512 words once the shipped codebooks are registered
    (as the port's System registers them; unregistered, both packages
    fall back to the seeded random codebook)."""
    assert to_port(loop_cfg()) == loop_small_cfg()
    with shipped_codebooks():
        np.testing.assert_array_equal(tvoc.get_codebook_signs(512),
                                      fixture["codebook_signs"])


@pytest.fixture(scope="module")
def fired(fixture):
    call = loop_call(fixture, "fire")
    lc = loop_closer(tlc.LoopCloser, loop_small_cfg(), call, device="cpu")
    st = from_jax_state(call["state"], "cpu")
    new, corrected = lc.process(st, call["cur_kf"], call["odom"])
    return call, lc, st, new, corrected


def test_process_fires_as_jax(fixture, fired):
    call, lc, st, new, corrected = fired
    assert corrected and bool(fixture["fire__corrected"])
    loops = [(a, b) for a, b, _ in lc._accepted_loops]
    assert loops == [tuple(x) for x in fixture["fire__after__loops_seq"]]
    assert lc._last_fire_seq == int(fixture["fire__after__last_fire_seq"])
    assert lc._consistency == {}
    seq = st.kf_seq.numpy()
    loop_kf = int(np.where(seq == loops[-1][0])[0][0])
    assert loop_kf != call["cur_kf"] and loops[-1][1] == seq[call["cur_kf"]]
    np.testing.assert_allclose(lc._accepted_loops[-1][2],
                               fixture["fire__after__loops_T"][-1], rtol=0,
                               atol=1e-3)
    fused = int(st.pt_valid.sum()) - int(new.pt_valid.sum())
    assert fused == (int(call["state"]["pt_valid"].sum())
                     - int(fixture["fire__out__pt_valid"].sum())) > 0
    np.testing.assert_array_equal(new.pt_valid.numpy(),
                                  fixture["fire__out__pt_valid"])
    np.testing.assert_array_equal(new.kf_mp.numpy(),
                                  fixture["fire__out__kf_mp"])
    for f, tol in LOOP_CORR_TOL.items():
        np.testing.assert_allclose(getattr(new, f).numpy(),
                                   fixture[f"fire__out__{f}"], rtol=0,
                                   atol=tol, err_msg=f)
    assert loop_gaps(fixture, call, lc, st, new, corrected)[1] == []


def test_global_ba_blocking_matches(fixture, fired):
    _, lc, _, new, _ = fired
    lc.dispatch_gba(new, guard_gen=3)
    assert lc.resolve_gba(new, guard_gen=4) is None     # map changed since
    lc.dispatch_gba(new, guard_gen=3)
    assert lc.gba_ready()                                # at once on the CPU
    merged = lc.resolve_gba(new, guard_gen=3, block=True)
    assert lc.resolve_gba(new, guard_gen=3) is None      # merged once
    for f, tol in LOOP_GBA_TOL.items():
        np.testing.assert_allclose(getattr(merged, f).numpy(),
                                   fixture[f"gba__{f}"], rtol=0, atol=tol,
                                   err_msg=f)


def _watch(monkeypatch, lc_mod, kdb_mod, log):
    """Record the group candidates and each trial's numbers of a
    LoopCloser.process call."""
    group, match, ransac, refine = (kdb_mod.group_candidates,
                                    lc_mod._match_kf_pairs, lc_mod.sim3_ransac,
                                    lc_mod._refine_loop_rel)

    def g(*a, **k):
        out = group(*a, **k)
        log.append(("candidates", list(out)))
        return out

    def m(state, kf_a, kf_b):
        out = match(state, kf_a, kf_b)
        log.append(("pairs", int(kf_a), int(np.asarray(out[2]).sum())))
        return out

    def r(*a, **k):
        out = ransac(*a, **k)
        log.append(("horn_inliers", int(out[2])))
        return out

    def f(*a, **k):
        out = refine(*a, **k)
        log.append(("reproj_inliers", int(out[1])))
        return out
    monkeypatch.setattr(kdb_mod, "group_candidates", g)
    monkeypatch.setattr(lc_mod, "_match_kf_pairs", m)
    monkeypatch.setattr(lc_mod, "sim3_ransac", r)
    monkeypatch.setattr(lc_mod, "_refine_loop_rel", f)


def test_non_firing_call_matches(fixture, monkeypatch):
    from dr_slam_tpu.associate import keyframe_db as jkdb
    from dr_slam_torch.associate import keyframe_db as tkdb

    call = loop_call(fixture, "prev")
    jlog, tlog = [], []
    _watch(monkeypatch, jlc, jkdb, jlog)
    _watch(monkeypatch, tlc, tkdb, tlog)
    jl = loop_closer(jlc.LoopCloser, loop_cfg(), call)
    tl = loop_closer(tlc.LoopCloser, loop_small_cfg(), call, device="cpu")
    jst = JMapState(**{k: jnp.asarray(v) for k, v in call["state"].items()})
    _, jfired = jl.process(jst, call["cur_kf"], call["odom"])
    _, tfired = tl.process(from_jax_state(call["state"], "cpu"),
                           call["cur_kf"], call["odom"])
    assert not jfired and not tfired and not bool(fixture["prev__corrected"])
    assert tlog == jlog
    assert tlog[0][0] == "candidates" and len(tlog[0][1]) > 0
    assert tl._consistency == jl._consistency == {
        int(k): int(v) for k, v in fixture["prev__after__consistency"]}
