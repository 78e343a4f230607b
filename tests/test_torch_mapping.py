"""The keyframe half of the port's map operations, `compute_bow` and
`find_manhattan`, each against the JAX function on identical inputs.

The JAX `System` tracker (synchronous mode, small config of
tests/test_tracking_e2e.py) builds a map over 11 corridor frames, inserting
keyframes at frames 0 and 10; frame 11 is extracted and tracked by the JAX
package, and its features and matches feed both packages. Where the real
map exercises too little (duplicate planes and lines, depth holes,
redundant keyframes), the state is edited in numpy first, the same way for
both.

Both packages use the shipped codebooks, registered by
`torch_parity.shipped_codebooks` for the module (the JAX `System` registers
them too): unregistered, the port takes the seeded random one.

Integer tables, masks, slot allocation and counts must match exactly. Float
fields agree within 1e-5: the same float32 formulas, with sums taken in
another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.associate.vocabulary import compute_bow as j_bow
from dr_slam_tpu.io import synthetic
from dr_slam_tpu.manhattan.bootstrap import find_manhattan as j_manhattan
from dr_slam_tpu.slam import map_ops as jm
from dr_slam_tpu.slam.track_step import track_step as j_track_step
from dr_slam_tpu.frontend.frame import extract_frame as j_extract
from dr_slam_torch.associate.vocabulary import compute_bow as t_bow
from dr_slam_torch.manhattan.bootstrap import find_manhattan as t_manhattan
from dr_slam_torch.slam import map_ops as tm

from torch_parity import (assert_states_match, feats_to_port,
                          shipped_codebooks, small_cfg, state_to_port, tensor,
                          to_port)

torch.set_num_threads(2)

ATOL = 1e-5
N_MAP = 11


def _copy(st):
    """A copy of a JAX state (the JAX map ops donate their input)."""
    return jax.tree_util.tree_map(jnp.copy, st)


@pytest.fixture(scope="module")
def built():
    from dr_slam_tpu.slam.system import System

    with shipped_codebooks():
        cfg = small_cfg(deferred=False)
        seq = synthetic.SyntheticSequence(
            synthetic.corridor_trajectory(N_MAP + 1, step=0.03),
            K4=cfg.camera.K4, height=240, width=320)
        tr = System(cfg, enable_loop_closing=False).tracker
        for i in range(N_MAP):
            tr.process_frame(*seq.render(i), i / 30.0)
        assert int(tr.map_state.n_kfs) == 2
        gray, depth = seq.render(N_MAP)
        feats = j_extract(jnp.asarray(gray, jnp.float32),
                          jnp.asarray(depth, jnp.float32), cfg)
        out = j_track_step(tr.map_state, feats, tr.T_cw, tr.velocity, tr.R_cm,
                           jnp.asarray(tr.ref_kf), cfg)
        pm = jm.PlaneMatches(
            match_idx=out.plane_match, par_idx=out.plane_par,
            ver_idx=out.plane_ver,
            obs_world=jax.vmap(lambda p: jm.se3.plane_to_world(out.T_cw, p))(
                feats.planes.coeffs))
        bow = j_bow(feats.kp.desc, feats.kp.valid, cfg.map.vocab_words)
        yield dict(cfg=cfg, tcfg=to_port(cfg), state=out.new_map_state,
                   feats=feats, out=out, pm=pm, bow=bow, ref_kf=tr.ref_kf)


def _port_pm(pm):
    return tm.PlaneMatches(*(tensor(x) for x in pm))


def _add_keyframe_both(b, pm=None, blocked=True, lm=None):
    """add_keyframe of frame 11 in both packages from the same state."""
    cfg, st, feats, out = b["cfg"], b["state"], b["feats"], b["out"]
    pm = b["pm"] if pm is None else pm
    lm = out.line_match if lm is None else lm
    jb = (jm.creation_block_mask(st, feats.kp.uv, feats.kp_depth, out.T_cw,
                                 cfg.camera.K4) if blocked else None)
    jst, jk = jm.add_keyframe(_copy(st), feats, out.T_cw, 11 / 30.0,
                              out.mp_idx, pm, lm, b["bow"], cfg, blocked=jb)
    tst, tk = tm.add_keyframe(
        state_to_port(st), feats_to_port(feats), tensor(out.T_cw), 11 / 30.0,
        tensor(out.mp_idx), _port_pm(pm), tensor(lm),
        tensor(b["bow"]), b["tcfg"],
        blocked=None if jb is None else tensor(jb))
    return jst, int(jk), tst, int(tk)


def test_compute_bow(built):
    f = built["feats"]
    j = np.asarray(j_bow(f.kp.desc, f.kp.valid, 512))
    t = t_bow(tensor(f.kp.desc), tensor(f.kp.valid), 512).numpy()
    assert j.sum() > 0.99
    np.testing.assert_array_equal(t, j)


def test_creation_block_mask(built):
    cfg, st, f, out = built["cfg"], built["state"], built["feats"], built["out"]
    j = np.asarray(jm.creation_block_mask(st, f.kp.uv, f.kp_depth, out.T_cw,
                                          cfg.camera.K4))
    t = tm.creation_block_mask(state_to_port(st), tensor(f.kp.uv),
                               tensor(f.kp_depth), tensor(out.T_cw),
                               cfg.camera.K4).numpy()
    assert 0 < j.sum() < j.size
    np.testing.assert_array_equal(t, j)


def test_add_keyframe(built):
    jst, jk, tst, tk = _add_keyframe_both(built)
    assert jk == tk == 2
    assert int(jst.n_pts) > int(built["state"].n_pts)
    assert_states_match(jst, tst, ATOL)


def test_add_keyframe_two_planes_onto_one_map_plane(built):
    """Two observed planes matched to one map plane: the running average,
    the cloud refresh and the observation count all see a repeated target,
    and the later observation's write wins in both packages."""
    pm = built["pm"]
    valid = np.flatnonzero(np.asarray(built["feats"].planes.valid))
    target = int(np.flatnonzero(np.asarray(built["state"].pl_valid))[0])
    assert len(valid) >= 2
    match = np.asarray(pm.match_idx).copy()
    match[valid[:2]] = target
    pm2 = pm._replace(match_idx=jnp.asarray(match))
    jst, _, tst, _ = _add_keyframe_both(built, pm=pm2)
    assert int(jst.pl_obs_count[target]) == \
        int(built["state"].pl_obs_count[target]) + int((match == target).sum())
    assert (match == target).sum() >= 2
    assert_states_match(jst, tst, ATOL)


def test_add_keyframe_when_slots_run_out(built):
    """Only 5 point slots, 1 plane slot and no line slot free, and every
    observed plane and line left unmatched: the first wanted rows take the
    free slots and the rest are dropped (the reference's index = capacity
    scatters), in both packages alike."""
    s = {k: np.array(v) for k, v in built["state"]._asdict().items()}
    for name, keep_free in (("pt_valid", 5), ("pl_valid", 1), ("ln_valid", 0)):
        free = np.flatnonzero(~s[name])
        s[name][free[keep_free:]] = True
    b = dict(built, state=built["state"]._replace(
        **{k: jnp.asarray(v) for k, v in s.items()}))
    pm = b["pm"]._replace(match_idx=jnp.full_like(b["pm"].match_idx, -1))
    lm = jnp.full_like(b["out"].line_match, -1)
    jst, _, tst, _ = _add_keyframe_both(b, pm=pm, lm=lm)
    for name in ("pt_valid", "pl_valid", "ln_valid"):
        assert bool(np.asarray(getattr(jst, name)).all()), name
    row = lambda tab: np.asarray(tab[2])     # the new keyframe's row
    assert (row(jst.kf_pl) >= 0).sum() == 1 < np.asarray(
        built["feats"].planes.valid).sum()
    assert (row(jst.kf_ln) < 0).all() and np.asarray(
        built["feats"].lines.has3d).any()
    assert_states_match(jst, tst, ATOL)


def _edited_for_culling(st):
    """Feed cull_map work: a duplicate of a live plane and of a live line
    in free slots, and points seen often but rarely matched."""
    s = {k: np.array(v) for k, v in st._asdict().items()}
    a = int(np.flatnonzero(s["pl_valid"])[0])
    b = int(np.flatnonzero(~s["pl_valid"])[0])
    for f in ("pl_coef", "pl_cloud", "pl_cloud_valid", "pl_valid"):
        s[f][b] = s[f][a]
    la = np.flatnonzero(s["ln_valid"])[:2]
    lb = np.flatnonzero(~s["ln_valid"])[:2]
    for f in ("ln_ep", "ln_dir", "ln_desc", "ln_valid", "ln_obs_count",
              "ln_found", "ln_visible"):
        s[f][lb] = s[f][la]
    s["ln_obs_count"][lb[1]] += 3           # the copy wins one fusion
    pts = np.flatnonzero(s["pt_valid"])[::7]
    s["pt_visible"][pts] = 12
    s["pt_found"][pts[::2]] = 1
    # a keyframe plane observation of the duplicate is redirected
    s["kf_pl"][1, 0] = b
    return st._replace(**{k: jnp.asarray(v) for k, v in s.items()})


def test_cull_map(built):
    st = _edited_for_culling(built["state"])
    cfg = built["cfg"]
    jst = jm.cull_map(_copy(st), merge_angle_cos=cfg.plane.merge_angle_cos,
                      merge_dist=cfg.plane.merge_dist)
    tst = tm.cull_map(state_to_port(st), merge_angle_cos=cfg.plane.merge_angle_cos,
                      merge_dist=cfg.plane.merge_dist)
    assert int(jnp.sum(jst.pl_valid)) < int(jnp.sum(st.pl_valid))
    assert int(jnp.sum(jst.ln_valid)) < int(jnp.sum(st.ln_valid))
    assert int(jst.n_pts) < int(jnp.sum(st.pt_valid))
    assert_states_match(jst, tst, 0.0)


def _with_depth_holes(st, kfs):
    """Mark every third feature of keyframes `kfs` as depth-less and
    unmatched, so triangulation has candidates."""
    s = {k: np.array(v) for k, v in st._asdict().items()}
    for k in kfs:
        s["kf_ur"][k, ::3] = -1.0
        s["kf_mp"][k, ::3] = -1
    return st._replace(**{k: jnp.asarray(v) for k, v in s.items()})


@pytest.mark.parametrize("pair", [(2, 0), (2, 2)], ids=["distinct", "equal"])
def test_triangulate_with_kf(built, pair):
    """Keyframe 2 (frame 11) against keyframe 0 (frame 0, 33 cm away, so
    the parallax gate passes), and against itself (creates nothing).

    The new points' positions, and the distances and directions derived
    from them, agree within a relative 1e-3 (observed 1.8e-4): the
    mid-point solve divides by det = |a|^2 |b|^2 - (a.b)^2, which cancels
    to about sin^2 of the parallax angle (>= 4e-4 at the gate), so float32
    rounding grows by up to 1 / 4e-4 there."""
    jst0, _, _, _ = _add_keyframe_both(built)
    st = _with_depth_holes(jst0, (0, 2))
    K4 = built["cfg"].camera.K4
    jst = jm.triangulate_with_kf(_copy(st), jnp.asarray(pair[0]),
                                 jnp.asarray(pair[1]), K4)
    tst = tm.triangulate_with_kf(state_to_port(st), torch.tensor(pair[0]),
                                 torch.tensor(pair[1]), K4)
    created = int(jst.n_pts) - int(jnp.sum(st.pt_valid))
    assert (created > 0) if pair[0] != pair[1] else (created == 0)
    solved = ("pt_pos", "pt_normal", "pt_dist_min", "pt_dist_max")
    assert_states_match(jst, tst, ATOL,
                        [f for f in jst._fields if f not in solved])
    for f in solved:
        np.testing.assert_allclose(getattr(tst, f).numpy(),
                                   np.asarray(getattr(jst, f)), rtol=1e-3,
                                   atol=ATOL, err_msg=f)


def test_fuse_new_points(built):
    """Keyframe 2 inserted without the creation block duplicates points
    that keyframes 0 and 1 made; fusion merges them back."""
    jst0, k, _, _ = _add_keyframe_both(built, blocked=False)
    jst = jm.fuse_new_points(_copy(jst0), jnp.asarray(k))
    tst = tm.fuse_new_points(state_to_port(jst0), torch.tensor(k))
    assert int(jst.n_pts) < int(jst0.n_pts)
    assert_states_match(jst, tst, 0.0)


def _redundant(st, src: int, copies):
    """Copy keyframe `src` into free slots `copies` with later sequence
    numbers: its observations become covered by >= 3 other keyframes."""
    s = {k: np.array(v) for k, v in st._asdict().items()}
    nxt = int(s["kf_next_seq"])
    for i, c in enumerate(copies):
        for f in ("kf_pose", "kf_uv", "kf_ur", "kf_xyz", "kf_desc",
                  "kf_sigma2", "kf_angle", "kf_kp_valid", "kf_mp"):
            s[f][c] = s[f][src]
        s["kf_valid"][c] = True
        s["kf_seq"][c] = nxt + i
    s["kf_next_seq"] = np.int32(nxt + len(copies))
    s["n_kfs"] = np.int32(s["kf_valid"].sum())
    return st._replace(**{k: jnp.asarray(v) for k, v in s.items()})


@pytest.mark.parametrize("copies,force,culled", [
    ((2, 3, 4), False, 1), ((2, 3), False, 0), ((2, 3), True, 1)],
    ids=["redundant", "below-threshold", "forced"])
def test_cull_one_keyframe(built, copies, force, culled):
    """Keyframe 1 copied into later slots. With three copies its points are
    all seen by >= 3 other keyframes and it is culled (ties to the lower
    slot); with two copies nothing passes the threshold, and only force=True
    evicts the fallback. Seq 0 and the two newest are protected."""
    st = _redundant(built["state"], 1, copies)
    jst = jm.cull_one_keyframe(_copy(st), force=force)
    tst = tm.cull_one_keyframe(state_to_port(st), force=force)
    assert int(jst.n_kfs) == int(st.n_kfs) - culled
    assert_states_match(jst, tst, 0.0)


def test_covisible_keyframes(built):
    st, out = built["state"], built["out"]
    j = np.asarray(jm.covisible_keyframes(st, out.mp_idx))
    t = tm.covisible_keyframes(state_to_port(st), tensor(out.mp_idx)).numpy()
    assert j[:2].min() > 0
    np.testing.assert_array_equal(t, j)


def _manhattan_cases(f):
    """The frame's planes and lines, then seeded inputs where several
    plane pairs tie on score, and inputs with only the plane-line
    fallback, and with nothing perpendicular."""
    yield (np.asarray(f.planes.coeffs[:, :3]), np.asarray(f.planes.valid),
           np.asarray(f.planes.n_blocks, np.float32),
           np.asarray(f.lines.man_dir), np.asarray(f.lines.man_ok))
    rng = np.random.RandomState(0)
    axes = np.eye(3, dtype=np.float32)
    n = axes[rng.randint(0, 3, 8)] * np.where(rng.rand(8, 1) < 0.5, -1, 1)
    n = (n + 0.01 * rng.randn(8, 3)).astype(np.float32)
    w = np.full(8, 20.0, np.float32)
    ld = rng.randn(6, 3).astype(np.float32)
    yield n, rng.rand(8) < 0.8, w, ld, rng.rand(6) < 0.5
    par = np.tile(np.float32([[0.0, 0.0, 1.0]]), (8, 1))
    yield par, np.ones(8, bool), w, axes[[0, 1, 2]], np.array([True, False, False])
    yield par, np.ones(8, bool), w, axes[[2, 2, 2]], np.ones(3, bool)


def test_find_manhattan(built):
    for n, v, w, ld, lv in _manhattan_cases(built["feats"]):
        Rj, okj = j_manhattan(jnp.asarray(n), jnp.asarray(v), jnp.asarray(w),
                              jnp.asarray(ld), jnp.asarray(lv))
        Rt, okt = t_manhattan(*(torch.from_numpy(np.asarray(x))
                                for x in (n, v, w, ld, lv)))
        assert bool(okt) == bool(okj)
        np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-5)
