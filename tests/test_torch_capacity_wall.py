"""The capacity wall (tests/test_long_run.py:20-46: 12 keyframe slots, a
keyframe forced every 4 frames) in the port's `Tracker`, held against the
JAX `System` on the same numpy frames, the JAX decision lagged by exactly
one frame and each tracked rotation projected onto SO(3) (the port's two
rules, tests/torch_parity.py).

Over the scenario's 70 frames the two packages part at call 49, the fifth
forced eviction: JAX evicts slot 1, the port's own run slot 3
(scripts/parity_wall_torch.py prints the run). These tests pin the cause.

- Every stage of the keyframe pass, fed JAX's inputs, gives JAX's output:
  at the first pass whose keyframe culling frees a slot, at the first
  forced eviction and at the pass of call 49. The map operations are
  exact (float fields within 1e-5, the triangulated points within a
  relative 1e-3 as in tests/test_torch_mapping.py). The local bundle
  adjustment is within tests/test_torch_ba.py's bound for the tracker's 4
  x 24 iterations (5e-3); the JAX solve itself moves by more than 1e-4 when
  its input points move by one ulp, so the floats cannot agree exactly.
- So the gap is float order in the local BA, carried over the passes into
  the keyframes' observations and so into the eviction scores. The
  witness: the port `Tracker`, given JAX's whole tracker state after call
  48 (`torch_parity.tracker_to_port`), evicts
  JAX's slot at call 49 and makes JAX's choices through the next forced
  eviction (call 52): states, keyframes, reference keyframes and every
  slot's insertion sequence exact, T_cw within 3e-3, points within 2%.

The device loop's wall step is held in
tests/test_torch_capacity_wall_device_loop.py."""

import numpy as np
import torch

from dr_slam_torch import _smoke
from dr_slam_torch.slam.system import System as TSystem

from torch_parity import (assert_states_match, jax_system_lagged_by_one,
                          jax_wall_sequence, numpy_frames, port_stage,
                          projected_tracked_pose, recorded_jax_passes,
                          shipped_codebooks, small_cfg, to_port,
                          tracker_to_port)

CARRY = 48          # JAX's tracker after this call goes into the port
LAST = 52           # the next forced eviction's call
DIVERGE = 49        # the port's own run evicts another slot here
ATOL = 1e-5
BA_TOL = 5e-3       # tests/test_torch_ba.py, 4 x 24 iterations
SOLVED = ("pt_pos", "pt_normal", "pt_dist_min", "pt_dist_max")
BA_FIELDS = ("kf_pose", "pt_pos", "pl_coef", "ln_ep")


def _run():
    """The JAX `System` over calls 0..LAST with every keyframe pass's
    stages recorded, and the port `System` from JAX's tracker after call
    CARRY over the rest (under the caller's `shipped_codebooks`)."""
    from dr_slam_tpu.slam.system import System

    cfg = _smoke.wall_cfg(small_cfg())
    tcfg = to_port(cfg)
    frames = numpy_frames(jax_wall_sequence(cfg, LAST + 1), LAST + 1)
    counter = [0]
    with projected_tracked_pose(), jax_system_lagged_by_one(), \
            recorded_jax_passes(set(range(LAST + 1)), counter) as log:
        js = System(cfg, enable_loop_closing=False)
        jrec = _smoke.BehaviourRecorder(js)
        for i, (g, d) in enumerate(frames):
            counter[0] = i
            jrec.track(g, d, i / 30.0)
            if i == CARRY:
                ts_ = TSystem(tcfg, enable_loop_closing=False, device="cpu")
                tracker_to_port(js.tracker, ts_.tracker)
        prec = _smoke.BehaviourRecorder(ts_)
        for i in range(CARRY + 1, LAST + 1):
            prec.track(*frames[i], i / 30.0)
    return dict(cfg=cfg, tcfg=tcfg, log=list(log), jax=jrec.arrays(),
                port=prec.arrays())


def _passes(log):
    """call -> [(stage, args, kwargs, output)] of the keyframe passes."""
    out = {}
    for call, name, a, kw, o in log:
        out.setdefault(call, []).append((name, a, kw, o))
    return out


def _watched(log):
    """The first pass whose keyframe culling frees a slot, the first forced
    eviction's pass and the pass of call DIVERGE."""
    passes = _passes(log)

    def frees(stage):
        name, a, _, o = stage
        return (name == "cull_one_keyframe"
                and int(a[0].n_kfs) > int(o.n_kfs))
    culled = next(c for c, p in passes.items()
                  if any(frees(s) and not s[2].get("force") for s in p))
    forced = next(c for c, p in passes.items()
                  if any(s[2].get("force") for s in p))
    assert culled < forced < DIVERGE and DIVERGE in passes
    return {c: passes[c] for c in (culled, forced, DIVERGE)}


def _scenario_is_the_long_run_tests(wall):
    cfg = wall["cfg"]
    assert cfg.map.max_keyframes == 12
    assert (cfg.tracking.min_frames, cfg.tracking.max_frames,
            cfg.tracking.kf_ref_ratio) == (3, 4, 0.995)
    assert to_port(cfg) == _smoke.wall_cfg(_smoke.small_cfg())
    j = wall["jax"]
    assert (j["state"] == 2).all()
    # the wall: every slot but one live from the first forced eviction on
    assert (np.asarray(j["kf_seq"][CARRY]) >= 0).sum() == 11


def _each_stage_on_jax_inputs(wall):
    """Every stage of three passes, the forced evictions included, on JAX's
    inputs against JAX's outputs."""
    tcfg = wall["tcfg"]
    seen = []
    for call, stages in _watched(wall["log"]).items():
        for name, a, kw, want in stages:
            got = port_stage(name, a, kw, tcfg)
            seen.append((call, name, bool(kw.get("force"))))
            msg = f"call {call} {name}"
            if name == "map_ba":
                assert_states_match(want, got, ATOL, [
                    f for f in want._fields if f not in BA_FIELDS])
                for f in BA_FIELDS:
                    np.testing.assert_allclose(
                        getattr(got, f).numpy(), getattr(want, f), rtol=0,
                        atol=BA_TOL, err_msg=f"{msg} {f}")
            elif name == "triangulate_with_kf":
                assert_states_match(want, got, ATOL, [
                    f for f in want._fields if f not in SOLVED])
                for f in SOLVED:
                    np.testing.assert_allclose(
                        getattr(got, f).numpy(), getattr(want, f), rtol=1e-3,
                        atol=ATOL, err_msg=f"{msg} {f}")
            else:
                assert_states_match(want, got, ATOL)
    names = {n for _, n, _ in seen}
    assert names == {"add_keyframe", "cull_map", "triangulate_with_kf",
                     "fuse_new_points", "map_ba", "cull_one_keyframe"}
    assert sum(f for _, _, f in seen) == 2      # two forced evictions


def _local_ba_moves_with_one_ulp(wall):
    """The JAX local BA of the first culling pass, its input points moved
    by one ulp: its output moves by more than 1e-4, so float32 sums in
    another order cannot give JAX's floats exactly."""
    import jax.numpy as jnp

    from dr_slam_tpu.slam.tracking import Tracker

    call = min(_watched(wall["log"]))
    name, a, kw, want = next(s for s in _watched(wall["log"])[call]
                             if s[0] == "map_ba")
    st = a[0]
    moved = st._replace(pt_pos=np.nextafter(st.pt_pos, np.float32(np.inf)))
    tr = Tracker(wall["cfg"])
    tr.map_state = type(st)(*(jnp.asarray(x) for x in moved))
    tr._map_ba(center_kf=jnp.asarray(kw["center_kf"]))
    live = np.asarray(want.pt_valid)
    shift = max(float(np.abs(np.asarray(tr.map_state.kf_pose)
                             - want.kf_pose).max()),
                float(np.abs(np.asarray(tr.map_state.pt_pos)[live]
                             - want.pt_pos[live]).max()))
    assert shift > 1e-4, shift


def _fixture_evictions_are_this_run(wall):
    """The long run's forced evictions stored in behaviours.npz (which
    tests/test_torch_behaviours_fixture.py puts through the port) are this
    run's, input and slot, up to call LAST."""
    data = _smoke.load_behaviours_fixture()
    live = [(call, a[0], o) for call, name, a, kw, o in wall["log"]
            if name == "cull_one_keyframe" and kw.get("force")]
    stored = [e for e, c in enumerate(data["lrev_call"]) if c <= LAST]
    assert [c for c, _, _ in live] == data["lrev_call"][stored].tolist()
    for e, (call, st, out) in zip(stored, live):
        for f in _smoke.CULL_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(st, f)),
                                          data[f"lrev_{f}"][e],
                                          err_msg=f"call {call} {f}")
        freed = np.nonzero(np.asarray(st.kf_valid)
                           & ~np.asarray(out.kf_valid))[0].tolist()
        assert freed == [int(data["lrev_slot"][e])], call


def _port_from_jax_state(wall):
    """The port `Tracker` from JAX's state after call CARRY: JAX's slot
    at the eviction of call DIVERGE and JAX's choices to call LAST."""
    j = {k: v[CARRY + 1:] for k, v in wall["jax"].items()}
    p = wall["port"]
    gaps, fails = _smoke.behaviour_gaps(j, p)
    assert not fails, (fails, gaps)
    # both evictions happened, and slot 1 went at call DIVERGE
    before = np.asarray(wall["jax"]["kf_seq"][CARRY])
    after = p["kf_seq"][DIVERGE - CARRY - 1]
    assert before[1] >= 0 and after[1] != before[1]
    assert p["kf"].sum() == 2 and (p["state"] == 2).all()


def test_forced_eviction_from_jax_state():
    """One run of both packages, then each check in turn, the stages with
    the codebooks the runs had."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        with shipped_codebooks():
            wall = _run()
            for check in (_scenario_is_the_long_run_tests,
                          _each_stage_on_jax_inputs,
                          _local_ba_moves_with_one_ulp,
                          _fixture_evictions_are_this_run,
                          _port_from_jax_state):
                check(wall)
    finally:
        torch.set_num_threads(old)
