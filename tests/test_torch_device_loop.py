"""The slice as a whole: the port's `DeviceLoopTracker` against the JAX
one over the 40-frame corridor of tests/test_device_loop.py, from an empty
map, on the CPU.

States, keyframe flags, reference keyframe slots and their insertion
sequences, Manhattan flags and frame ids are exact. The counts and poses
carry the port's known gap from the reference (the JAX package's sync
`Tracker` gives its device loop's counts exactly on this corridor, and the
port's sync `Tracker` gives the port's): frame 1 differs by one inlier and
one match (a near-tie in the front-end), and after the keyframes' local
bundle adjustments (float32 conjugate gradients, summed in another order)
one frame's robust solve keeps another inlier set. Observed: n_matches
within 1, n_inliers within 14 (frame 37; every other frame within 1),
|dT_cw| 2.6e-3 (frame 37; 2.3e-3 at the frame-10 keyframe's BA)."""

import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.io.metrics import ate_rmse
from dr_slam_torch.slam.device_loop import REC_SIZE, DeviceLoopTracker

from torch_parity import shipped_codebooks, small_cfg, to_port

torch.set_num_threads(2)

N = 40
T_TOL = 4e-3        # max |T_cw - T_cw_jax| entry, records and trajectories
D_MATCHES = 2       # max |n_matches - jax| per frame
D_INLIERS = 16      # max |n_inliers - jax| per frame
EXACT = {16: "state", 19: "is_kf", 20: "ref_kf", 21: "ref_seq",
         38: "man_ok", 39: "frame_id"}


@pytest.fixture(scope="module")
def runs():
    from dr_slam_tpu.slam.device_loop import DeviceLoopTracker as JTracker

    cfg = small_cfg()
    poses = synthetic.corridor_trajectory(N)
    seq = synthetic.SyntheticSequence(poses, K4=cfg.camera.K4, height=240,
                                      width=320)
    frames = [tuple(np.asarray(x) for x in seq.render(i)) for i in range(N)]
    with shipped_codebooks():
        jt = JTracker(cfg)
        pt = DeviceLoopTracker(to_port(cfg), device="cpu")
        for i, (g, d) in enumerate(frames):
            jt.track(g, d, i / 30.0)
            pt.track(g, d, i / 30.0)
        yield dict(cfg=cfg, poses=poses, frames=frames, jax=jt, port=pt)


def test_states_keyframes_and_refs_exact(runs):
    jf, pf = runs["jax"].flush(), runs["port"].flush()
    assert pf["records"].shape == (N, REC_SIZE)
    assert np.all(np.isfinite(pf["records"]))
    assert pf["states"] == jf["states"]
    assert pf["states"].count("OK") == N
    for k, name in EXACT.items():
        np.testing.assert_array_equal(pf["records"][:, k], jf["records"][:, k],
                                      err_msg=name)
    assert [i for i in range(N) if pf["records"][i, 19]] == [0, 10, 20, 30]
    assert pf["n_keyframes"] == jf["n_keyframes"] == 4
    # one readback per tracked frame, one for the init gate
    assert runs["port"].readbacks == [1] * N
    assert runs["port"].relocs == [False] * N


def test_counts_within_bound(runs):
    a, b = runs["jax"].flush()["records"], runs["port"].flush()["records"]
    assert np.abs(b[:, 18] - a[:, 18]).max() <= D_MATCHES
    assert np.abs(b[:, 17] - a[:, 17]).max() <= D_INLIERS


def test_poses_within_bound(runs):
    a, b = runs["jax"].flush()["records"], runs["port"].flush()["records"]
    np.testing.assert_allclose(b[:, :16], a[:, :16], rtol=0, atol=T_TOL)
    np.testing.assert_allclose(b[:, 22:38], a[:, 22:38], rtol=0, atol=T_TOL)
    gt = np.asarray([np.linalg.inv(p)[:3, 3] for p in runs["poses"]])
    est = np.asarray([np.linalg.inv(T)[:3, 3]
                      for _, T in runs["port"].flush()["trajectory"]])
    assert ate_rmse(est, gt) < 0.05


def test_corrected_trajectory_follows_keyframes(runs):
    """corrected_trajectory recomposes each frame from its reference
    keyframe's current pose: equal to the JAX one, and a +1 m shift of
    every keyframe moves every recomposed frame by 1 m in both."""
    import jax.numpy as jnp

    jt, pt = runs["jax"], runs["port"]
    jc, pc = jt.corrected_trajectory(), pt.corrected_trajectory()
    assert len(pc) == len(jc) == N
    for (tj, Tj), (tp, Tp) in zip(jc, pc):
        assert tp == tj
        np.testing.assert_allclose(Tp, Tj, rtol=0, atol=T_TOL)
    S = np.eye(4, dtype=np.float32)
    S[0, 3] = 1.0
    jst, pst = jt.carry.map_state, pt.carry.map_state
    jt.carry = jt.carry._replace(map_state=jst._replace(
        kf_pose=jnp.asarray(np.asarray(jst.kf_pose) @ np.linalg.inv(S)[None])))
    pt.carry = pt.carry._replace(map_state=pst._replace(
        kf_pose=pst.kf_pose @ torch.from_numpy(np.linalg.inv(S))[None]))
    try:
        jc2, pc2 = jt.corrected_trajectory(), pt.corrected_trajectory()
    finally:
        jt.carry = jt.carry._replace(map_state=jst)
        pt.carry = pt.carry._replace(map_state=pst)
    d = np.asarray([np.linalg.inv(T2)[:3, 3] - np.linalg.inv(T1)[:3, 3]
                    for (_, T1), (_, T2) in zip(pc, pc2)])
    assert np.allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-3)
    for (_, Tj), (_, Tp) in zip(jc2, pc2):
        np.testing.assert_allclose(Tp, Tj, rtol=0, atol=T_TOL)


def test_track_chunk_equals_track(runs):
    """Mixed chunk sizes and a per-frame call, crossing the init and
    keyframe boundaries at other offsets than one chunk size would: the
    records equal the per-frame run's bit for bit (the same per-frame code;
    the reference's `lax.scan` chunk agrees with its own to about 1e-3)."""
    gray = np.stack([g for g, _ in runs["frames"]])
    depth = np.stack([d for _, d in runs["frames"]])
    ts = [i / 30.0 for i in range(N)]
    tr = DeviceLoopTracker(to_port(runs["cfg"]), device="cpu")
    tr.track_chunk(gray[:7], depth[:7], ts[:7])
    tr.track(gray[7], depth[7], ts[7])
    tr.track_chunk(gray[8:25], depth[8:25], ts[8:25])
    tr.track_chunk(gray[25:], depth[25:], ts[25:])
    got, ref = tr.flush(), runs["port"].flush()
    np.testing.assert_array_equal(got["records"], ref["records"])
    assert got["states"] == ref["states"]
    assert got["n_keyframes"] == ref["n_keyframes"]
    assert [t for t, _ in got["trajectory"]] == ts
    assert tr.readbacks == runs["port"].readbacks


def test_needs_a_card_or_cpu():
    cfg = to_port(small_cfg())
    if torch.cuda.is_available():
        assert DeviceLoopTracker(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DeviceLoopTracker(cfg)
    empty = DeviceLoopTracker(cfg, device="cpu").flush()
    assert empty["records"].shape == (0, REC_SIZE) and empty["states"] == []
