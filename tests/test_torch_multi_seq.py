"""Multi-sequence tracking on the CPU (dr_slam_torch/parallel/
multi_seq.py): two phase-shifted corridor walks of tests/test_multi_seq.py,
12 steps. Every sequence initializes and tracks, the sequences diverge, and
sequence 1's records equal a single port `DeviceLoopTracker`'s on the same
frames bit for bit (the same per-sequence code)."""

import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.io.metrics import ate_rmse
from dr_slam_torch.parallel.multi_seq import (MultiSequenceTracker,
                                              stack_carries)
from dr_slam_torch.slam.device_loop import DeviceLoopTracker

from torch_parity import small_cfg, to_port

torch.set_num_threads(2)

N_SEQ = 2
N_FRAMES = 12


@pytest.fixture(scope="module")
def multi_run():
    cfg = to_port(small_cfg())
    seqs = [synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(N_FRAMES + 4 * s, step=0.02)[4 * s:],
        K4=cfg.camera.K4, height=240, width=320) for s in range(N_SEQ)]
    frames = []
    for i in range(N_FRAMES):
        gs, ds = zip(*[s.render(i) for s in seqs])
        frames.append((np.stack([np.asarray(g) for g in gs]),
                       np.stack([np.asarray(d) for d in ds])))
    tr = MultiSequenceTracker(cfg, N_SEQ, device="cpu")
    for i, (g, d) in enumerate(frames):
        tr.track(g, d, np.full((N_SEQ,), i / 30.0))
    return cfg, frames, tr, tr.flush()


def test_all_sequences_track(multi_run):
    _, _, tr, flushed = multi_run
    assert len(flushed) == N_SEQ
    for s, f in enumerate(flushed):
        assert f["records"].shape == (N_FRAMES, 40)
        assert f["states"] == ["OK"] * N_FRAMES, (s, f["states"])
        assert f["records"][0, 19] == 1 and f["n_keyframes"] >= 2, s
    assert tr.readbacks == [[1] * N_SEQ] * N_FRAMES
    assert tr.carries.T_cw.shape == (N_SEQ, 4, 4)


def test_trajectories_diverge(multi_run):
    _, _, _, flushed = multi_run
    t0 = np.asarray([T[:3, 3] for _, T in flushed[0]["trajectory"]])
    t1 = np.asarray([T[:3, 3] for _, T in flushed[1]["trajectory"]])
    assert np.abs(t0 - t1).max() > 1e-3
    poses = synthetic.corridor_trajectory(N_FRAMES, step=0.02)
    gt = np.asarray([np.linalg.inv(p)[:3, 3] for p in poses])
    est = np.asarray([np.linalg.inv(T)[:3, 3]
                      for _, T in flushed[0]["trajectory"]])
    assert ate_rmse(est, gt) < 0.05


def test_matches_single_device_loop(multi_run):
    cfg, frames, _, flushed = multi_run
    single = DeviceLoopTracker(cfg, device="cpu")
    for i, (g, d) in enumerate(frames):
        single.track(g[1], d[1], i / 30.0)
    f1 = single.flush()
    np.testing.assert_array_equal(f1["records"], flushed[1]["records"])
    assert f1["n_keyframes"] == flushed[1]["n_keyframes"]
    assert f1["trajectory"][-1][0] == flushed[1]["trajectory"][-1][0]


def test_stacked_carries_and_the_card():
    cfg = to_port(small_cfg())
    c = stack_carries(cfg, 3, device="cpu")
    assert c.map_state.pt_pos.shape == (3, cfg.map.max_points, 3)
    assert c.ref_kf.shape == (3,) and c.lost.dtype == torch.bool
    assert MultiSequenceTracker(cfg, 2, device="cpu").flush()[1]["states"] == []
    if torch.cuda.is_available():
        assert MultiSequenceTracker(cfg, 2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MultiSequenceTracker(cfg, 2)


def test_mesh_matches_n_seq(multi_run):
    """One sequence per device of a two-entry CPU mesh: bit for bit the
    records of the n_seq=2 path."""
    from dr_slam_torch.parallel.sharded_ba import make_mesh

    cfg, frames, _, flushed = multi_run
    mesh = make_mesh(devices=["cpu"] * N_SEQ, axis="seq")
    tr = MultiSequenceTracker(cfg, mesh=mesh, axis="seq")
    assert tr.n == N_SEQ
    for i, (g, d) in enumerate(frames):
        tr.track(g, d, np.full((N_SEQ,), i / 30.0))
    for a, b in zip(tr.flush(), flushed):
        np.testing.assert_array_equal(a["records"], b["records"])
        assert a["states"] == b["states"]
        assert a["n_keyframes"] == b["n_keyframes"]
