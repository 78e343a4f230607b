"""TUM dataset I/O, the native loader and the dataset runner of the port
against the JAX package, on a 12-frame synthetic corridor at the small
config of tests/test_tracking_e2e.py (320x240) exported as a TUM sequence
by each package.

- The exports are byte-identical: the four text files (rgb.txt, depth.txt,
  associate.txt, groundtruth.txt, whose T_wc rows come from each package's
  own `pose_to_tum_row`) and the PNGs (both written by Pillow).
- Each package's reader decodes the other's PNGs to equal arrays (gray
  float32, depth d16 / depth_factor in float32): exact.
- `associate`, `parse_associations` and `load_groundtruth` give equal
  results, `associate` on listings with jittered and missing depth stamps.
- scripts/run_tum_torch.py (--device cpu) against scripts/run_tum.py, each
  over its own package's export, the JAX System's deferred decision made
  to lag by exactly one frame as the port's does on the CPU: per-frame
  states, keyframe flags, reference keyframes and counts exact, the map
  summary equal, T_cw within 3e-3 (the bound of the other tracking tests:
  the keyframes' local BA sums in another order; observed 1.25e-4), the
  saved trajectories' timestamps exact and rows within 3e-3 (observed
  4.9e-4, the keyframe rows after the BA), the ATE within 1e-3 of JAX's
  (observed: equal at the summary's four decimals, 0.0072 m).
- The native loader (csrc/frame_loader.cpp, built with g++) yields frames
  equal to the Python reader's, exactly; a palette PNG, which its decoder
  rejects, comes from the reader instead, and an unreadable file raises.
  Skips where the loader cannot be built (as tests/test_tum_e2e.py
  does)."""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.io import tum as jtum
from dr_slam_torch._smoke import track_rgbd_hook
from dr_slam_torch.config import load_config
from dr_slam_torch.io import native_loader as tnative
from dr_slam_torch.io import tum as ttum

from torch_parity import (jax_system_lagged_by_one, load_script, small_cfg,
                          to_port, write_small_yaml)

torch.set_num_threads(2)

N = 12
T_TOL = 3e-3
TEXT_FILES = ("rgb.txt", "depth.txt", "associate.txt", "groundtruth.txt")


@pytest.fixture(scope="module")
def seqs(tmp_path_factory):
    cfg = small_cfg()
    poses = synthetic.corridor_trajectory(N, step=0.03)
    seq = synthetic.SyntheticSequence(poses, K4=cfg.camera.K4, height=240,
                                      width=320)
    frames = [tuple(np.asarray(x) for x in seq.render(i)) for i in range(N)]
    root = tmp_path_factory.mktemp("tum")
    jdir = jtum.export_tum_sequence(str(root / "jax"), poses,
                                    lambda i: frames[i])
    tdir = ttum.export_tum_sequence(str(root / "port"), poses,
                                    lambda i: frames[i])
    return dict(cfg=cfg, frames=frames, jdir=jdir, tdir=tdir, root=root)


def test_export_byte_identical(seqs):
    jdir, tdir = seqs["jdir"], seqs["tdir"]
    for name in TEXT_FILES:
        with open(os.path.join(jdir, name), "rb") as a, \
                open(os.path.join(tdir, name), "rb") as b:
            assert a.read() == b.read(), name
    rows = jtum.parse_associations(os.path.join(jdir, "associate.txt"))
    assert len(rows) == N
    for _, rgb, _, depth in rows:
        for rel in (rgb, depth):
            with open(os.path.join(jdir, rel), "rb") as a, \
                    open(os.path.join(tdir, rel), "rb") as b:
                assert a.read() == b.read(), rel


def test_readers_decode_each_others_pngs(seqs):
    jds = jtum.TUMDataset(seqs["tdir"])
    tds = ttum.TUMDataset(seqs["jdir"])
    assert len(jds) == len(tds) == N and tds.rows == jds.rows
    for i in (0, 5, N - 1):
        a, b = jds[i], tds[i]
        assert a.timestamp == b.timestamp
        for f in ("gray", "depth"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype == np.float32, f
            np.testing.assert_array_equal(y, x, err_msg=f)
        g, d = seqs["frames"][i]
        np.testing.assert_array_equal(
            b.gray, np.clip(g + 0.5, 0, 255).astype(np.uint8))
        assert b.depth.max() > 0


def test_association_and_groundtruth(seqs, tmp_path):
    rng = np.random.RandomState(4)
    t_rgb = 1000.0 + np.arange(40) / 30.0
    t_depth = t_rgb + rng.uniform(-0.03, 0.03, 40)
    keep = rng.rand(40) < 0.85
    for name, ts in (("rgb.txt", t_rgb), ("depth.txt", t_depth[keep])):
        with open(tmp_path / name, "w") as f:
            f.write("# timestamp filename\n\n")
            f.writelines(f"{t:.6f} {name[:-4]}/{t:.6f}.png\n" for t in ts)
    args = str(tmp_path / "rgb.txt"), str(tmp_path / "depth.txt")
    want = jtum.associate(*args)
    assert 10 < len(want) < 40
    assert ttum.associate(*args) == want
    assert ttum.associate(*args, max_dt=0.01) == jtum.associate(*args,
                                                                max_dt=0.01)
    a = os.path.join(seqs["jdir"], "associate.txt")
    assert ttum.parse_associations(a) == jtum.parse_associations(a)
    # a sequence without associate.txt pairs its listings
    bare = str(tmp_path / "bare")
    shutil.copytree(seqs["jdir"], bare)
    os.remove(os.path.join(bare, "associate.txt"))
    assert ttum.TUMDataset(bare).rows == jtum.TUMDataset(bare).rows
    gt = os.path.join(seqs["jdir"], "groundtruth.txt")
    (jt, jp), (tt, tp) = jtum.load_groundtruth(gt), ttum.load_groundtruth(gt)
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tp, jp)
    assert tp.shape == (N, 7)


def test_runner_matches_run_tum(seqs, tmp_path, capsys):
    yaml = write_small_yaml(tmp_path / "small.yaml")
    assert load_config(yaml) == to_port(small_cfg())
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    run_tum = load_script("run_tum")
    argv = ["run_tum.py", seqs["jdir"], "--config", yaml, "--out", jout]
    saved, sys.argv = sys.argv, argv
    try:
        with jax_system_lagged_by_one() as jcalls:
            run_tum.main()
    finally:
        sys.argv = saved
    jsum = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    pcalls = []
    with track_rgbd_hook(lambda r, s: pcalls.append((r, s.tracker.ref_kf))):
        tsum = load_script("run_tum_torch").main(
            [seqs["tdir"], "--config", yaml, "--out", tout, "--device",
             "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == tsum
    assert len(jcalls) == len(pcalls) == N
    for i, ((j, jref, _), (t, tref)) in enumerate(zip(jcalls, pcalls)):
        got = (t.state.name, t.is_keyframe, tref, t.n_inliers, t.n_matches)
        want = (j.state.name, j.is_keyframe, jref, j.n_inliers, j.n_matches)
        assert got == want, (i, got, want)
        np.testing.assert_allclose(np.asarray(t.T_cw), np.asarray(j.T_cw),
                                   rtol=0, atol=T_TOL, err_msg=f"frame {i}")
    assert sum(r.is_keyframe for r, _ in pcalls) >= 1
    ate_j, ate_t = jsum.pop("ate_rmse_m"), tsum.pop("ate_rmse_m")
    assert abs(ate_t - ate_j) <= 1e-3 and ate_t < 0.05
    jsum.pop("fps"), tsum.pop("fps")
    assert tsum == jsum
    for name in ("CameraTrajectory.txt", "KeyFrameTrajectory.txt"):
        a = np.loadtxt(os.path.join(jout, name), ndmin=2)
        b = np.loadtxt(os.path.join(tout, name), ndmin=2)
        assert a.shape == b.shape and len(a) >= 1, name
        np.testing.assert_array_equal(b[:, 0], a[:, 0])
        np.testing.assert_allclose(b[:, 1:], a[:, 1:], rtol=0, atol=T_TOL)


def test_native_loader_matches_the_reader(seqs, tmp_path):
    if not tnative.build_native():
        pytest.skip("the native loader cannot be built here (g++, zlib)")
    from PIL import Image

    root = str(tmp_path / "seq")
    shutil.copytree(seqs["tdir"], root)
    ds = ttum.TUMDataset(root)
    # frame 2's gray as a palette PNG: the C++ decoder rejects it
    p2 = os.path.join(root, ds.rows[2][1])
    g8 = ds[2].gray.astype(np.uint8)
    img = Image.frombytes("P", (g8.shape[1], g8.shape[0]), g8.tobytes())
    img.putpalette([v for i in range(256) for v in (i, i, i)])
    img.save(p2)
    loader = tnative.NativeTUMLoader(ds)
    seen = []
    try:
        for idx, ts, gray, depth in loader:
            ref = ds[idx]
            assert ts == ref.timestamp
            np.testing.assert_array_equal(gray, ref.gray)
            np.testing.assert_array_equal(depth, ref.depth)
            seen.append(idx)
    finally:
        loader.close()
    assert seen == list(range(N))
    np.testing.assert_array_equal(
        ds[2].gray, ttum.TUMDataset(seqs["tdir"])[2].gray)
    # an unreadable frame raises instead of yielding a black frame
    with open(os.path.join(root, ds.rows[4][3]), "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n truncated")
    loader = tnative.NativeTUMLoader(ds)
    with pytest.raises(Exception):
        try:
            for _ in loader:
                pass
        finally:
            loader.close()
