"""The port's synthetic renderer (dr_slam_torch/io/synthetic.py) and its
scripts (scripts/run_synthetic_torch.py, scripts/train_vocab_torch.py
without --tum) against the JAX package on the CPU.

Tolerances: trajectories, clutter and the map state's integer tables
exact; gray and depth bit-equal to the JAX package's jitted
`render_frame` (the port rounds every product, fused multiply-add, sum,
sin and cos as XLA's CPU code does) at 160x120, 320x240 and 640x480, with
depth noise too, and so on the corridor frames where the bench legs once
parted from JAX's runs; the surface index also exact against a float64
reference away from ties (pixels whose two nearest surfaces lie within
1e-4 relative of each other, under 1%); the map state's floats within
1e-5."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic as js
from dr_slam_torch import _smoke
from dr_slam_torch.associate import vocabulary as tvoc
from dr_slam_torch.io import synthetic as ts
from dr_slam_torch.io.tum import RGBDFrame
from dr_slam_torch.utils.prng import PRNGKey

from torch_parity import load_script, small_cfg, to_port

torch.set_num_threads(2)

SIZES = {(120, 160): (133.85, 134.8, 80.05, 61.8),
         (240, 320): (267.7, 269.6, 160.0, 120.0),
         (480, 640): (535.4, 539.2, 320.1, 247.6)}


def _scene(name):
    """(JAX room, port room, poses, boxes, quadratic noise) of a scene."""
    if name == "corridor":
        return js.BoxRoom(), ts.BoxRoom(), js.corridor_trajectory(40), None, \
            False
    if name == "clutter":
        return js.BoxRoom(), ts.BoxRoom(), js.loop_trajectory(40), \
            js.office_clutter(n_boxes=6, seed=3), True
    small = dict(xmax=2.6, ymax=2.2, zmax=3.4)
    return js.BoxRoom(**small), ts.BoxRoom(**small), \
        js.corridor_trajectory(40, room=js.BoxRoom(**small), step=0.012), \
        js.office_clutter(js.BoxRoom(**small), n_boxes=4, seed=11), True


def test_trajectories_and_clutter_bit_equal():
    for n in (1, 24, 40):
        np.testing.assert_array_equal(ts.corridor_trajectory(n),
                                      js.corridor_trajectory(n))
        np.testing.assert_array_equal(ts.loop_trajectory(n),
                                      js.loop_trajectory(n))
    small_j, small_t = js.BoxRoom(2.6, 2.2, 3.4), ts.BoxRoom(2.6, 2.2, 3.4)
    np.testing.assert_array_equal(
        ts.corridor_trajectory(30, room=small_t, step=0.012, yaw_amp=0.1),
        js.corridor_trajectory(30, room=small_j, step=0.012, yaw_amp=0.1))
    np.testing.assert_array_equal(ts.loop_trajectory(30, room=small_t),
                                  js.loop_trajectory(30, room=small_j))
    for kw in (dict(), dict(n_boxes=6, seed=3)):
        np.testing.assert_array_equal(ts.office_clutter(**kw),
                                      js.office_clutter(**kw))
    np.testing.assert_array_equal(ts.office_clutter(small_t, 4, 11),
                                  js.office_clutter(small_j, 4, 11))
    np.testing.assert_array_equal(ts.BoxRoom(7, 3.5, 10).planes(),
                                  js.BoxRoom(7, 3.5, 10).planes())


def _surface_ref(T_cw, planes, K4, H, W, boxes):
    """float64 nearest surface per pixel -> (index as the renderer numbers
    it, -1 on a miss; True where the two nearest candidates are within
    1e-4 relative, or a box's entry face is ambiguous)."""
    T_wc = np.linalg.inv(T_cw.astype(np.float64))
    o = T_wc[:3, 3]
    fx, fy, cx, cy = K4
    vv, uu = np.mgrid[0:H, 0:W].astype(np.float64)
    d = np.stack([(uu - cx) / fx, (vv - cy) / fy, np.ones_like(uu)],
                 -1) @ T_wc[:3, :3].T
    ts_, ids, amb = [], [], np.zeros((H, W), bool)
    for p, pl in enumerate(planes.astype(np.float64)):
        den = d @ pl[:3]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = -(o @ pl[:3] + pl[3]) / den
        ts_.append(np.where((t > 1e-3) & (den < 0), t, np.inf))
        ids.append(np.full((H, W), p))
    for b in ([] if boxes is None else boxes.astype(np.float64)):
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (b[:3] - o) / d
            t2 = (b[3:] - o) / d
        tn_ax = np.minimum(t1, t2)
        tn, tf = tn_ax.max(-1), np.maximum(t1, t2).min(-1)
        hit = (tf > np.maximum(tn, 1e-3)) & (tn > 1e-3)
        ts_.append(np.where(hit, tn, np.inf))
        ids.append(2 * tn_ax.argmax(-1))
        srt = np.sort(tn_ax, -1)
        amb |= hit & (srt[..., 2] - srt[..., 1] <= 1e-4 * np.abs(srt[..., 2]))
    t_all = np.stack(ts_, -1)
    order = np.argsort(t_all, -1, kind="stable")
    best = np.take_along_axis(t_all, order[..., :1], -1)[..., 0]
    second = np.take_along_axis(t_all, order[..., 1:2], -1)[..., 0]
    idx = np.take_along_axis(np.stack(ids, -1), order[..., :1], -1)[..., 0]
    amb |= np.isfinite(best) & (second - best <= 1e-4 * best)
    return np.where(np.isfinite(best), idx, -1), amb


def _assert_bits_equal(got: np.ndarray, want: np.ndarray, what: str):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    bad = got.view(np.int32) != want.view(np.int32)
    assert not bad.any(), (what, int(bad.sum()),
                           float(np.abs(got - want).max()))


@pytest.mark.parametrize("size", list(SIZES),
                         ids=["160x120", "320x240", "640x480"])
@pytest.mark.parametrize("name", ["corridor", "clutter", "small_room"])
def test_render_frame(name, size):
    H, W = size
    K4 = SIZES[size]
    jroom, troom, poses, boxes, qnoise = _scene(name)
    i = 13
    jb = None if boxes is None else jnp.asarray(boxes)
    tb = None if boxes is None else torch.from_numpy(boxes)
    T = poses[i]
    g, d = js.render_frame(jnp.asarray(T), jnp.asarray(jroom.planes()), K4,
                           H, W, boxes=jb, quadratic_noise=qnoise)
    g, d = np.asarray(g), np.asarray(d)
    tg, td = ts.render_frame(torch.from_numpy(T),
                             torch.from_numpy(troom.planes()), K4, H, W,
                             boxes=tb, quadratic_noise=qnoise)
    tg, td = tg.numpy(), td.numpy()
    assert tg.shape == (H, W)
    assert (d > 0).mean() > 0.99
    _assert_bits_equal(td, d, "depth")
    _assert_bits_equal(tg, g, "gray")
    t_hit, idx, *_ = ts._intersect(torch.from_numpy(T),
                                   torch.from_numpy(troom.planes()), K4, H,
                                   W, tb)
    ref, amb = _surface_ref(T, troom.planes(), K4, H, W, boxes)
    assert amb.mean() < 0.01
    got = torch.where(torch.isfinite(t_hit), idx, -1).numpy()
    np.testing.assert_array_equal(got[~amb], ref[~amb])
    if boxes is not None:
        assert (ref[d > 0] >= 0).all()


@pytest.mark.parametrize("name", ["corridor", "clutter"])
def test_depth_noise(name):
    jroom, troom, poses, boxes, qnoise = _scene(name)
    K4 = SIZES[(120, 160)]
    jb = None if boxes is None else jnp.asarray(boxes)
    tb = None if boxes is None else torch.from_numpy(boxes)
    for i in (0, 7):
        _, d = js.render_frame(jnp.asarray(poses[i]),
                               jnp.asarray(jroom.planes()), K4, 120, 160,
                               depth_noise_key=jax.random.PRNGKey(i),
                               boxes=jb, quadratic_noise=qnoise)
        _, clean = js.render_frame(jnp.asarray(poses[i]),
                                   jnp.asarray(jroom.planes()), K4, 120, 160,
                                   boxes=jb)
        _, td = ts.render_frame(torch.from_numpy(poses[i]),
                                torch.from_numpy(troom.planes()), K4, 120,
                                160, depth_noise_key=PRNGKey(i), boxes=tb,
                                quadratic_noise=qnoise)
        d = np.asarray(d)
        assert np.abs(d - np.asarray(clean)).max() > 1e-4
        _assert_bits_equal(td.numpy(), d, "noisy depth")


@pytest.mark.parametrize("frame", [27, 30, 33, 59, 60, 61])
def test_bench_corridor_frames(frame):
    """bench.py's corridor at 640x480 on the frames where, on the port's
    renders of old, the device loop parted from JAX's run (27, 30, 33:
    inliers; 59-61: the first frames apart): gray and depth bit-equal."""
    K4 = SIZES[(480, 640)]
    T = js.corridor_trajectory(frame + 1)[frame]
    g, d = js.render_frame(jnp.asarray(T), jnp.asarray(js.BoxRoom().planes()),
                           K4, 480, 640)
    tg, td = ts.render_frame(torch.from_numpy(T),
                             torch.from_numpy(ts.BoxRoom().planes()), K4,
                             480, 640)
    _assert_bits_equal(td.numpy(), np.asarray(d), "depth")
    _assert_bits_equal(tg.numpy(), np.asarray(g), "gray")


def test_synthetic_map_state():
    jcfg = small_cfg()
    jst, jposes = js.synthetic_map_state(jcfg, 32, seed=2)
    tst, tposes = ts.synthetic_map_state(to_port(jcfg), 32, seed=2,
                                         device="cpu")
    np.testing.assert_array_equal(tposes, jposes)
    assert tst._fields == jst._fields
    for f in jst._fields:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        assert a.shape == b.shape, f
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-5, err_msg=f)
    assert int(tst.n_kfs) == 32 and int(tst.kf_kp_valid.sum()) > 5000


def test_sequence_frames():
    seq = ts.SyntheticSequence(ts.corridor_trajectory(3), height=120,
                               width=160, K4=SIZES[(120, 160)],
                               depth_noise=True, device="cpu")
    jseq = js.SyntheticSequence(js.corridor_trajectory(3), height=120,
                                width=160, K4=SIZES[(120, 160)],
                                depth_noise=True)
    assert len(seq) == 3
    fr = seq[2]
    assert isinstance(fr, RGBDFrame) and isinstance(fr.gray, np.ndarray)
    assert fr.timestamp == 2 / 30.0 and fr.depth.shape == (120, 160)
    jfr = jseq[2]
    _assert_bits_equal(fr.depth, jfr.depth, "depth")
    _assert_bits_equal(fr.gray, jfr.gray, "gray")
    g, d = seq.render(2)
    assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.SyntheticSequence(ts.corridor_trajectory(2))


def test_run_synthetic_script(tmp_path):
    """scripts/run_synthetic_torch.py at full size on the CPU, 3 frames:
    the summary keys of scripts/run_synthetic.py, no frame LOST."""
    fx = _smoke.load_synth_fixture()
    want = json.loads(str(fx["run_summary"]))
    run = load_script("run_synthetic_torch")
    with _smoke.shipped_codebooks():
        got = run.main(["--frames", "3", "--device", "cpu",
                        "--out", str(tmp_path)])
    assert list(got) == list(want)
    assert got["frames"] == 3 and got["lost_frames"] == 0
    assert got["ate_rmse_m"] < 0.05 and got["n_keyframes"] >= 1


def test_train_vocab_synthetic(tmp_path):
    """scripts/train_vocab_torch.py without --tum: the five synthetic scene
    families, every second frame of 4."""
    out = str(tmp_path / "v64.npz")
    train = load_script("train_vocab_torch")
    words = train.main(["--frames", "4", "--words", "64", "--iters", "2",
                        "--out", out, "--device", "cpu"])
    assert words.shape == (64, 8)
    with np.load(out) as data:
        assert data["words"].shape == (64, 8)
    with _smoke.shipped_codebooks():
        tvoc.load_vocabulary(out)
        assert tvoc.get_codebook_signs(64).shape == (64, 256)
        np.testing.assert_array_equal(tvoc.get_codebook_signs(64),
                                      tvoc.words_to_signs(words))
    assert os.path.exists(out)
