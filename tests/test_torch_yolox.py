"""The port's YOLOX (dr_slam_torch/models/yolox.py) against the JAX package's
(dr_slam_tpu/models/yolox.py) on the CPU: the same weights bit for bit,
the same head tensors, the asymmetric "SAME" pad of the strided
convolutions, the decode golden and class-aware NMS with tied scores, the
shipped trained weights' gate, and the System's detector hook.

Tolerances: head tensors within 1e-6 (absolute) of JAX's at width 0.125
and 128x128 (observed 1.7e-8: float32 convolutions summed in another
order); decoded rows within 1e-5 relative; `select` on equal candidates is
exact; trained boxes at IoU > 0.9 from JAX's (observed 1.0)."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dr_slam_tpu.models import yolox as jy
from dr_slam_torch.models import yolox as ty
from torch_parity import load_script, small_cfg, to_port

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_WEIGHTS = os.path.join(ROOT, "dr_slam_tpu", "data", "yolox_synth.npz")
PORT_WEIGHTS = os.path.join(ROOT, "dr_slam_torch", "data", "yolox_synth.npz")


def _assert_params_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    assert a["meta"] == b["meta"]
    for k in a:
        if k == "meta":
            continue
        assert a[k].keys() == b[k].keys(), k
        for leaf in a[k]:
            x, y = np.asarray(a[k][leaf]), np.asarray(b[k][leaf])
            assert x.dtype == y.dtype and x.shape == y.shape, (k, leaf)
            assert x.tobytes() == y.tobytes(), (k, leaf)


def _net(params) -> ty.YOLOXNet:
    net = ty.YOLOXNet(params["meta"])
    net.load_state_dict(ty.params_to_state_dict(params))
    return net.requires_grad_(False)


@pytest.mark.parametrize("width", [0.125, 0.50])
def test_init_params_bit_equal(width):
    _assert_params_equal(jy.init_params(width_mul=width),
                         ty.init_params(width_mul=width))


def test_load_params_bit_equal():
    with open(JAX_WEIGHTS, "rb") as f, open(PORT_WEIGHTS, "rb") as g:
        assert f.read() == g.read()          # the shipped file, byte for byte
    p = ty.load_params(PORT_WEIGHTS)
    _assert_params_equal(jy.load_params(JAX_WEIGHTS), p)
    assert p["stem"]["w"].dtype == np.float32   # stored as float16


def test_heads_match_jax_at_128():
    params = jy.init_params(width_mul=0.125)
    img = np.random.RandomState(0).rand(128, 128, 3).astype(np.float32)
    want = jy._forward(params, jnp.asarray(img)[None])
    got = _net(params)(torch.from_numpy(img).permute(2, 0, 1)[None])
    for lvl, (w, g) in enumerate(zip(want, got)):
        for name, a, b in zip(("reg", "obj", "cls"), w, g):
            b = b.permute(0, 2, 3, 1).numpy()
            assert b.shape == np.asarray(a).shape
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=1e-6,
                                       err_msg=f"level {lvl} {name}")


def test_strided_same_pad_is_asymmetric():
    """XLA's "SAME" pads a stride-2 3x3 convolution over an even extent 0
    before and 1 after; the port must too. On an 8x8 input the symmetric
    pad (conv2d's padding=1) shifts the output by a pixel: its gap is well
    above 1, so this test fails for it."""
    params = jy.init_params(width_mul=0.125)
    net = _net(params)
    x = np.random.RandomState(1).randn(1, 8, 8, 8).astype(np.float32)
    want = np.asarray(jy._conv(jnp.asarray(x), params["down1"], 2))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = net.conv(xt, "down1", 2).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    m = net.convs["down1"]
    sym = F.silu(F.conv2d(xt, m.weight, m.bias, 2, padding=1))
    assert np.abs(sym.permute(0, 2, 3, 1).numpy() - want).max() > 1.0
    assert ty._same_pad(8, 3, 2) == (0, 1) and ty._same_pad(7, 3, 2) == (1, 1)


def _golden_heads(img=64):
    """tests/test_aux.py's decode golden: three detections at known cells,
    A and B of class 7 overlapping, C of class 3 at the same place."""
    HIGH, LOW = 8.0, -8.0
    outs = []
    for stride in jy.STRIDES:
        h = w = img // stride
        outs.append((np.zeros((1, h, w, 4), np.float32),
                     np.full((1, h, w, 1), LOW, np.float32),
                     np.full((1, h, w, 80), LOW, np.float32)))
    reg, obj, cls = outs[0]
    reg[0, 2, 3] = [0.5, 0.25, np.log(2.0), np.log(1.0)]
    obj[0, 2, 3, 0] = HIGH
    cls[0, 2, 3, 7] = HIGH
    reg[0, 2, 4] = [-0.5, 0.25, np.log(2.0), np.log(1.0)]
    obj[0, 2, 4, 0] = 2.0
    cls[0, 2, 4, 7] = HIGH
    reg[0, 2, 5] = [-1.5, 0.25, np.log(2.0), np.log(1.0)]
    obj[0, 2, 5, 0] = HIGH
    cls[0, 2, 5, 3] = HIGH
    return outs


def test_decode_golden():
    outs = _golden_heads()
    want = np.asarray(jy._decode([tuple(map(jnp.asarray, o)) for o in outs],
                                 64))
    got = ty.decode([tuple(torch.from_numpy(np.ascontiguousarray(
        t.transpose(0, 3, 1, 2))) for t in o) for o in outs])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    sel = ty.select(got, score_th=0.3, iou_th=0.45, max_det=8)
    valid = sel.valid.numpy()
    boxes = sel.boxes.numpy()[valid]
    assert valid.sum() == 2
    s0 = jy.STRIDES[0]
    cx, cy = (3 + 0.5) * s0, (2 + 0.25) * s0
    expA = np.asarray([cx - s0, cy - s0 / 2, cx + s0, cy + s0 / 2])
    assert np.abs(boxes - expA).max(-1).min() < 1e-3
    assert set(sel.classes.numpy()[valid].tolist()) == {7, 3}
    assert sel.classes.dtype == torch.int32


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_with_tied_scores_matches_jax(seed):
    """Scores on a coarse grid (many exact ties, across and under the
    threshold), overlapping boxes of a few classes: top-k order, the NMS
    and the kept-first order equal JAX's exactly."""
    rng = np.random.RandomState(seed)
    m = 400
    xy = rng.uniform(0, 200, (m, 2))
    wh = rng.uniform(10, 60, (m, 2))
    dets = np.concatenate([
        xy, xy + wh, rng.randint(0, 8, (m, 1)) / 8.0,
        rng.randint(0, 3, (m, 1))], -1).astype(np.float32)
    want = jy._select(jnp.asarray(dets), 0.3, 0.45)
    got = ty.select(torch.from_numpy(dets), 0.3, 0.45)
    assert int(np.asarray(want.valid).sum()) > 5
    for f in ("boxes", "scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_detect_matches_jax_random_weights():
    """The facade at 128 (width 0.125 random weights) on a 120x160 image:
    the resize, the network, decode and select, against JAX's detect."""
    params = jy.init_params(width_mul=0.125)
    jdet = jy.YOLOX(input_size=128)
    jdet.params = params
    tdet = ty.YOLOX(input_size=128, device="cpu")
    tdet.net = _net(params)
    rgb = (np.random.RandomState(2).rand(120, 160, 3) * 255).astype(np.float32)
    want = jdet.detect(jnp.asarray(rgb))
    got = tdet.detect(rgb)
    assert got.boxes.shape == (32, 4)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes),
                               rtol=1e-5, atol=1e-3)
    resized = tdet.resize(rgb).permute(1, 2, 0).numpy()
    ref = np.asarray(jy.jax.image.resize(jnp.asarray(rgb), (128, 128, 3),
                                         "bilinear"))
    np.testing.assert_allclose(resized, ref, rtol=0, atol=1e-3)


def test_trained_weights_gate_and_box_parity():
    """tests/test_yolox_detect.py's gate on the port (every ground-truth
    person at IoU > 0.4 in 80% of cases, at most 2 extra boxes per image)
    over the same RandomState(123) scenes, and every port box at IoU > 0.9
    from the JAX box of its class."""
    from dr_slam_torch._smoke import box_iou, synth_gate

    trainer = load_script("train_yolox")
    jdet = jy.YOLOX(weights=JAX_WEIGHTS, input_size=trainer.SIZE,
                    score_th=0.4)
    tdet = ty.YOLOX(weights=PORT_WEIGHTS, input_size=trainer.SIZE,
                    score_th=0.4, device="cpu")
    rng = np.random.RandomState(123)
    preds, gts, ns, worst = [], [], [], 1.0
    for _ in range(6):
        img, boxes, n = trainer.render_scene(rng)
        want, got = jdet.detect(img * 255.0), tdet.detect(img * 255.0)
        wv, gv = np.asarray(want.valid), got.valid.numpy()
        assert wv.sum() == gv.sum()
        wb, wc = np.asarray(want.boxes)[wv], np.asarray(want.classes)[wv]
        for b, c in zip(got.boxes.numpy()[gv], got.classes.numpy()[gv]):
            worst = min(worst, max(box_iou(b, q) for q, qc in zip(wb, wc)
                                   if qc == c))
        preds.append(got.boxes.numpy()[gv])
        gts.append(boxes)
        ns.append(n)
    gate = synth_gate(preds, np.stack(gts), np.asarray(ns))
    assert gate["ok"], gate
    assert worst > 0.9, worst


def test_system_calls_an_injected_detector():
    """The fake detector of tests/test_aux.py: called at the init keyframe
    with the frame as (H, W, 3), its output exposed as last_detections."""
    from dr_slam_tpu.io import synthetic
    from dr_slam_torch.slam.system import System

    calls = []

    class FakeDetector:
        def detect(self, rgb):
            calls.append(tuple(rgb.shape))
            return ty.Detections(boxes=torch.zeros(1, 4),
                                 scores=torch.ones(1),
                                 classes=torch.zeros(1, dtype=torch.int32),
                                 valid=torch.ones(1, dtype=torch.bool))

    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(3),
                                      K4=cfg.camera.K4, height=240, width=320)
    sysm = System(to_port(cfg), enable_loop_closing=False,
                  detector=FakeDetector(), device="cpu")
    for i in range(3):
        gray, depth = seq.render(i)
        sysm.track_rgbd(np.asarray(gray), np.asarray(depth), i / 30.0)
    assert len(calls) >= 1 and calls[0] == (240, 320, 3)
    assert sysm.last_detections is not None


def test_system_runs_the_trained_detector():
    """tests/test_yolox_detect.py's System test on the port: YOLOX at 256
    with the shipped weights over 12 corridor frames runs at the keyframe
    and exposes its detections."""
    from dr_slam_tpu.io import synthetic
    from dr_slam_torch.slam.system import System

    cfg = small_cfg()
    det = ty.YOLOX(weights=PORT_WEIGHTS, input_size=256, score_th=0.4,
                   device="cpu")
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(12),
                                      K4=cfg.camera.K4,
                                      height=cfg.camera.height,
                                      width=cfg.camera.width)
    sys_ = System(to_port(cfg), detector=det, enable_loop_closing=False,
                  device="cpu")
    saw = False
    for i in range(12):
        g, d = seq.render(i)
        sys_.track_rgbd(np.asarray(g), np.asarray(d), i / 30.0)
        saw = saw or sys_.last_detections is not None
    assert saw
    out = sys_.last_detections
    assert out.boxes.shape == (32, 4) and out.valid.dtype == torch.bool
    assert torch.isfinite(out.boxes).all()


def test_yolox_needs_a_card_or_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ty.YOLOX(input_size=64)
