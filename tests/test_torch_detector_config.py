"""The per-frame detector of the port's configuration on the CPU: YOLOX-s
against the benchmark's plain reference (slam_bench/yolox_reference.py),
`launch` + `resolve` against
the one-readback `select`, the preset's detector group, and a System built
from `tum_freiburg3_yolox()` at the tests' small camera with the detector's
input at 128. The one test marked `cuda` runs the detector's stream on the
card (the file imports nothing of JAX):

    python -m pytest --noconftest tests/test_torch_detector_config.py -q

Tolerances: head tensors within 1e-6 of the reference, absolute (observed
4.5e-8: float32 convolutions summed in another order, SiLU written as
x * sigmoid(x), the pad as its own op); decoded rows within 1e-5 relative
and 1e-5 px (observed 7.6e-6 px: exp and the stride scale the heads' gap);
class labels equal wherever the best class leads the second by more than
1e-6. Everything else is exact."""

import dataclasses

import numpy as np
import pytest
import torch

from dr_slam_torch import config as C, to_numpy
from dr_slam_torch.io import synthetic
from dr_slam_torch.models import yolox as ty
from dr_slam_torch.slam.system import System
from dr_slam_torch.utils.profiling import PROFILER
from slam_bench import yolox_reference as plain

torch.set_num_threads(2)
SIZE = 128
FRAMES = 4


def _frame(seed: int, h: int = 96, w: int = SIZE) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(h, w, 3, generator=g) * 255.0


def _numpy(d: ty.Detections) -> dict:
    return {k: getattr(d, k).numpy() for k in d._fields}


@pytest.mark.parametrize("seed", [0, 3])
def test_yolox_s_matches_the_plain_reference(seed):
    det = ty.YOLOX(input_size=SIZE, device="cpu")
    sd = det.net.state_dict()
    img = det.resize(_frame(seed))
    port = det.heads(img)
    ref = plain.heads(sd, img[None])
    for lvl, (got, want) in enumerate(zip(port, ref)):
        for a, b in zip(got, want):
            assert a.shape == b.shape
            assert float((a - b).abs().max()) < 1e-6, lvl
    rows, want = ty.decode(port), plain.decode(ref)
    assert rows.shape == want.shape == (
        sum((SIZE // s) ** 2 for s in ty.STRIDES), 6)
    np.testing.assert_allclose(rows[:, :5].numpy(), want[:, :5].numpy(),
                               rtol=1e-5, atol=1e-5)
    probs = torch.cat([torch.sigmoid(c[0].flatten(1).T) for _, _, c in ref])
    top2 = probs.topk(2, 1).values
    clear = (top2[:, 0] - top2[:, 1]) > 1e-6
    assert clear.float().mean() > 0.9
    assert torch.equal(rows[clear, 5], want[clear, 5])


def test_launch_and_resolve_equal_one_readback_select():
    det = ty.YOLOX(input_size=SIZE, device="cpu", score_th=0.0)
    rgb = _frame(1)
    got = det.resolve(det.launch(rgb))
    assert det.launches == 1
    want = ty.select(ty.decode(det.heads(det.resize(rgb))), 0.0, det.iou_th)
    g, w = _numpy(got), _numpy(want)
    assert g["valid"].any()
    for k in w:
        assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes()
    d = _numpy(det.detect(rgb))
    assert all(d[k].tobytes() == w[k].tobytes() for k in w)
    assert det.launches == 2


def test_preset_states_yolox_s_as_published():
    cfg = C.tum_freiburg3_yolox()
    assert dataclasses.asdict(cfg.detector) == {
        "depth_mul": 0.33, "width_mul": 0.50, "input_size": 640,
        "score_th": 0.3, "iou_th": 0.45, "weights": None}
    assert cfg.replace(detector=None) == C.tum_freiburg3()
    assert C.tum_freiburg3().detector is None
    meta = ty.init_params(cfg.detector.depth_mul,
                          cfg.detector.width_mul)["meta"]
    assert meta == {"widths": [32, 64, 128, 256, 512],
                    "depths": [1, 3, 3, 1]}
    s = cfg.detector.input_size
    assert sum((s // st) ** 2 for st in ty.STRIDES) == 8400
    assert ty.COCO_CLASSES == 80


def _small(detector: bool) -> C.SlamConfig:
    """tests/torch_parity.py's small configuration (320x240, 512
    keypoints), from the preset with the detector's input at 128."""
    cfg = C.tum_freiburg3_yolox() if detector else C.tum_freiburg3()
    cfg = cfg.replace(
        camera=C.CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                              width=320, height=240, bf=20.0),
        orb=C.ORBConfig(n_features=400, n_levels=4, max_keypoints=512),
        line=C.LineConfig(max_lines=32),
        map=C.MapConfig(max_points=4096, max_lines=512, max_planes=32,
                        max_keyframes=32, vocab_words=512))
    if detector:
        cfg = cfg.replace(detector=dataclasses.replace(cfg.detector,
                                                       input_size=SIZE))
    return cfg


@pytest.fixture(scope="module")
def frames():
    cam = _small(False).camera
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(FRAMES),
                                      K4=cam.K4, height=cam.height,
                                      width=cam.width, device="cpu")
    return [tuple(t.numpy() for t in seq.render(i)) for i in range(FRAMES)]


def _run(system, frames, each=None) -> np.ndarray:
    poses = []
    for i, (g, d) in enumerate(frames):
        poses.append(np.array(to_numpy(system.track_rgbd(g, d, i / 30.0).T_cw)))
        if each:
            each(i)
    system.tracker.flush()
    return np.stack(poses)


def test_system_detects_every_frame_from_the_configuration(frames):
    plain_sys = System(_small(False), enable_loop_closing=False, device="cpu")
    assert plain_sys.detector is None
    want_poses = _run(plain_sys, frames)

    system = System(_small(True), enable_loop_closing=False, device="cpu")
    det = system.detector
    assert isinstance(det, ty.YOLOX) and det.input_size == SIZE
    seen = []
    poses = _run(system, frames, lambda i: seen.append(
        (det.launches, system.last_detections)))
    # the poses are those of the same System without a detector
    assert np.array_equal(poses, want_poses)
    # one launch per frame; the detections one frame behind until shutdown
    assert [n for n, _ in seen] == list(range(1, FRAMES + 1))
    assert seen[0][1] is None
    system.shutdown()
    assert det.launches == FRAMES
    seen = [d for _, d in seen[1:]] + [system.last_detections]
    for i, got in enumerate(seen):
        g = torch.from_numpy(frames[i][0])
        want = _numpy(det.detect(torch.stack([g, g, g], -1)))
        got = _numpy(got)
        assert all(got[k].tobytes() == want[k].tobytes() for k in want), i

    # a detector handed in keeps the keyframe-event cadence: the first
    # frame's keyframe, not the second frame
    calls = []

    class Recording:
        def detect(self, rgb):
            calls.append(handed.tracker.frame_id)
            return det.detect(rgb)

    rec = Recording()
    handed = System(_small(True), enable_loop_closing=False, detector=rec,
                    device="cpu")
    launches = det.launches
    assert np.array_equal(want_poses[:2], _run(handed, frames[:2]))
    assert handed.detector is rec and calls == [0]
    assert det.launches == launches + 1 and len(handed.tracker.kf_log) == 1


@pytest.mark.cuda
def test_detector_stream_on_the_card():
    """On the card `launch` runs on the detector's own stream and returns
    without a wait; `resolve` gives what `select` gives on the caller's
    stream, bit for bit, waits (one sync, counted) only for a frame not
    yet done, and the profiler times the network on the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    det = ty.YOLOX(input_size=640, device=dev, score_th=0.0)
    rgb = _frame(2, 480, 640).to(dev)
    want = _numpy_cpu(ty.select(ty.decode(det.heads(det.resize(rgb))), 0.0,
                                det.iou_th))
    PROFILER.enable()
    PROFILER.reset()
    try:
        with PROFILER.span("frame"):
            pending = det.launch(rgb)
            assert det._stream is not None
            torch.cuda.synchronize()
            done = det.resolve(pending)
            late = det.resolve(det.launch(rgb))
        spans = PROFILER.summary()
    finally:
        PROFILER.disable()
    for got in (done, late):
        got = _numpy_cpu(got)
        assert all(got[k].tobytes() == want[k].tobytes() for k in want)
    assert spans["frame"]["syncs"] <= 1
    net = spans["detect.net"]
    assert net["count"] + net["pending"] == 2 and net["count"] >= 1
    assert net["device_ms"] > 0 and net["syncs"] == 0


def _numpy_cpu(d: ty.Detections) -> dict:
    return {k: getattr(d, k).cpu().numpy() for k in d._fields}
