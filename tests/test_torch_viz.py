"""The port's viewers (dr_slam_torch/viz/viewer.py, viz/live.py) on the CPU:
the frame overlay with detections, the map render with keyframe frusta,
and the live viewer over a short port System, whose /state.json counts
equal the JAX System's live viewer on the same frames; the System's viewer
flags attach instead of raising."""

import dataclasses
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from dr_slam_tpu.io import synthetic
from dr_slam_tpu.slam.system import System as JSystem
from dr_slam_torch.frontend.frame import extract_frame
from dr_slam_torch.models.yolox import Detections
from dr_slam_torch.slam.system import System
from dr_slam_torch.viz.viewer import Viewer, draw_frame_overlay, map_view
from torch_parity import small_cfg, to_port, wait_pending

torch.set_num_threads(2)


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.status, r.headers.get("Content-Type"), r.read()


def test_frame_overlay_with_detections(tmp_path):
    """FrameDrawer: keypoints, lines, the plane mask and the YOLOX boxes
    (src/FrameDrawer.cc:35,219), from the port's features."""
    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(1),
                                      K4=cfg.camera.K4, height=240, width=320)
    gray, depth = seq.render(0)
    feats = extract_frame(np.asarray(gray), np.asarray(depth), to_port(cfg),
                          "cpu")
    dets = Detections(boxes=torch.tensor([[40.0, 40.0, 120.0, 100.0]]),
                      scores=torch.tensor([0.9]),
                      classes=torch.tensor([7], dtype=torch.int32),
                      valid=torch.tensor([True]))
    out = str(tmp_path / "overlay.png")
    draw_frame_overlay(torch.from_numpy(np.asarray(gray)), feats, out,
                       detections=dets, plane_block=cfg.plane.block)
    assert os.path.getsize(out) > 10000


def test_render_map_keyframe_frusta(tmp_path):
    """MapDrawer: keyframe frusta and covisibility edges
    (src/MapDrawer.cc:278,374) on a port map with >= 2 keyframes, read back
    once as a map view."""
    cfg0 = small_cfg()
    cfg = cfg0.replace(tracking=dataclasses.replace(cfg0.tracking,
                                                    min_frames=2))
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(8),
                                      K4=cfg.camera.K4, height=240, width=320)
    sysm = System(to_port(cfg), enable_loop_closing=False, device="cpu")
    for i in range(8):
        gray, depth = seq.render(i)
        sysm.track_rgbd(np.asarray(gray), np.asarray(depth), i / 30.0)
    sysm.tracker.flush()
    view = map_view(sysm.tracker)
    assert int(view["kf_valid"].sum()) >= 2
    assert len(view["trajectory"]) == 8
    out = str(tmp_path / "map.png")
    Viewer(sysm).render_map(out)
    assert os.path.getsize(out) > 20000


def test_live_viewer_state_matches_jax():
    """Both Systems with their live viewers (every frame) over 12 corridor
    frames: the port serves its dashboard, PNG renders and a /state.json
    whose frame, state and counts equal the JAX viewer's (t_wc within
    1e-3 m); both deferred decisions lag by exactly one frame."""
    cfg = small_cfg()
    n = 12
    seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(n),
                                      K4=cfg.camera.K4, height=240, width=320)
    frames = [tuple(np.asarray(x) for x in seq.render(i)) for i in range(n)]
    states = {}
    for name in ("jax", "port"):
        sys_ = (JSystem(cfg, enable_loop_closing=False, live_viewer=True)
                if name == "jax" else
                System(to_port(cfg), enable_loop_closing=False,
                       live_viewer=True, device="cpu"))
        sys_._live.every, sys_._live.min_period = 1, 0.0
        try:
            for i, (g, d) in enumerate(frames):
                sys_.track_rgbd(g, d, i / 30.0)
                if name == "jax":
                    wait_pending(sys_)
            sys_._live.flush()
            code, _, body = _get(sys_._live.port, "/state.json")
            assert code == 200
            states[name] = json.loads(body)
            if name == "port":
                st = sys_.tracker.map_state
                assert states[name]["n_points"] == int(st.pt_valid.sum())
                code, ctype, body = _get(sys_._live.port, "/")
                assert code == 200 and b"map.mjpg" in body
                for path in ("/map.png", "/frame.png"):
                    code, ctype, body = _get(sys_._live.port, path)
                    assert code == 200 and ctype == "image/png"
                    assert body[:8] == b"\x89PNG\r\n\x1a\n" and len(body) > 5000
                with pytest.raises(urllib.error.HTTPError) as e:
                    _get(sys_._live.port, "/nope")
                assert e.value.code == 404
        finally:
            sys_._live.close()
    j, p = states["jax"], states["port"]
    for k in ("frame", "state", "n_keyframes", "n_points", "n_planes"):
        assert p[k] == j[k], (k, p[k], j[k])
    assert p["frame"] == n and p["n_keyframes"] >= 1 and p["n_points"] > 0
    np.testing.assert_allclose(p["t_wc"], j["t_wc"], rtol=0, atol=1e-3)


def test_system_viewer_flags(tmp_path):
    """System(use_viewer=True) renders every 30 frames into out_dir and
    System(live_viewer=True) serves: both attach instead of raising."""
    cfg = small_cfg()
    sys_ = System(to_port(cfg), use_viewer=True, live_viewer=True,
                  enable_loop_closing=False, device="cpu")
    try:
        sys_._viewer.out_dir, sys_._viewer.every = str(tmp_path), 2
        seq = synthetic.SyntheticSequence(synthetic.corridor_trajectory(2),
                                          K4=cfg.camera.K4, height=240,
                                          width=320)
        for i in range(2):
            g, d = seq.render(i)
            sys_.track_rgbd(np.asarray(g), np.asarray(d), i / 30.0)
        assert os.path.getsize(tmp_path / "map_000002.png") > 10000
        code, _, body = _get(sys_._live.port, "/state.json")
        assert code == 200
    finally:
        sys_._live.close()
