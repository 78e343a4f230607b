"""The port's streaming transport against the JAX package's.

- The wire format: for arrays of several dtypes and shapes and for JSON
  commands, the bytes each package's `send_message` writes are identical,
  and each package's `recv_message` decodes the other's to equal data.
- `ApproximateTimeSync` gives equal outputs on a seeded sequence of adds
  (two topics, jittered and dropped stamps, a short queue); `_rgb_to_gray`
  is equal.
- A node session at the small config of tests/test_tracking_e2e.py, 10
  corridor frames as 3-channel uint8 and float32 metres: a JAX
  `CameraClient` drives the port's `SlamServer` (`System(device="cpu")`),
  and the port's `CameraClient` drives the JAX `SlamServer` as the
  reference (its deferred decision made to lag by exactly one frame, as
  the port's does on the CPU). Odometry states and keyframe flags exact,
  positions within 3e-3 and quaternions within 6e-3 (the tracking bound;
  observed 3.1e-6 and 3.0e-7), the `save_map` file loadable by the JAX
  package's `map_io`, the save_occupancy reply's keyframe count and grid
  sum equal (observed: the grids equal, 512 points in 209 cells)."""

import socket

import numpy as np
import pytest
import torch

from dr_slam_tpu.io import map_io as jmap_io
from dr_slam_tpu.io import synthetic
from dr_slam_tpu.io import transport as jtp
from dr_slam_tpu.slam.system import System as JSystem
from dr_slam_torch._smoke import node_gaps, node_session, odom_arrays
from dr_slam_torch.io import transport as ttp
from dr_slam_torch.slam.system import System as TSystem

from torch_parity import jax_system_lagged_by_one, small_cfg, to_port

torch.set_num_threads(2)

N = 10
T_TOL = 3e-3


class _Wire:
    """A socket stand-in that keeps what is sent."""

    def __init__(self):
        self.data = b""

    def sendall(self, b):
        self.data += b


PAYLOADS = [
    np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3),
    np.random.RandomState(0).rand(5, 7).astype(np.float32),
    np.random.RandomState(1).randint(0, 65535, (4, 6)).astype(np.uint16),
    np.arange(-3, 9, dtype=np.int64),
    np.array([True, False, True]),
    np.array(2.5),
    np.asfortranarray(np.arange(12, dtype=np.int32).reshape(3, 4)),
    {"cmd": "save_map", "path": "/maps/é.npz"},
    {"state": "OK", "is_keyframe": False, "position": [0.1, -2e-9, 3.0],
     "orientation": [0.0, 0.0, 0.0, 1.0]},
]


@pytest.mark.parametrize("payload", PAYLOADS,
                         ids=[f"p{i}" for i in range(len(PAYLOADS))])
def test_wire_bytes_identical(payload):
    a, b = _Wire(), _Wire()
    jtp.send_message(a, jtp.TOPIC_DEPTH, 1.25, payload)
    ttp.send_message(b, ttp.TOPIC_DEPTH, 1.25, payload)
    assert b.data == a.data
    for send, recv in ((jtp.send_message, ttp.recv_message),
                       (ttp.send_message, jtp.recv_message)):
        s, r = socket.socketpair()
        try:
            send(s, jtp.TOPIC_RGB, 3.5, payload)
            topic, stamp, data = recv(r)
        finally:
            s.close()
            r.close()
        assert (topic, stamp) == (jtp.TOPIC_RGB, 3.5)
        if isinstance(payload, dict):
            assert data == payload
        else:
            assert data.dtype == payload.dtype
            np.testing.assert_array_equal(data, payload)


def test_topics_and_sync_equal():
    for name in ("TOPIC_RGB", "TOPIC_DEPTH", "TOPIC_ODOM", "TOPIC_CMD",
                 "TOPIC_STATUS", "TOPIC_OCC"):
        assert getattr(ttp, name) == getattr(jtp, name)
    rng = np.random.RandomState(7)
    js, ts = jtp.ApproximateTimeSync(0.02, 4), ttp.ApproximateTimeSync(0.02, 4)
    outs = []
    for n in range(400):
        ch = int(rng.rand() < 0.5)
        stamp = n / 60.0 + rng.normal(0, 0.01)
        if rng.rand() < 0.1:
            continue
        a, b = js.add(ch, stamp, n), ts.add(ch, stamp, n)
        assert a == b, n
        outs.append(a)
    assert 20 < sum(o is not None for o in outs) < 300
    rgb = np.random.RandomState(2).randint(0, 256, (6, 5, 3)).astype(np.uint8)
    np.testing.assert_array_equal(ttp._rgb_to_gray(rgb), jtp._rgb_to_gray(rgb))
    np.testing.assert_array_equal(ttp._rgb_to_gray(rgb[..., 0]),
                                  jtp._rgb_to_gray(rgb[..., 0]))


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    cfg = small_cfg()
    seq = synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(N, step=0.03), K4=cfg.camera.K4,
        height=240, width=320)
    frames = []
    for i in range(N):
        g, d = (np.asarray(x) for x in seq.render(i))
        frames.append((i / 30.0, np.repeat(np.clip(g + 0.5, 0, 255).astype(
            np.uint8)[..., None], 3, axis=-1), d.astype(np.float32)))
    tmp = tmp_path_factory.mktemp("node")
    with jax_system_lagged_by_one():
        server = jtp.SlamServer(JSystem(cfg), slop=1.0 / 60.0)
        try:
            ref = node_session(ttp, server, frames, str(tmp / "jax_map.npz"))
        finally:
            server.close()
    server = ttp.SlamServer(TSystem(to_port(cfg), device="cpu"),
                            slop=1.0 / 60.0)
    try:
        port = node_session(jtp, server, frames, str(tmp / "port_map.npz"))
    finally:
        server.close()
    return cfg, ref, port, tmp


def test_jax_client_drives_the_port_node(sessions):
    cfg, ref, port, _ = sessions
    odom = odom_arrays(ref["odom"])
    data = {f"node__{k}": v for k, v in odom.items()}
    data.update(occ__keyframes=ref["occ_status"]["keyframes"],
                occ__grid=ref["grid"],
                occ__origin=np.asarray(ref["occ_status"]["origin"]))
    gaps, fails = node_gaps(port, data)
    assert not fails, (fails, gaps)
    assert gaps["d_position"] <= T_TOL and gaps["d_orientation"] <= 2 * T_TOL
    assert (odom["state"] == 2).sum() >= N - 1
    assert port["occ_status"]["keyframes"] == ref["occ_status"]["keyframes"] >= 1
    assert port["grid"].dtype == ref["grid"].dtype == np.int32
    assert port["grid"].sum() == ref["grid"].sum() > 0
    assert port["n_tracked"] == ref["n_tracked"] == N


def test_saved_map_loads_in_jax(sessions):
    cfg, ref, port, tmp = sessions
    assert port["saved"] == ref["saved"] == {"ok": True, "cmd": "save_map"}
    jst = jmap_io.load_map(str(tmp / "port_map.npz"), cfg)
    want = jmap_io.load_map(str(tmp / "jax_map.npz"), cfg)
    assert int(jst.n_kfs) == int(want.n_kfs) >= 1
    np.testing.assert_array_equal(np.asarray(jst.pt_valid),
                                  np.asarray(want.pt_valid))
    np.testing.assert_allclose(np.asarray(jst.kf_pose), np.asarray(want.kf_pose),
                               rtol=0, atol=T_TOL)
