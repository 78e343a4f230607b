"""Streaming transport: the reference's ROS node as a broker-less socket
protocol.

Counterpart of the JAX package's `io/transport.py` (the capability of
Examples/RGB-D/main_ros.cc and src/System.cc:279-280, 574-615): the node
pairs an RGB topic with an aligned-depth topic through an ApproximateTime
synchronizer (main_ros.cc:94-108), tracks each pair with
`System.track_rgbd`, answers with odometry, and serves the console's
save-map and save-occupancy commands (main_ros.cc:110-135). The topic names
and the bytes on the wire are the reference's, so a client of either
package drives a server of the other.

One duplex TCP socket carries length-prefixed messages; the SLAM process is
the server, camera drivers and consumers are clients. The transport stays
on the host: frames arrive as numpy arrays and reach the device once, in
the tracker's own upload. Replies read back what they report (the pose, the
keyframe table, the occupancy grid).

Wire format (little-endian):
    u32 frame_len | u16 topic_len | topic utf-8 | f64 stamp | u8 kind |
    payload
kind 0: payload is UTF-8 JSON (commands, odometry, status).
kind 1: payload is an ndarray: u8 dtype_len | dtype str | u8 ndim |
        u32 dims[ndim] | raw C-order bytes.
"""

from __future__ import annotations

import json
import socket
import struct
from collections import deque
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from dr_slam_torch import to_numpy
from dr_slam_torch.geometry.se3 import rot_to_quat

_HDR = struct.Struct("<I")
_KIND_JSON = 0
_KIND_ARRAY = 1

# The reference's wiring (main_ros.cc:94-97, System.cc:279-280).
TOPIC_RGB = "/camera/color/image_raw"
TOPIC_DEPTH = "/camera/aligned_depth_to_color/image_raw"
TOPIC_ODOM = "/vins_estimator/odometry"
TOPIC_CMD = "/save_map_cmd"
TOPIC_STATUS = "/dr_slam/status"
TOPIC_OCC = "/dr_slam/occupancy"


def _pack_payload(data) -> tuple[int, bytes]:
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data)
        dt = arr.dtype.str.encode()
        head = struct.pack("<B", len(dt)) + dt + struct.pack("<B", arr.ndim)
        head += struct.pack(f"<{arr.ndim}I", *arr.shape)
        return _KIND_ARRAY, head + arr.tobytes()
    return _KIND_JSON, json.dumps(data).encode()


def _unpack_payload(kind: int, buf: memoryview):
    if kind == _KIND_ARRAY:
        (dl,) = struct.unpack_from("<B", buf, 0)
        dt = bytes(buf[1:1 + dl]).decode()
        (nd,) = struct.unpack_from("<B", buf, 1 + dl)
        off = 2 + dl
        shape = struct.unpack_from(f"<{nd}I", buf, off)
        off += 4 * nd
        return np.frombuffer(buf[off:], dtype=np.dtype(dt)).reshape(
            shape).copy()
    return json.loads(bytes(buf).decode())


def send_message(sock: socket.socket, topic: str, stamp: float, data) -> None:
    """Publish one message on the socket (blocking, whole-frame write)."""
    kind, payload = _pack_payload(data)
    t = topic.encode()
    body = (struct.pack("<H", len(t)) + t + struct.pack("<dB", stamp, kind)
            + payload)
    sock.sendall(_HDR.pack(len(body)) + body)


def _recv_exact(sock: socket.socket, n: int) -> Optional[bytes]:
    chunks = []
    while n:
        b = sock.recv(min(n, 1 << 20))
        if not b:
            return None
        chunks.append(b)
        n -= len(b)
    return b"".join(chunks)


def recv_message(sock: socket.socket):
    """Receive one (topic, stamp, data) message; None on a clean close."""
    hdr = _recv_exact(sock, _HDR.size)
    if hdr is None:
        return None
    body = _recv_exact(sock, _HDR.unpack(hdr)[0])
    if body is None:
        return None
    mv = memoryview(body)
    (tl,) = struct.unpack_from("<H", mv, 0)
    topic = bytes(mv[2:2 + tl]).decode()
    stamp, kind = struct.unpack_from("<dB", mv, 2 + tl)
    return topic, stamp, _unpack_payload(kind, mv[2 + tl + 9:])


class ApproximateTimeSync:
    """Pairs messages of two topics by nearest timestamp within `slop`
    seconds (message_filters' ApproximateTime policy, main_ros.cc:106-108,
    queue size 10). add() returns the matched (stamp, a, b) when a pair
    forms, else None; unmatched messages older than the pair are dropped."""

    def __init__(self, slop: float = 0.02, queue_size: int = 10):
        self.slop = float(slop)
        self.queues: tuple[deque, deque] = (deque(maxlen=queue_size),
                                            deque(maxlen=queue_size))

    def add(self, channel: int, stamp: float, data):
        self.queues[channel].append((float(stamp), data))
        other = self.queues[1 - channel]
        if not other:
            return None
        # the nearest partner of the message that just arrived
        best = min(other, key=lambda m: abs(m[0] - stamp))
        if abs(best[0] - stamp) > self.slop:
            return None
        other.remove(best)
        self.queues[channel].pop()
        # drop anything older than the matched pair (ordered delivery)
        t = min(stamp, best[0])
        for q in self.queues:
            while q and q[0][0] < t:
                q.popleft()
        pair = (data, best[1]) if channel == 0 else (best[1], data)
        return (min(stamp, best[0]),) + pair


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return np.asarray(img, np.float32)
    w = np.asarray([0.299, 0.587, 0.114], np.float32)
    return np.asarray(img, np.float32) @ w


def _quat(R: np.ndarray) -> list:
    """(x, y, z, w) of a 3x3 rotation, computed in float32 as the reference
    computes it."""
    q = rot_to_quat(torch.from_numpy(np.asarray(R, np.float32)))
    return [float(v) for v in q.numpy()]


class SlamServer:
    """The DR-SLAM node: serves one camera client over a TCP socket.

    Consumes TOPIC_RGB and TOPIC_DEPTH through ApproximateTimeSync, tracks
    each pair and answers with a TOPIC_ODOM JSON message per frame (track
    state, keyframe flag, T_wc as position and (x, y, z, w) quaternion).
    Commands on TOPIC_CMD mirror the reference's console keys
    (main_ros.cc:112-135):
        {"cmd": "save_map", "path": ...}   -> System.save_map
        {"cmd": "save_occupancy", ...}     -> per-keyframe odometry, then the
                                              occupancy grid
        {"cmd": "shutdown"}                -> close the connection
    """

    # System.cc:580-585: occupancy odometry is published in a z-up frame,
    # R = [[1,0,0],[0,0,1],[0,-1,0]] applied to camera-to-world.
    _R_ZUP = np.array([[1.0, 0, 0], [0, 0, 1.0], [0, -1.0, 0]], np.float32)

    def __init__(self, system, host: str = "127.0.0.1", port: int = 0,
                 slop: float = 0.02, depth_scale: float = 1.0):
        self.system = system
        self.depth_scale = float(depth_scale)
        self.sync = ApproximateTimeSync(slop=slop)
        self._srv = socket.create_server((host, port))
        self.address = self._srv.getsockname()

    def serve_once(self) -> int:
        """Accept one client and pump messages until shutdown or close.
        Returns the number of frames tracked."""
        conn, _ = self._srv.accept()
        n_tracked = 0
        try:
            while True:
                msg = recv_message(conn)
                if msg is None:
                    break
                topic, stamp, data = msg
                if topic == TOPIC_RGB:
                    pair = self.sync.add(0, stamp, data)
                elif topic == TOPIC_DEPTH:
                    pair = self.sync.add(1, stamp, data)
                elif topic == TOPIC_CMD:
                    if not self._handle_command(conn, data):
                        break
                    continue
                else:
                    continue
                if pair is None:
                    continue
                t, rgb, depth = pair
                res = self.system.track_rgbd(
                    _rgb_to_gray(rgb),
                    np.asarray(depth, np.float32) * self.depth_scale, t)
                n_tracked += 1
                send_message(conn, TOPIC_ODOM, t, self._odom_dict(res))
        finally:
            conn.close()
        return n_tracked

    def close(self):
        self._srv.close()

    def _odom_dict(self, res) -> dict:
        T_cw = to_numpy(res.T_cw).astype(np.float64)
        R_wc = T_cw[:3, :3].T
        t_wc = -R_wc @ T_cw[:3, 3]
        return {"state": res.state.name, "is_keyframe": bool(res.is_keyframe),
                "position": [float(v) for v in t_wc],
                "orientation": _quat(R_wc)}

    def _handle_command(self, conn, data: dict) -> bool:
        cmd = data.get("cmd", "")
        if cmd == "shutdown":
            send_message(conn, TOPIC_STATUS, 0.0, {"ok": True,
                                                   "cmd": "shutdown"})
            return False
        if cmd == "save_map" and data.get("path"):
            self.system.save_map(data["path"])
            send_message(conn, TOPIC_STATUS, 0.0, {"ok": True,
                                                   "cmd": "save_map"})
            return True
        if cmd == "save_occupancy":
            self._publish_occupancy(conn, data)
            return True
        send_message(conn, TOPIC_STATUS, 0.0,
                     {"ok": False, "error": f"unknown cmd {cmd!r}"})
        return True

    def _publish_occupancy(self, conn, data: dict):
        """System::Save_OccupancyMap (System.cc:574-615): one odometry
        message per live keyframe in the z-up frame, then, where the
        reference re-publishes per-keyframe depth images that the map no
        longer stores, the occupancy grid of the map's points."""
        from dr_slam_torch.io.occupancy import occupancy_grid_2d
        tr = self.system.tracker
        st = tr.map_state
        n_pub = 0
        for k in np.where(to_numpy(st.kf_valid))[0]:
            T_cw = tr.kf_pose_host.get(int(k))
            if T_cw is None:
                continue
            T_cw = to_numpy(T_cw)
            R_wc = T_cw[:3, :3].T
            t_wc = -R_wc @ T_cw[:3, 3]
            send_message(conn, TOPIC_ODOM, float(k), {
                "keyframe": int(k),
                "position": [float(v) for v in self._R_ZUP @ t_wc],
                "orientation": _quat(self._R_ZUP @ R_wc)})
            n_pub += 1
        res = float(data.get("resolution", 0.05))
        grid, origin = occupancy_grid_2d(st.pt_pos, st.pt_valid,
                                         resolution=res)
        send_message(conn, TOPIC_OCC, 0.0, to_numpy(grid))
        send_message(conn, TOPIC_STATUS, 0.0, {
            "ok": True, "cmd": "save_occupancy", "keyframes": n_pub,
            "origin": [float(v) for v in np.asarray(origin).ravel()],
            "resolution": res})


class CameraClient:
    """The camera driver's side: connects to a SlamServer and streams RGB-D
    pairs. publish_frame() sends both topics; recv() polls the replies."""

    def __init__(self, address):
        self.sock = socket.create_connection(tuple(address))

    def publish_frame(self, stamp: float, rgb: np.ndarray,
                      depth: np.ndarray) -> None:
        send_message(self.sock, TOPIC_RGB, stamp, np.asarray(rgb))
        send_message(self.sock, TOPIC_DEPTH, stamp, np.asarray(depth))

    def command(self, **kw) -> None:
        send_message(self.sock, TOPIC_CMD, 0.0, kw)

    def recv(self):
        return recv_message(self.sock)

    def stream(self, frames: Iterable, on_odom: Optional[Callable] = None,
               shutdown: bool = True) -> list:
        """Publish every frame, collecting one odometry reply per frame."""
        odoms = []
        for f in frames:
            self.publish_frame(f.timestamp, f.gray, f.depth)
            msg = self.recv()
            while msg is not None and msg[0] != TOPIC_ODOM:
                msg = self.recv()
            if msg is not None:
                odoms.append(msg)
                if on_odom:
                    on_odom(msg)
        if shutdown:
            self.command(cmd="shutdown")
        return odoms

    def close(self):
        self.sock.close()
