"""Live viewer: the reference's Pangolin window as a browser stream.

Counterpart of the JAX package's `viz/live.py` (src/Viewer.cc:43 Run /
RunWithPLP: a live window with the 3D map, keyframe frusta, covisibility
graph and the current frame overlay, started as its own thread from
System.cc:152). A headless host has no window, so the live view is an HTTP
server any browser (or curl) can attach to while SLAM runs:

    /            one-page dashboard: map + frame images (auto-refresh) + state
    /map.png     latest 3D map render (points/lines/planes/frusta/covis/traj)
    /frame.png   latest 2D frame overlay (keypoints/lines/plane mask/YOLOX)
    /map.mjpg    multipart/x-mixed-replace PNG stream of the map view
    /frame.mjpg  same for the frame overlay
    /state.json  pose, tracking state, landmark/keyframe counts, fps

update() on the tracking thread does a rate check, then, only on frames
that render, takes a `MapSnapshot` (device copies of the fields the worker
reads and a CUDA event behind them: the tracker may replace or write its
tensors, and the global BA produces them on a side stream) and hands the
job to a render worker, latest wins. It never synchronises. The worker
waits on the snapshot's event, reads it back, renders and encodes the PNGs,
then notifies the MJPEG streams once per new image; a slow or absent
browser costs nothing (only the latest PNG per view is held).
"""

from __future__ import annotations

import io
import json
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from dr_slam_torch.viz.viewer import MapSnapshot, Viewer, draw_frame_overlay

_PAGE = """<!doctype html>
<html><head><title>DR-SLAM live</title><style>
body{background:#111;color:#ddd;font-family:monospace;margin:1em}
img{max-width:48%;border:1px solid #444;vertical-align:top}
pre{color:#8c8}</style></head><body>
<h3>DR-SLAM live viewer</h3>
<img src="map.mjpg" onerror="this.src='map.png'">
<img src="frame.mjpg" onerror="this.src='frame.png'">
<pre id="st"></pre>
<script>setInterval(async()=>{try{const r=await fetch('state.json');
document.getElementById('st').textContent=
JSON.stringify(await r.json(),null,1);}catch(e){}},500);</script>
</body></html>"""


class LiveViewer:
    """Attach to a `System` (or any object with `.tracker`): call
    `update(result, gray=None, feats=None, detections=None)` per frame.
    update() only enqueues (latest-wins) every `every` frames and never
    faster than `min_period` seconds; state snapshot, rendering and
    encoding run on a background worker; HTTP serving is fully
    asynchronous. flush() blocks until the worker drained the last job."""

    def __init__(self, system, host: str = "127.0.0.1", port: int = 0,
                 every: int = 10, min_period: float = 0.5):
        self.system = system
        self.every = max(1, every)
        self.min_period = min_period
        self._lock = threading.Lock()
        self._png = {"map": None, "frame": None}
        self._state = {}
        self._count = 0
        self._last_render = 0.0
        self._t0 = time.perf_counter()
        self._new = threading.Condition(self._lock)
        # latest-wins render job queue (depth 1) + its worker thread
        self._job = None
        self._job_lock = threading.Lock()
        self._job_ev = threading.Event()
        self._idle = threading.Event()
        self._idle.set()
        self._closing = False
        self._worker = threading.Thread(target=self._work_loop, daemon=True)
        self._worker.start()

        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                p = self.path.split("?")[0]
                if p in ("/", "/index.html"):
                    body = _PAGE.encode()
                    self._send(200, "text/html", body)
                elif p == "/state.json":
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    self._send(200, "application/json", body)
                elif p in ("/map.png", "/frame.png"):
                    key = p[1:-4]
                    with viewer._lock:
                        body = viewer._png[key]
                    if body is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", body)
                elif p in ("/map.mjpg", "/frame.mjpg"):
                    self._stream(p[1:-5])
                else:
                    self._send(404, "text/plain", b"not found")

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def _stream(self, key):
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "multipart/x-mixed-replace; boundary=drslam")
                self.end_headers()
                try:
                    while True:
                        with viewer._new:
                            viewer._new.wait(timeout=2.0)
                            body = viewer._png[key]
                        if body is None:
                            continue
                        self.wfile.write(b"--drslam\r\n"
                                         b"Content-Type: image/png\r\n"
                                         b"Content-Length: "
                                         + str(len(body)).encode()
                                         + b"\r\n\r\n" + body + b"\r\n")
                except (BrokenPipeError, ConnectionResetError, OSError):
                    return  # browser went away; nothing to clean up

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def update(self, result, gray=None, feats_fn=None,
               detections=None) -> None:
        """Tracking-thread side: the rate check, then on a rendering frame
        the device snapshot and the latest-wins job handoff. No readback,
        no synchronise, no rendering here; a skipped frame costs a counter
        increment and a clock read.

        feats_fn: zero-arg callable returning FrameFeatures, called by the
        worker and only on frames that render."""
        self._count += 1
        now = time.perf_counter()
        if (self._count % self.every or
                now - self._last_render < self.min_period):
            return
        self._last_render = now
        snap = MapSnapshot(self.system.tracker, result.T_cw)
        with self._job_lock:
            self._job = (self._count, result, snap, gray, feats_fn,
                         detections, now)
            self._idle.clear()
            self._job_ev.set()

    def flush(self, timeout: float = 30.0) -> None:
        """Block until the render worker has drained the pending job (call
        before asserting on served content, or at shutdown)."""
        self._idle.wait(timeout)

    # ------------------------------------------------------------------
    def _work_loop(self) -> None:
        while True:
            self._job_ev.wait()
            if self._closing:
                return
            with self._job_lock:
                job, self._job = self._job, None
                self._job_ev.clear()
            if job is None:
                continue
            try:
                self._process(job)
            except Exception:   # the viewer must never kill tracking
                traceback.print_exc()
            with self._job_lock:
                if self._job is None:
                    self._idle.set()

    def _process(self, job) -> None:
        count, result, snap, gray, feats_fn, detections, now = job
        # the viewer's only device -> host readbacks: once per rendered
        # frame, on this worker thread, after the snapshot's event
        view = snap.view()
        state = {
            "frame": count,
            "state": getattr(result, "state", None)
            and str(result.state.name),
            "n_inliers": int(getattr(result, "n_inliers", 0)),
            "n_keyframes": int(view["kf_valid"].sum()),
            "n_points": int(view["pt_valid"].sum()),
            "n_planes": int(view["pl_valid"].sum()),
            "t_wc": np.linalg.inv(view["T_cw"])[:3, 3].round(4).tolist(),
            "fps": round(count / max(now - self._t0, 1e-9), 2),
        }
        with self._lock:
            self._state = state
        self._render(view, gray, feats_fn() if feats_fn else None,
                     detections)

    def _render(self, view, gray, feats, detections) -> None:
        buf = io.BytesIO()
        Viewer(self.system, every=1).render_map(buf, view)
        with self._lock:
            self._png["map"] = buf.getvalue()
        if gray is not None and feats is not None:
            buf = io.BytesIO()
            draw_frame_overlay(gray, feats, buf, detections=detections)
            with self._lock:
                self._png["frame"] = buf.getvalue()
        with self._new:
            self._new.notify_all()

    def close(self) -> None:
        self._closing = True
        self._job_ev.set()
        self._worker.join(timeout=5.0)
        self._httpd.shutdown()
        self._httpd.server_close()
