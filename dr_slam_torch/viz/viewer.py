"""Offline map / trajectory viewer (matplotlib, headless).

Counterpart of the JAX package's `viz/viewer.py` (the reference's Pangolin
viewer stack: src/Viewer.cc:43 RunWithPLP, src/MapDrawer.cc,
src/FrameDrawer.cc). A headless host has no window, so the same content is
rendered to PNG on demand: map points, lines, plane clouds, keyframe
frusta, the covisibility graph, the current camera and trajectory, and a
2D frame overlay.

The map's tensors are read back once per render, as a `map_view`: numpy
copies of the fields the render reads. A `MapSnapshot` takes those fields
on the device instead, as copies enqueued on the current stream with a
CUDA event behind them, for a reader on another thread (`viz/live.py`):
the tracker may replace or write its tensors after the call, and the
copies stay as they were."""

from __future__ import annotations

import numpy as np
import torch

from dr_slam_torch import to_numpy

# the MapState fields a map render reads
MAP_FIELDS = ("manhattan_ok", "R_wm", "pt_valid", "pt_pos", "ln_valid",
              "ln_ep", "pl_valid", "pl_cloud", "pl_cloud_valid", "kf_valid",
              "kf_pose", "kf_mp")


class MapSnapshot:
    """Device copies of a tracker's map fields and trajectory (and of a
    frame's pose, `T_cw`, when given), enqueued on the current stream;
    `view()` waits for them (on whichever thread calls it) and reads them
    back."""

    def __init__(self, tracker, T_cw=None):
        st = tracker.map_state
        fields = {f: getattr(st, f) for f in MAP_FIELDS}
        if T_cw is not None:
            fields["T_cw"] = T_cw
        self._fields = {k: v.clone() if isinstance(v, torch.Tensor) else v
                        for k, v in fields.items()}
        # lagged poses are device tensors: one stacked copy of them
        poses = [T for _, T in tracker.trajectory]
        dev = [T for T in poses if isinstance(T, torch.Tensor)]
        self._stacked = torch.stack(dev) if dev else None
        self._poses = [None if isinstance(T, torch.Tensor) else np.asarray(T)
                       for T in poses]
        self._event = None
        if st.pt_pos.is_cuda:
            self._event = torch.cuda.Event()
            self._event.record()

    def view(self) -> dict:
        if self._event is not None:
            self._event.synchronize()
        out = {k: to_numpy(v) for k, v in self._fields.items()}
        stacked = iter(to_numpy(self._stacked)) if self._stacked is not None \
            else None
        out["trajectory"] = [next(stacked) if T is None else T
                             for T in self._poses]
        return out


def map_view(tracker) -> dict:
    """The map fields a render reads and the trajectory, read back now."""
    return MapSnapshot(tracker).view()


class Viewer:
    def __init__(self, system, out_dir: str = "viewer_out", every: int = 30):
        self.system = system
        self.out_dir = out_dir
        self.every = every
        self._count = 0

    def update(self, result) -> None:
        self._count += 1
        if self._count % self.every == 0:
            import os
            os.makedirs(self.out_dir, exist_ok=True)
            self.render_map(f"{self.out_dir}/map_{self._count:06d}.png")

    def render_map(self, path, view: dict | None = None) -> None:
        """Render the map to `path` (a file name or a binary stream); `view`
        is a `map_view` or `MapSnapshot.view()`, by default the tracker's
        map read back now."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        st = map_view(self.system.tracker) if view is None else view
        fig = plt.figure(figsize=(10, 8))
        ax = fig.add_subplot(111, projection="3d")
        # Manhattan-normal sub-view (the reference Viewer's sub-viewport,
        # src/Viewer.cc:99-166): the world-frame Manhattan axes as a triad
        if bool(st["manhattan_ok"]):
            axin = fig.add_axes([0.02, 0.72, 0.22, 0.25], projection="3d")
            R = st["R_wm"]
            colors = ("tab:red", "tab:green", "tab:blue")
            for i, c in enumerate(colors):
                a = R[:, i]
                axin.quiver(0, 0, 0, a[0], a[2], -a[1], color=c, lw=2)
            axin.set_xlim(-1, 1)
            axin.set_ylim(-1, 1)
            axin.set_zlim(-1, 1)
            axin.set_title("Manhattan", fontsize=8)
            axin.set_axis_off()
        pts = st["pt_pos"][st["pt_valid"]]
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 2], -pts[:, 1], s=0.5, c="k",
                       alpha=0.4, label=f"points ({len(pts)})")
        for ep in st["ln_ep"][st["ln_valid"]][:200]:
            ax.plot([ep[0], ep[3]], [ep[2], ep[5]], [-ep[1], -ep[4]],
                    c="tab:blue", lw=1)
        for i in np.where(st["pl_valid"])[0][:16]:
            cl = st["pl_cloud"][i][st["pl_cloud_valid"][i]]
            if len(cl):
                ax.scatter(cl[:, 0], cl[:, 2], -cl[:, 1], s=2, alpha=0.6)
        # keyframe frusta (MapDrawer::DrawKeyFrames, src/MapDrawer.cc:278)
        kf_pose = st["kf_pose"]
        alive = np.where(st["kf_valid"])[0]
        w, h, z = 0.06, 0.045, 0.05   # frustum half-extents (metres)
        corners = np.array([[0, 0, 0], [w, h, z], [-w, h, z],
                            [-w, -h, z], [w, -h, z]])
        edges = [(0, 1), (0, 2), (0, 3), (0, 4),
                 (1, 2), (2, 3), (3, 4), (4, 1)]
        centers = {}
        for k in alive:
            T_wc = np.linalg.inv(kf_pose[k])
            cw = corners @ T_wc[:3, :3].T + T_wc[:3, 3]
            centers[int(k)] = T_wc[:3, 3]
            for a, b in edges:
                ax.plot([cw[a, 0], cw[b, 0]], [cw[a, 2], cw[b, 2]],
                        [-cw[a, 1], -cw[b, 1]], c="tab:purple", lw=0.7,
                        alpha=0.8)
        # covisibility graph (MapDrawer::DrawGraph, src/MapDrawer.cc:374):
        # keyframes sharing >= `covis_min` map points
        covis_min = 15
        kf_mp = st["kf_mp"]
        drawn_graph = False
        for ai, a in enumerate(alive):
            sa = set(kf_mp[a][kf_mp[a] >= 0].tolist())
            if not sa:
                continue
            for b in alive[ai + 1:]:
                shared = sa.intersection(kf_mp[b][kf_mp[b] >= 0].tolist())
                if len(shared) >= covis_min:
                    pa, pb = centers[int(a)], centers[int(b)]
                    ax.plot([pa[0], pb[0]], [pa[2], pb[2]],
                            [-pa[1], -pb[1]], c="tab:green", lw=0.5,
                            alpha=0.6,
                            label=None if drawn_graph else "covisibility")
                    drawn_graph = True
        traj = np.asarray([np.linalg.inv(T)[:3, 3] for T in st["trajectory"]])
        if len(traj):
            ax.plot(traj[:, 0], traj[:, 2], -traj[:, 1], c="r", lw=2,
                    label="trajectory")
        ax.set_xlabel("x")
        ax.set_ylabel("z")
        ax.set_zlabel("-y")
        ax.legend(loc="upper right")
        # format pinned so `path` may be a BytesIO (live viewer streaming)
        fig.savefig(path, dpi=110, format="png")
        plt.close(fig)


def draw_frame_overlay(gray, feats, path, detections=None,
                       plane_block: int = 8) -> None:
    """2D overlay: keypoints, line segments, plane segmentation mask and
    YOLOX detection boxes (FrameDrawer::DrawFrame + DrawObjects,
    src/FrameDrawer.cc:35,219). Tensors are read back here."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 7.5))
    g = to_numpy(gray)
    ax.imshow(g, cmap="gray", vmin=0, vmax=255)
    # plane segmentation mask (block labels upsampled, translucent)
    bl = to_numpy(feats.planes.block_label)
    if bl.size:
        mask = np.kron(bl, np.ones((plane_block, plane_block), bl.dtype))
        mask = mask[:g.shape[0], :g.shape[1]].astype(float)
        mask[mask < 0] = np.nan
        ax.imshow(mask, cmap="tab10", alpha=0.25, interpolation="nearest")
    kv = to_numpy(feats.kp.valid)
    uv = to_numpy(feats.kp.uv)[kv]
    ax.scatter(uv[:, 0], uv[:, 1], s=6, c="lime", marker="o",
               facecolors="none")
    lv = to_numpy(feats.lines.valid)
    for x1, y1, x2, y2 in to_numpy(feats.lines.seg2d)[lv]:
        ax.plot([x1, x2], [y1, y2], c="red", lw=1.5)
    n_det = 0
    if detections is not None:
        dv = to_numpy(detections.valid)
        boxes = to_numpy(detections.boxes)[dv]
        classes = to_numpy(detections.classes)[dv]
        scores = to_numpy(detections.scores)[dv]
        n_det = int(dv.sum())
        for (x1, y1, x2, y2), c, s in zip(boxes, classes, scores):
            ax.add_patch(plt.Rectangle((x1, y1), x2 - x1, y2 - y1,
                                       fill=False, color="yellow", lw=1.5))
            ax.text(x1, y1 - 2, f"{int(c)}:{s:.2f}", color="yellow",
                    fontsize=7)
    ax.set_title(f"kp={kv.sum()} lines={lv.sum()} "
                 f"planes={int(to_numpy(feats.planes.valid).sum())} "
                 f"objects={n_det}")
    ax.axis("off")
    fig.savefig(path, dpi=110, bbox_inches="tight", format="png")
    plt.close(fig)
