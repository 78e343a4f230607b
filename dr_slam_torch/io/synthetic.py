"""Synthetic Manhattan-world RGB-D sequences, rendered on the device.

Counterpart of the JAX package's `io/synthetic.py`: an axis-aligned box
room (and optional clutter boxes), textured with per-cell random rectangles
and sinusoids so FAST finds corners, the line detector edges and the plane
segmenter large planes; rendering is closed-form ray/plane and ray/slab
intersection over the pixel grid, computed once per call (nothing is
compiled). The trajectories and the clutter are numpy, as in the reference.

The depth image equals the reference's to float32 rounding. The gray image
does not, bit for bit: the texture's cell hash `fract(sin(a) * 43758.5453)`
turns one ulp of difference in `sin` or in its argument (XLA contracts the
argument into fused multiply-adds) into another cell brightness, so about
10% of the pixels differ by more than half a grey level between the two
packages (tests/test_torch_synthetic.py holds the share)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.geometry import se3
from dr_slam_torch.utils.prng import PRNGKey, normal


@dataclass(frozen=True)
class BoxRoom:
    """Axis-aligned room interior: x in [0,xmax], y in [0,ymax], z in [0,zmax].

    Walls face inward. y is 'down' (camera convention friendly)."""
    xmax: float = 4.0
    ymax: float = 3.0
    zmax: float = 6.0

    def planes(self) -> np.ndarray:
        """(P, 4) inward-facing planes (n, d) with n.p + d = 0."""
        return np.array([
            [1, 0, 0, 0.0],            # x = 0 wall, normal +x
            [-1, 0, 0, self.xmax],     # x = xmax wall
            [0, 1, 0, 0.0],            # y = 0 (ceiling)
            [0, -1, 0, self.ymax],     # y = ymax (floor)
            [0, 0, 1, 0.0],            # z = 0 wall (behind)
            [0, 0, -1, self.zmax],     # z = zmax wall (front)
        ], dtype=np.float32)


_C_U = float(np.float32(12.9898))


def _texture(p: torch.Tensor, plane_idx: torch.Tensor,
             phase_offset) -> torch.Tensor:
    """Procedural gray texture at world points p (..., 3) on surfaces
    plane_idx (..., int64): isolated rectangles of per-cell pseudo-random
    brightness at three cell sizes (L-shaped corners for FAST), plus two
    sinusoids. plane_idx selects the in-plane (u, v) chart and the phase;
    phase_offset makes clutter-box faces differ from the walls."""
    u = torch.where(plane_idx < 2, p[..., 2], p[..., 0])
    v = torch.where(plane_idx < 2, p[..., 1],
                    torch.where(plane_idx < 4, p[..., 2], p[..., 1]))
    phase = plane_idx.to(torch.float32) * 1.7 + phase_offset

    def rect_layer(freq, key):
        tu = u * freq + phase
        tv = v * freq + 0.3 * phase
        cu = torch.floor(tu)
        cv = torch.floor(tv)

        def cell_hash(k):
            # the argument as XLA contracts it, cu * 12.9898 fused into the
            # add of cv * 78.233 (the float32 product is exact in float64),
            # and sin rounded from float64: one ulp here is a different
            # cell brightness
            a = (cu.double() * _C_U + (cv * 78.233).double()).float()
            a = a + phase + (key + k) * 3.7
            h = torch.sin(a.double()).float() * 43758.5453
            return h - torch.floor(h)  # per-cell uniform [0,1)

        rnd = cell_hash(0)
        # each square's position and size jittered per cell, so corners do
        # not alias onto their neighbours
        ou = 0.05 + 0.25 * cell_hash(1)
        ov = 0.05 + 0.25 * cell_hash(2)
        su = 0.30 + 0.40 * cell_hash(3)
        sv = 0.30 + 0.40 * cell_hash(4)
        fu = tu - cu
        fv = tv - cv
        inside = (fu > ou) & (fu < ou + su) & (fv > ov) & (fv < ov + sv)
        return inside * (0.35 + 0.65 * rnd)

    coarse = torch.sin(u * 2.1 + phase) + torch.cos(v * 1.7 + phase)
    mid = torch.sin(u * 7.3 + 2.0 * phase) * torch.cos(v * 6.1 + phase)
    g = (55.0 + 100.0 * rect_layer(3.0, 0) + 42.0 * rect_layer(11.0, 5)
         + 36.0 * rect_layer(0.8, 11)
         + 9.0 * coarse + 5.0 * mid)
    return torch.clamp(g, 0.0, 255.0)


def _intersect(T_cw: torch.Tensor, planes: torch.Tensor, K4, height: int,
               width: int, boxes: torch.Tensor | None):
    """Each pixel's ray against the room's planes and the clutter boxes ->
    (t_hit (H, W), inf on a miss; surface index (H, W), 0-5 the planes,
    0/2/4 a box face by its normal's axis; texture phase offset (H, W), 0
    on the walls, (b + 1) * 5.1 on box b; ray directions (H, W, 3) with
    z-depth 1; camera origin (3,))."""
    dev = T_cw.device
    f32 = torch.float32
    T_wc = se3.inv_T(T_cw)
    R_wc = T_wc[:3, :3]
    origin = T_wc[:3, 3]

    fx, fy, cx, cy = (float(k) for k in K4)
    us = torch.arange(width, dtype=f32, device=dev)
    vs = torch.arange(height, dtype=f32, device=dev)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d_cam = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)],
                        -1)
    d_world = d_cam @ R_wc.T  # (H, W, 3); camera z-depth of o + t*d_world is t

    n = planes[:, :3]                     # (P, 3)
    d0 = planes[:, 3]                     # (P,)
    denom = torch.einsum("hwc,pc->hwp", d_world, n)
    numer = -(origin @ n.T + d0)          # (P,)
    t = numer / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t = torch.where((t > 1e-3) & (denom < 0), t, torch.inf)  # front side only
    t_hit = torch.amin(t, -1)
    idx = torch.argmin(t, -1)
    phase_off = torch.zeros_like(t_hit)

    if boxes is not None and boxes.shape[0] > 0:
        d_safe = torch.where(torch.abs(d_world) < 1e-9, 1e-9, d_world)
        for b in range(boxes.shape[0]):
            bmin, bmax = boxes[b, :3], boxes[b, 3:]
            t1 = (bmin - origin) / d_safe             # (H, W, 3)
            t2 = (bmax - origin) / d_safe
            tn_ax = torch.minimum(t1, t2)
            tf_ax = torch.maximum(t1, t2)
            tn = torch.max(tn_ax, -1).values
            tf = torch.min(tf_ax, -1).values
            hit_b = ((tf > torch.clamp(tn, min=1e-3)) & (tn > 1e-3)
                     & (tn < t_hit))
            # entry face: the axis whose slab bounds tn; its sign picks the
            # (u, v) chart exactly as the matching wall pair does
            face_idx = 2 * torch.argmax(tn_ax, -1)
            t_hit = torch.where(hit_b, tn, t_hit)
            idx = torch.where(hit_b, face_idx, idx)
            phase_off = torch.where(hit_b, (b + 1) * 5.1, phase_off)
    return t_hit, idx, phase_off, d_world, origin


def render_frame(T_cw: torch.Tensor, planes: torch.Tensor, K4,
                 height: int = 480, width: int = 640, depth_noise_key=None,
                 boxes: torch.Tensor | None = None,
                 quadratic_noise: bool = False):
    """Render (gray (H,W), depth (H,W)) from camera pose T_cw (world->cam)
    on T_cw's device.

    Depth is z-depth in meters (0 where invalid), gray in [0,255] float32.
    boxes: optional (B, 6) clutter AABBs [xmin,ymin,zmin,xmax,ymax,zmax],
    rendered by slab intersection. depth_noise_key: a PRNG key (k0, k1)
    (`utils.prng.PRNGKey(i)`) for Gaussian depth noise, sigma 0.001 z, or
    0.0012 z^2 with quadratic_noise (a Kinect-like structured-light
    sensor)."""
    t_hit, idx, phase_off, d_world, origin = _intersect(
        T_cw, planes, K4, height, width, boxes)
    hit = torch.isfinite(t_hit)
    t_hit = torch.where(hit, t_hit, 0.0)

    p_world = origin + t_hit[..., None] * d_world
    gray = torch.where(hit, _texture(p_world, idx, phase_off), 0.0)
    depth = torch.where(hit, t_hit, 0.0)
    if depth_noise_key is not None:
        sigma = 0.0012 * depth * depth if quadratic_noise else 0.001 * depth
        noise = sigma * normal(depth_noise_key, depth.shape, T_cw.device)
        depth = torch.where(hit, depth + noise, 0.0)
    return gray, depth


def corridor_trajectory(n_frames: int, room: BoxRoom | None = None,
                        yaw_amp: float = 0.08, step: float = 0.02
                        ) -> np.ndarray:
    """Smooth forward motion down the room with gentle yaw sway.

    Returns (N, 4, 4) T_cw poses (world->camera)."""
    room = room or BoxRoom()
    poses = []
    for i in range(n_frames):
        z = 0.8 + step * i
        x = room.xmax / 2 + 0.10 * np.sin(0.05 * i)
        y = room.ymax / 2 + 0.05 * np.sin(0.03 * i)
        yaw = yaw_amp * np.sin(0.08 * i)
        pitch = 0.03 * np.sin(0.05 * i + 1.0)
        cy_, sy = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        R_y = np.array([[cy_, 0, sy], [0, 1, 0], [-sy, 0, cy_]])
        R_x = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        R_wc = R_y @ R_x  # camera looks along +z world
        t_wc = np.array([x, y, z])
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = t_wc
        poses.append(np.linalg.inv(T_wc))
    return np.asarray(poses, dtype=np.float32)


def loop_trajectory(n_frames: int, room: BoxRoom | None = None) -> np.ndarray:
    """Closed-loop path around the room center (for loop-closing tests)."""
    room = room or BoxRoom()
    poses = []
    cx_, cy_, cz = room.xmax / 2, room.ymax / 2, room.zmax / 2
    r = min(room.xmax, room.zmax) / 4
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        x = cx_ + r * np.sin(th)
        z = cz - r * np.cos(th)
        yaw = th  # face tangentially
        c, s = np.cos(yaw), np.sin(yaw)
        R_wc = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        T_wc = np.eye(4)
        T_wc[:3, :3] = R_wc
        T_wc[:3, 3] = [x, cy_, z]
        poses.append(np.linalg.inv(T_wc))
    return np.asarray(poses, dtype=np.float32)


def office_clutter(room: BoxRoom | None = None, n_boxes: int = 5,
                   seed: int = 3) -> np.ndarray:
    """(B, 6) axis-aligned clutter boxes (desks/cabinets/shelving stand-ins)
    placed along the walls of the room, floor-seated, leaving the center
    navigable: occlusions, depth steps and small planar patches at many
    depths."""
    room = room or BoxRoom()
    rng = np.random.RandomState(seed)
    boxes = []
    for i in range(n_boxes):
        w = rng.uniform(0.4, 0.9)           # width along the wall
        dpt = rng.uniform(0.3, 0.6)         # protrusion into the room
        hgt = rng.uniform(0.7, 1.6)         # height from the floor
        z0 = rng.uniform(0.5, room.zmax - 1.5)
        if i % 2 == 0:                      # left wall (x = 0)
            boxes.append([0.0, room.ymax - hgt, z0, dpt, room.ymax, z0 + w])
        else:                               # right wall (x = xmax)
            boxes.append([room.xmax - dpt, room.ymax - hgt, z0,
                          room.xmax, room.ymax, z0 + w])
    return np.asarray(boxes, np.float32)


@dataclass
class SyntheticSequence:
    """Renders frames lazily on `device` (cuda unless "cpu" is passed);
    mirrors the TUMDataset interface."""
    poses_cw: np.ndarray                       # (N, 4, 4)
    K4: tuple = (535.4, 539.2, 320.1, 247.6)
    height: int = 480
    width: int = 640
    room: BoxRoom = field(default_factory=BoxRoom)
    fps: float = 30.0
    depth_noise: bool = False
    boxes: np.ndarray | None = None            # (B, 6) clutter AABBs
    quadratic_noise: bool = False              # Kinect-like sigma ~ z^2
    device: object = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._planes = torch.from_numpy(self.room.planes()).to(self.device)
        self._K4 = tuple(float(k) for k in self.K4)
        self._boxes = (torch.as_tensor(np.asarray(self.boxes, np.float32),
                                       device=self.device)
                       if self.boxes is not None else None)

    def __len__(self):
        return len(self.poses_cw)

    def pose(self, i: int) -> np.ndarray:
        return self.poses_cw[i]

    def render(self, i: int):
        """(gray, depth) device tensors of frame i; the depth noise of frame
        i is drawn from PRNGKey(i), as in the reference."""
        key = PRNGKey(i) if self.depth_noise else None
        T = torch.from_numpy(np.asarray(self.poses_cw[i],
                                        np.float32)).to(self.device)
        return render_frame(T, self._planes, self._K4, self.height,
                            self.width, depth_noise_key=key,
                            boxes=self._boxes,
                            quadratic_noise=self.quadratic_noise)

    def __getitem__(self, i: int):
        from dr_slam_torch.io.tum import RGBDFrame
        gray, depth = self.render(i)
        return RGBDFrame(timestamp=i / self.fps, gray=gray.cpu().numpy(),
                         depth=depth.cpu().numpy())

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]


def synthetic_map_state(cfg, n_kfs: int, seed: int = 0,
                        pose_noise: float = 0.01, pt_noise: float = 0.02,
                        device=None):
    """A realistic-capacity MapState, populated directly: n_kfs keyframes on
    a loop around the room, points on the walls, the 6 wall planes and the
    room's vertical edges as structural landmarks, and observation tables
    (kf_mp / kf_uv / kf_xyz / kf_pl / kf_ln) made by projecting the true
    geometry through each keyframe with noise. Maps at the scale the
    reference accumulates over a whole TUM sequence, for the global-BA,
    sharded-BA and place-recognition paths. Initial kf_pose / pt_pos /
    pl_coef / ln_ep are the true values perturbed by pose_noise /
    pt_noise. Built in numpy (the reference's draws, in its order), then
    placed on `device`.

    Returns (state: MapState, true_kf_pose: (n_kfs, 4, 4) np.ndarray)."""
    from dr_slam_torch.slam.state import make_empty_state

    dev = resolve_device(device)
    room = BoxRoom()
    rng = np.random.RandomState(seed)
    NK = cfg.map.max_keyframes
    NP = cfg.map.max_points
    K = cfg.orb.max_keypoints
    assert n_kfs <= NK
    poses_true = loop_trajectory(n_kfs, room)          # (n, 4, 4) T_cw
    K4 = cfg.camera.K4
    W, H = cfg.camera.width, cfg.camera.height

    # world points on the walls (uniform over the 6 faces)
    wall = rng.randint(0, 6, NP)
    u = rng.rand(NP)
    v = rng.rand(NP)
    pts = np.empty((NP, 3), np.float32)
    pts[:, 0] = np.where(wall == 0, 0, np.where(wall == 1, room.xmax,
                                                u * room.xmax))
    pts[:, 1] = np.where(wall == 2, 0, np.where(wall == 3, room.ymax,
                                                v * room.ymax))
    pts[:, 2] = np.select([wall == 4, wall == 5], [0.0, room.zmax],
                          rng.rand(NP) * room.zmax)
    # faces 0/1 vary (y,z); faces 2/3 vary (x,z); 4/5 vary (x,y)
    pts[:, 2] = np.where(wall < 4, u * room.zmax, pts[:, 2])
    pts[:, 1] = np.where(wall < 2, v * room.ymax, pts[:, 1])

    kf_pose = np.tile(np.eye(4, dtype=np.float32), (NK, 1, 1))
    kf_uv = np.zeros((NK, K, 2), np.float32)
    kf_xyz = np.zeros((NK, K, 3), np.float32)
    kf_mp = np.full((NK, K), -1, np.int32)
    kf_kp_valid = np.zeros((NK, K), bool)
    kf_sigma2 = np.ones((NK, K), np.float32)
    pt_seen = np.zeros(NP, bool)

    for k in range(n_kfs):
        T = poses_true[k]
        Xc = pts @ T[:3, :3].T + T[:3, 3]
        uv = np.stack([K4[0] * Xc[:, 0] / np.maximum(Xc[:, 2], 1e-6) + K4[2],
                       K4[1] * Xc[:, 1] / np.maximum(Xc[:, 2], 1e-6) + K4[3]],
                      -1)
        vis = ((Xc[:, 2] > 0.3) & (Xc[:, 2] < 8.0)
               & (uv[:, 0] > 1) & (uv[:, 0] < W - 2)
               & (uv[:, 1] > 1) & (uv[:, 1] < H - 2))
        ids = np.where(vis)[0]
        rng.shuffle(ids)
        ids = ids[:K]
        n = len(ids)
        kf_mp[k, :n] = ids
        kf_uv[k, :n] = uv[ids] + 0.3 * rng.randn(n, 2)
        kf_xyz[k, :n] = Xc[ids] * (1 + 0.002 * rng.randn(n, 1))
        kf_kp_valid[k, :n] = True
        pt_seen[ids] = True
        # perturbed initial pose; KF0 anchors the gauge exactly
        if k > 0:
            dxi = pose_noise * rng.randn(6).astype(np.float32)
            kf_pose[k] = se3.se3_exp(torch.from_numpy(dxi)).numpy() @ T
        else:
            kf_pose[k] = T

    # wall planes + a couple of par/ver relation entries per keyframe
    wall_pl = room.planes()                            # (6, 4) world (n, d)
    NF = cfg.map.max_planes
    Fp = cfg.plane.max_planes
    pl_coef = np.zeros((NF, 4), np.float32)
    pl_valid = np.zeros(NF, bool)
    n_pl = min(6, NF)
    pl_coef[:n_pl] = wall_pl[:n_pl]
    pl_valid[:n_pl] = True
    kf_pl = np.full((NK, Fp), -1, np.int32)
    kf_pl_par = np.full((NK, Fp), -1, np.int32)
    kf_pl_ver = np.full((NK, Fp), -1, np.int32)
    kf_pl_obs = np.zeros((NK, Fp, 4), np.float32)
    for k in range(n_kfs):
        T_wc = np.linalg.inv(poses_true[k])
        cam = wall_pl @ T_wc                           # camera-frame coeffs
        cam /= np.linalg.norm(cam[:, :3], axis=1, keepdims=True)
        cam *= np.where(cam[:, 3:4] < 0, -1.0, 1.0)
        facing = np.where(cam[:, 3] > 0.2)[0][:Fp]     # in front of camera
        m = len(facing)
        kf_pl[k, :m] = facing % n_pl
        kf_pl_obs[k, :m] = (cam[facing]
                            + 0.002 * rng.randn(m, 4).astype(np.float32))
        if m >= 2:
            kf_pl_par[k, 0] = facing[1] % n_pl         # opposite wall
            kf_pl_ver[k, 0] = facing[-1] % n_pl

    # vertical room edges as map lines
    NL = cfg.map.max_lines
    Fl = cfg.line.max_lines
    edges = np.asarray([
        [0, 0, 0, 0, room.ymax, 0],
        [room.xmax, 0, 0, room.xmax, room.ymax, 0],
        [0, 0, room.zmax, 0, room.ymax, room.zmax],
        [room.xmax, 0, room.zmax, room.xmax, room.ymax, room.zmax],
    ], np.float32)
    n_ln = min(len(edges), NL)
    ln_ep = np.zeros((NL, 6), np.float32)
    ln_ep[:n_ln] = edges[:n_ln]
    ln_valid = np.zeros(NL, bool)
    ln_valid[:n_ln] = True
    kf_ln = np.full((NK, Fl), -1, np.int32)
    kf_ln_obs = np.zeros((NK, Fl, 3), np.float32)
    kf_ln_xyz = np.zeros((NK, Fl, 6), np.float32)
    for k in range(n_kfs):
        T = poses_true[k]
        j = 0
        for li in range(n_ln):
            a = edges[li, :3] @ T[:3, :3].T + T[:3, 3]
            b = edges[li, 3:] @ T[:3, :3].T + T[:3, 3]
            if a[2] < 0.3 or b[2] < 0.3 or j >= Fl:
                continue
            ua = np.array([K4[0] * a[0] / a[2] + K4[2],
                           K4[1] * a[1] / a[2] + K4[3], 1.0])
            ub = np.array([K4[0] * b[0] / b[2] + K4[2],
                           K4[1] * b[1] / b[2] + K4[3], 1.0])
            if not (0 < ua[0] < W and 0 < ub[0] < W):
                continue
            eq = np.cross(ua, ub)
            eq /= max(np.linalg.norm(eq[:2]), 1e-9)
            kf_ln[k, j] = li
            kf_ln_obs[k, j] = eq.astype(np.float32)
            kf_ln_xyz[k, j] = np.concatenate([a, b]).astype(np.float32)
            j += 1

    # BoW tf vectors from the observations: each map point hashes to a
    # vocabulary word, each keyframe's row is the normalised histogram of
    # its observed points' words, so co-visible keyframes share words as
    # DBoW2 rows do on real imagery
    Wv = cfg.map.vocab_words
    word_of_pt = (np.asarray(
        (np.arange(NP, dtype=np.uint64) * np.uint64(2654435761))
        % np.uint64(Wv))).astype(np.int64)
    kf_bow = np.zeros((NK, Wv), np.float32)
    for k in range(n_kfs):
        obs = kf_mp[k][kf_kp_valid[k]]
        np.add.at(kf_bow[k], word_of_pt[obs], 1.0)
        kf_bow[k] /= max(kf_bow[k].sum(), 1.0)

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=dev)

    st = make_empty_state(cfg, dev)
    st = st._replace(
        kf_bow=t(kf_bow),
        pt_pos=t(pts + pt_noise * rng.randn(NP, 3).astype(np.float32)),
        pt_valid=t(pt_seen),
        kf_pose=t(kf_pose),
        kf_valid=t(np.arange(NK) < n_kfs),
        kf_seq=t(np.where(np.arange(NK) < n_kfs, np.arange(NK), -1),
                 np.int32),
        kf_uv=t(kf_uv), kf_xyz=t(kf_xyz),
        kf_mp=t(kf_mp), kf_kp_valid=t(kf_kp_valid),
        kf_sigma2=t(kf_sigma2),
        kf_pl=t(kf_pl), kf_pl_par=t(kf_pl_par),
        kf_pl_ver=t(kf_pl_ver), kf_pl_obs=t(kf_pl_obs),
        kf_ln=t(kf_ln), kf_ln_obs=t(kf_ln_obs),
        kf_ln_xyz=t(kf_ln_xyz),
        pl_coef=t(pl_coef), pl_valid=t(pl_valid),
        ln_ep=t(ln_ep),
        ln_dir=t(np.tile([0.0, 1.0, 0.0], (NL, 1)), np.float32),
        ln_valid=t(ln_valid),
        n_pts=t(int(pt_seen.sum()), np.int32),
        n_kfs=t(n_kfs, np.int32),
        n_lns=t(n_ln, np.int32),
        kf_next_seq=t(n_kfs, np.int32))
    return st, poses_true
