"""Synthetic Manhattan-world RGB-D sequences, rendered on the device.

Counterpart of the JAX package's `io/synthetic.py`: an axis-aligned box
room (and optional clutter boxes), textured with per-cell random rectangles
and sinusoids so FAST finds corners, the line detector edges and the plane
segmenter large planes; rendering is closed-form ray/plane and ray/slab
intersection over the pixel grid, computed once per call (nothing is
compiled). The trajectories and the clutter are numpy, as in the reference.

`render_frame` computes the bits of the JAX package's jitted `render_frame`
on an x86-64 CPU with AVX-512 and FMA, on the CPU and on the card alike:
every operation is an elementwise float32 or float64 PyTorch op whose
result IEEE arithmetic fixes, in the order XLA's CPU code runs it. The
rules, read from XLA's optimized HLO, its LLVM IR and the objects'
disassembly (jax 0.9.0):
- The four dots stay dots (K = 3), emitted as loops, not Eigen or YNNPACK
  calls: R^T t, the planes' normals against the origin and against each
  ray are FMA chains in index order from 0; of a ray's direction
  d_cam @ R_wc^T, LLVM packs x and y into one vector and rounds each
  product and sum, and makes z an FMA chain (`_intersect`).
- Divisions stay divisions (`(u - cx) / fx`, the plane hits, the slabs);
  the port divides by tensors, as CUDA multiplies by the reciprocal of a
  Python scalar divisor.
- LLVM contracts a product into the add or subtract that consumes it when
  the product has no other use, the add's first operand first:
  `origin + t * d` is t * d - R^T t in one FMA, and in the texture the
  cell coordinates `u * freq + phase`, the hash's argument (cu * 12.9898
  fused into the add of cv * 78.233), the rectangles' offsets and sizes,
  their brightness, the sinusoids' arguments and the final sum's
  100, 9 and 5 terms are FMAs (`_texture` says which); the 42 and 36 terms
  pass through a select and are rounded. The depth noise is
  depth + sigma * normal in one FMA.
- Without clutter boxes the phase offset is a constant zero, and XLA's
  simplifier folds 0.3 * (idx * 1.7) and 2 * (idx * 1.7) into one product
  by a float32 constant each.
- `jnp.sin` / `jnp.cos` call glibc's sinf / cosf, which are not correctly
  rounded: `utils/fmath.py` evaluates their algorithm (`torch.sin` differs
  between Sleef on the CPU and CUDA's `sinf`, and from glibc on both).
tests/test_torch_synthetic.py holds gray and depth bit-equal at 160x120,
320x240 and 640x480 for the corridor, the office clutter and a small
room, with depth noise too; `chip_smoke.py` phase 11 holds the card's
renders bit-equal to the host CPU's."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.geometry import se3
from dr_slam_torch.utils import fmath
from dr_slam_torch.utils.fmath import fma
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


_F32 = np.float32
# the texture's constants as float32, and the two products of constants
# XLA's algebraic simplifier folds when the phase offset is zero:
# 0.3 * (idx * 1.7) = idx * (0.3 * 1.7), 2 * (idx * 1.7) = idx * 3.4
_PHASE = _F32(1.7)
_PHASE_03 = float(_F32(0.3) * _F32(1.7))
_PHASE_2 = float(_F32(2.0) * _F32(1.7))
_RECT = ((3.0, 0), (11.0, 5), (0.8, 11))    # (cell frequency, hash key)


def _cell_hashes(bases: list) -> list:
    """Per rectangle layer, its five per-cell uniforms fract(sin(base +
    (key + k) * 3.7) * 43758.5453), k = 0..4. A base is one value per cell,
    so sinf runs once per distinct value, all layers in one call."""
    uniq, inv, args = [], [], []
    for base, (_, key) in zip(bases, _RECT):
        u, i = torch.unique(base, return_inverse=True)
        uniq.append(len(u))
        inv.append(i)
        args += [u + (key + k) * 3.7 if key + k else u for k in range(5)]
    h = fmath.sinf(torch.cat(args)) * 43758.5453
    fract = (h - torch.floor(h)).split([n for n in uniq for _ in range(5)])
    return [[fract[5 * layer + k][i] for k in range(5)]
            for layer, i in enumerate(inv)]


def _texture(p: torch.Tensor, plane_idx: torch.Tensor,
             phase_offset: torch.Tensor | None) -> torch.Tensor:
    """Procedural gray texture at world points p (..., 3) on surfaces
    plane_idx (..., int64): isolated rectangles of per-cell pseudo-random
    brightness at three cell sizes (L-shaped corners for FAST), plus two
    sinusoids. plane_idx selects the in-plane (u, v) chart and the phase;
    phase_offset (None where the scene has no clutter boxes) makes box
    faces differ from the walls.

    Every `a + b * c` whose product has no other use is one FMA (`fmath.
    fma`), as LLVM contracts XLA's loop fusion; `fma(a, b, c)` below says
    which; sin and cos are glibc's (`fmath.sinf` / `fmath.cosf`)."""
    u = torch.where(plane_idx < 2, p[..., 2], p[..., 0])
    v = torch.where(plane_idx < 2, p[..., 1],
                    torch.where(plane_idx < 4, p[..., 2], p[..., 1]))
    fidx = plane_idx.to(torch.float32)
    if phase_offset is None:
        phase = fidx * float(_PHASE)
        phase_03 = fidx * _PHASE_03
    else:
        phase = fma(fidx, _PHASE, phase_offset)
        phase_03 = phase * 0.3
    cells = []
    for freq, _ in _RECT:
        tu = fma(u, freq, phase)
        tv = fma(v, freq, phase_03)
        cu = torch.floor(tu)
        cv = torch.floor(tv)
        cells.append((tu - cu, tv - cv,
                      fma(cu, 12.9898, cv * 78.233) + phase))
    g = None
    for layer, ((fu, fv, _), hashes) in enumerate(
            zip(cells, _cell_hashes([c[2] for c in cells]))):
        rnd, h1, h2, h3, h4 = hashes
        ou = fma(h1, 0.25, 0.05)
        ov = fma(h2, 0.25, 0.05)
        su = fma(h3, 0.4, 0.3)
        sv = fma(h4, 0.4, 0.3)
        inside = (fu > ou) & (fu < ou + su) & (fv > ov) & (fv < ov + sv)
        val = fma(rnd, 0.65, 0.35)
        if layer == 0:
            g = torch.where(inside, fma(val, 100.0, 55.0), 55.0)
        else:
            g = g + torch.where(inside, val * (42.0, 36.0)[layer - 1], 0.0)
    if phase_offset is None:
        mid_arg = fma(fidx, _PHASE_2, u * 7.3)
    else:
        mid_arg = fma(u, 7.3, phase * 2.0)
    # sin(coarse), sin(mid) in one call, cos(coarse), cos(mid) in another
    sins = fmath.sinf(torch.stack([fma(u, 2.1, phase), mid_arg]))
    coss = fmath.cosf(torch.stack([fma(v, 1.7, phase), fma(v, 6.1, phase)]))
    g = fma(sins[0] + coss[0], 9.0, g)
    g = fma(sins[1] * coss[1], 5.0, g)
    return torch.clamp(g, 0.0, 255.0)


def _dot_chain(terms, neg: bool = False) -> torch.Tensor:
    """sum of a_k * b_k in k order as one FMA chain from 0 (XLA's small
    dots on the CPU), each product negated if `neg`."""
    acc = None
    for a, b in terms:
        a = -a if neg else a
        acc = a * b if acc is None else fma(a, b, acc)
    return acc


def _intersect(T_cw: torch.Tensor, planes: torch.Tensor, K4, height: int,
               width: int, boxes: torch.Tensor | None):
    """Each pixel's ray against the room's planes and the clutter boxes ->
    (t_hit (H, W), inf on a miss; surface index (H, W), 0-5 the planes,
    0/2/4 a box face by its normal's axis; texture phase offset (H, W) or
    None without boxes, (b + 1) * 5.1 on box b, 0 elsewhere; ray directions
    (H, W, 3) with z-depth 1; R^T t (3,), the camera origin negated).

    The sums are XLA's: R^T t, the plane normals' products with the origin
    and with each ray are FMA chains in index order; of a ray's direction
    d_cam @ R_wc^T the x and y are rounded after each product and add, the
    z is an FMA chain (LLVM packs x and y into one vector and contracts only
    z). Divisions stay divisions."""
    dev = T_cw.device
    f32 = torch.float32
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    rtt = torch.stack([_dot_chain([(R[c, j], t[c]) for c in range(3)])
                       for j in range(3)])
    origin = -rtt

    fx, fy, cx, cy = (torch.tensor(float(k), dtype=f32, device=dev)
                      for k in K4)
    # divided by tensors: CUDA multiplies by the reciprocal of a Python
    # scalar divisor
    xs = (torch.arange(width, dtype=f32, device=dev) - cx) / fx
    ys = (torch.arange(height, dtype=f32, device=dev) - cy) / fy
    y, x = torch.meshgrid(ys, xs, indexing="ij")
    d_world = torch.stack(
        [(x * R[0, j] + y * R[1, j]) + R[2, j] for j in range(2)]
        + [fma(y, R[1, 2], x * R[0, 2]) + R[2, 2]], -1)

    n = planes[:, :3]                     # (P, 3)
    d0 = planes[:, 3]                     # (P,)
    denom = torch.stack([_dot_chain([(d_world[..., c], n[q, c])
                                     for c in range(3)])
                         for q in range(planes.shape[0])], -1)
    # -(origin . n + d0), origin . n the chain of -(R^T t) * n
    numer = -(_dot_chain([(rtt[c], n[:, c]) for c in range(3)], neg=True)
              + d0)
    t = numer / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t = torch.where((t > 1e-3) & (denom < 0), t, torch.inf)  # front side only
    t_hit = torch.amin(t, -1)
    idx = torch.argmin(t, -1)
    phase_off = None

    if boxes is not None and boxes.shape[0] > 0:
        phase_off = torch.zeros_like(t_hit)
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
    return t_hit, idx, phase_off, d_world, rtt


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
    t_hit, idx, phase_off, d_world, rtt = _intersect(
        T_cw, planes, K4, height, width, boxes)
    hit = torch.isfinite(t_hit)
    t_hit = torch.where(hit, t_hit, 0.0)

    # origin + t * d as XLA has it: t * d - R^T t, one FMA
    p_world = torch.stack([fma(t_hit, d_world[..., c], -rtt[c])
                           for c in range(3)], -1)
    gray = torch.where(hit, _texture(p_world, idx, phase_off), 0.0)
    depth = torch.where(hit, t_hit, 0.0)
    if depth_noise_key is not None:
        sigma = 0.0012 * depth * depth if quadratic_noise else 0.001 * depth
        noise = normal(depth_noise_key, depth.shape, T_cw.device)
        depth = torch.where(hit, fma(sigma, noise, depth), 0.0)
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
