"""The traffic's frames: a textured Manhattan corridor rendered on the card,
quantised as a TUM PNG pair holds a frame (uint8 gray, uint16 depth at the
configuration's units per metre).

The renderer is a frozen copy of the port's plain renderer as it stood
before it was made to follow XLA's roundings: closed-form ray/plane and
ray/slab intersection over the pixel grid, a procedural texture of
per-cell rectangles at three cell sizes plus two sinusoids, and Gaussian
depth noise. It renders a batch of poses per call. It imports nothing of the
program: the pose inverse is numpy and the depth noise comes from a seeded
`torch.Generator` on the card.

Every random draw comes from the run's seed:
- the world (`world_draws`): each surface's texture phase and the salt of
  the cell hash, and the clutter boxes where the mix asks for them;
- the walk (`walk_poses`): the phases of the sway and a lateral offset;
- the depth noise: a `torch.Generator` seeded from the seed.
The step length and the sway's amplitudes and frequencies are the mix's and
never change with the seed."""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

N_SURFACES = 6


def corridor_planes(size) -> np.ndarray:
    """(6, 4) inward-facing planes (n, d), n.p + d = 0, of the box
    x in [0, size[0]], y in [0, size[1]] (y down), z in [0, size[2]]."""
    xmax, ymax, zmax = (float(s) for s in size)
    return np.array([
        [1, 0, 0, 0.0], [-1, 0, 0, xmax],      # side walls
        [0, 1, 0, 0.0], [0, -1, 0, ymax],      # ceiling, floor
        [0, 0, 1, 0.0], [0, 0, -1, zmax],      # back and end walls
    ], dtype=np.float32)


def _rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one named stream of draws of this seed."""
    return np.random.default_rng([int(seed) & (2**64 - 1),
                                  zlib.crc32(stream.encode())])


def world_draws(seed: int, world: dict, boxes_per_m: float = 0.0) -> dict:
    """The seed's texture phases (6,), hash salt and clutter boxes (B, 6)
    [xmin, ymin, zmin, xmax, ymax, zmax], floor-seated along the side walls
    (desks, cabinets and shelves), `boxes_per_m` per metre of corridor."""
    rng = _rng(seed, "world")
    phases = rng.uniform(0.0, 2.0 * math.pi, N_SURFACES).astype(np.float32)
    salt = float(rng.uniform(0.0, 100.0))
    xmax, ymax, zmax = world["size_m"]
    n_boxes = int(round(boxes_per_m * zmax))
    boxes = []
    for i in range(n_boxes):
        w = rng.uniform(0.4, 0.9)           # along the wall
        dpt = rng.uniform(0.3, 0.6)         # into the corridor
        hgt = rng.uniform(0.7, 1.6)         # up from the floor
        z0 = rng.uniform(0.5, zmax - 1.5)
        if i % 2 == 0:
            boxes.append([0.0, ymax - hgt, z0, dpt, ymax, z0 + w])
        else:
            boxes.append([xmax - dpt, ymax - hgt, z0, xmax, ymax, z0 + w])
    return {"phases": phases, "salt": salt,
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 6)}


def walk_poses(mix: dict, world: dict, seed: int, n: int,
               stream: str) -> np.ndarray:
    """(n, 4, 4) float64 world -> camera poses of a walk down the corridor's
    middle: `step_m` a frame along z from `start_z_m`, with a sway in x, y,
    yaw and pitch (each `amp * sin(freq * i + phase)`) and a lateral offset
    drawn from the seed. With `shuttle_frames` N > 0 the walk goes back and
    forth over its first N positions (0, 1, ..., N-1, N-2, ..., 1, 0, 1, ...)
    while the sway runs on with the frame index."""
    rng = _rng(seed, "walk:" + stream)
    sway = mix["sway"]
    ph = {k: float(rng.uniform(0.0, 2.0 * math.pi)) for k in sway}
    offset = float(rng.uniform(-1.0, 1.0)) * mix["lateral_offset_m"]
    xmax, ymax, _ = world["size_m"]
    shuttle = int(mix.get("shuttle_frames", 0))
    i = np.arange(n, dtype=np.float64)
    if shuttle > 1:
        period = 2 * (shuttle - 1)
        k = np.mod(np.arange(n), period)
        pos = np.where(k < shuttle, k, period - k).astype(np.float64)
    else:
        pos = i

    def s(name):
        a = sway[name]
        return a["amp"] * np.sin(a["freq"] * i + ph[name])

    x = xmax / 2 + offset + s("x")
    y = ymax / 2 + s("y")
    z = mix["start_z_m"] + mix["step_m"] * pos
    yaw, pitch = s("yaw"), s("pitch")
    cy, sy, cp, sp = np.cos(yaw), np.sin(yaw), np.cos(pitch), np.sin(pitch)
    one, zero = np.ones(n), np.zeros(n)
    R_y = np.stack([np.stack([cy, zero, sy], -1), np.stack([zero, one, zero], -1),
                    np.stack([-sy, zero, cy], -1)], -2)
    R_x = np.stack([np.stack([one, zero, zero], -1), np.stack([zero, cp, -sp], -1),
                    np.stack([zero, sp, cp], -1)], -2)
    R_wc = R_y @ R_x                       # the camera looks along +z
    c = np.stack([x, y, z], -1)
    T_cw = np.tile(np.eye(4), (n, 1, 1))
    T_cw[:, :3, :3] = np.swapaxes(R_wc, -1, -2)
    T_cw[:, :3, 3] = -np.einsum("nji,nj->ni", R_wc, c)
    return T_cw


_C_U = float(np.float32(12.9898))


def _texture(p, surf, phase_off, phases, salt):
    """Procedural gray at world points p (..., 3) on surfaces surf (...,):
    isolated rectangles of per-cell pseudo-random brightness at three cell
    sizes (L-shaped corners for FAST) plus two sinusoids; the surface picks
    the in-plane (u, v) chart and the phase, and clutter boxes add their
    own offset."""
    u = torch.where(surf < 2, p[..., 2], p[..., 0])
    v = torch.where(surf < 2, p[..., 1],
                    torch.where(surf < 4, p[..., 2], p[..., 1]))
    phase = phases[surf] + phase_off

    def rect_layer(freq, key):
        tu = u * freq + phase
        tv = v * freq + 0.3 * phase
        cu = torch.floor(tu)
        cv = torch.floor(tv)

        def cell_hash(k):
            a = (cu.double() * _C_U + (cv * 78.233).double()
                 + phase.double() + (key + k) * 3.7 + salt)
            h = torch.sin(a) * 43758.5453
            return (h - torch.floor(h)).float()   # per-cell uniform [0, 1)

        rnd = cell_hash(0)
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
         + 36.0 * rect_layer(0.8, 11) + 9.0 * coarse + 5.0 * mid)
    return torch.clamp(g, 0.0, 255.0)


def render_batch(T_cw: np.ndarray, planes, K4, height: int, width: int,
                 draws: dict, noise_per_m: float,
                 gen: torch.Generator | None, device) -> tuple:
    """(gray (B, H, W) float32 in [0, 255], depth (B, H, W) float32 metres,
    0 where no surface is hit) of the poses T_cw (B, 4, 4) on `device`.
    Depth noise: sigma = noise_per_m * z, drawn from `gen`."""
    f32 = torch.float32
    T_wc = np.linalg.inv(np.asarray(T_cw, np.float64))
    R_wc = torch.as_tensor(T_wc[:, :3, :3], dtype=f32, device=device)
    origin = torch.as_tensor(T_wc[:, :3, 3], dtype=f32, device=device)
    planes = torch.as_tensor(planes, dtype=f32, device=device)
    phases = torch.as_tensor(draws["phases"], dtype=f32, device=device)
    boxes = torch.as_tensor(draws["boxes"], dtype=f32, device=device)
    B = R_wc.shape[0]

    fx, fy, cx, cy = (float(k) for k in K4)
    us = torch.arange(width, dtype=f32, device=device)
    vs = torch.arange(height, dtype=f32, device=device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d_cam = torch.stack([(uu - cx) / fx, (vv - cy) / fy, torch.ones_like(uu)],
                        -1)
    # (B, H, W, 3); the camera z-depth of o + t * d_world is t
    d_world = torch.einsum("hwc,bkc->bhwk", d_cam, R_wc)
    o = origin[:, None, None, :]

    n, d0 = planes[:, :3], planes[:, 3]
    denom = torch.einsum("bhwc,pc->bhwp", d_world, n)
    numer = -(origin @ n.T + d0)[:, None, None, :]
    t = numer / torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    t = torch.where((t > 1e-3) & (denom < 0), t, torch.inf)   # front side
    t_hit = torch.amin(t, -1)
    surf = torch.argmin(t, -1)
    phase_off = torch.zeros_like(t_hit)
    if boxes.shape[0]:
        d_safe = torch.where(torch.abs(d_world) < 1e-9, 1e-9, d_world)
        for b in range(boxes.shape[0]):
            t1 = (boxes[b, :3] - o) / d_safe
            t2 = (boxes[b, 3:] - o) / d_safe
            tn_ax = torch.minimum(t1, t2)
            tn = torch.max(tn_ax, -1).values
            tf = torch.min(torch.maximum(t1, t2), -1).values
            hit_b = ((tf > torch.clamp(tn, min=1e-3)) & (tn > 1e-3)
                     & (tn < t_hit))
            # the entry face's axis picks the chart as the wall pair does
            t_hit = torch.where(hit_b, tn, t_hit)
            surf = torch.where(hit_b, 2 * torch.argmax(tn_ax, -1), surf)
            phase_off = torch.where(hit_b, (b + 1) * 5.1, phase_off)
    hit = torch.isfinite(t_hit)
    t_hit = torch.where(hit, t_hit, 0.0)
    p_world = o + t_hit[..., None] * d_world
    gray = torch.where(hit, _texture(p_world, surf, phase_off, phases,
                                     draws["salt"]), 0.0)
    depth = t_hit
    if noise_per_m:
        noise = torch.randn(depth.shape, generator=gen, device=device,
                            dtype=f32)
        depth = torch.where(hit, depth + noise_per_m * depth * noise, 0.0)
    return gray, depth


def quantise(gray, depth, depth_factor: float) -> tuple:
    """A TUM PNG pair's content, on the device: uint8 gray (rounded), and
    depth in uint16 sensor units (rounded; 0, no reading, where the depth
    does not fit 16 bits), held as int32 until it reaches the host."""
    g = torch.clamp(gray + 0.5, 0, 255).to(torch.uint8)
    d = torch.floor(depth * depth_factor + 0.5)
    d = torch.where((d > 0) & (d <= 65535), d, 0.0).to(torch.int32)
    return g, d


def render_sequence(poses: np.ndarray, cam: dict, draws: dict,
                    noise_per_m: float, seed: int, device,
                    batch: int = 16) -> tuple:
    """Render and quantise every pose; -> (gray uint8 (N, H, W), depth
    uint16 (N, H, W)) numpy arrays on the host."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & (2**63 - 1))
    planes = cam["planes"]
    N, H, W = len(poses), cam["height"], cam["width"]
    gray = np.empty((N, H, W), np.uint8)
    depth = np.empty((N, H, W), np.uint16)
    for a in range(0, N, batch):
        g, d = render_batch(poses[a:a + batch], planes, cam["K4"], H, W,
                            draws, noise_per_m, gen, device)
        g, d = quantise(g, d, cam["depth_factor"])
        gray[a:a + batch] = g.cpu().numpy()
        depth[a:a + batch] = d.cpu().numpy().astype(np.uint16)
    return gray, depth


def decode(gray_u8: np.ndarray, depth_u16: np.ndarray,
           depth_factor: float) -> tuple:
    """A frame as the TUM reader hands it to `track_rgbd`: float32 gray in
    [0, 255] and float32 depth in metres (value / depth factor)."""
    return (np.asarray(gray_u8, dtype=np.float32),
            np.asarray(depth_u16, dtype=np.float32) / depth_factor)
