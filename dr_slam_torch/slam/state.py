"""Map state: fixed-capacity tensors with validity masks.

Counterpart of the JAX package's `slam/state.py`, with the same field names,
shapes and capacities. Packed 256-bit descriptors, which the reference holds
as uint32, are int32 here with the same bit patterns: PyTorch does not
implement `>>` on uint32 on the CPU, and the bits move unchanged either way
(`io/map_io.py`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.config import SlamConfig


class MapState(NamedTuple):
    # --- map points ---------------------------------------------------------
    pt_pos: torch.Tensor        # (NP, 3) world
    pt_normal: torch.Tensor     # (NP, 3) mean viewing direction
    pt_desc: torch.Tensor       # (NP, 8) int32 distinctive descriptor
    pt_desc_ring: torch.Tensor  # (NP, R, 8) int32 recent observations
    pt_valid: torch.Tensor      # (NP,) bool
    pt_visible: torch.Tensor    # (NP,) int32 times predicted visible
    pt_found: torch.Tensor      # (NP,) int32 times matched
    pt_obs_count: torch.Tensor  # (NP,) int32 keyframes observing
    pt_first_kf: torch.Tensor   # (NP,) int32
    pt_angle: torch.Tensor      # (NP,) keypoint orientation at creation
    pt_dist_min: torch.Tensor   # (NP,) scale-invariance near bound (m)
    pt_dist_max: torch.Tensor   # (NP,) far bound (m); 0 = no gate
    # --- keyframes ------------------------------------------------------------
    kf_pose: torch.Tensor       # (NK, 4, 4) T_cw
    kf_valid: torch.Tensor      # (NK,) bool
    kf_seq: torch.Tensor        # (NK,) int32 insertion sequence (-1 dead)
    kf_ts: torch.Tensor         # (NK,)
    kf_uv: torch.Tensor         # (NK, K, 2)
    kf_ur: torch.Tensor         # (NK, K)
    kf_xyz: torch.Tensor        # (NK, K, 3)
    kf_desc: torch.Tensor       # (NK, K, 8) int32
    kf_sigma2: torch.Tensor     # (NK, K)
    kf_angle: torch.Tensor      # (NK, K)
    kf_kp_valid: torch.Tensor   # (NK, K) bool
    kf_mp: torch.Tensor         # (NK, K) int32 map-point id or -1
    kf_bow: torch.Tensor        # (NK, W) float32
    kf_word: torch.Tensor       # (NK, K) int32 vocabulary word per feature
    kf_pl: torch.Tensor         # (NK, Fp) int32
    kf_pl_par: torch.Tensor     # (NK, Fp) int32
    kf_pl_ver: torch.Tensor     # (NK, Fp) int32
    kf_pl_obs: torch.Tensor     # (NK, Fp, 4)
    kf_ln: torch.Tensor         # (NK, Fl) int32
    kf_ln_obs: torch.Tensor     # (NK, Fl, 3)
    kf_ln_xyz: torch.Tensor     # (NK, Fl, 6)
    # --- map planes ------------------------------------------------------------
    pl_coef: torch.Tensor       # (NF, 4) world (n, d)
    pl_valid: torch.Tensor      # (NF,) bool
    pl_cloud: torch.Tensor      # (NF, Q, 3)
    pl_cloud_valid: torch.Tensor  # (NF, Q)
    pl_obs_count: torch.Tensor  # (NF,) int32
    pl_first_kf: torch.Tensor   # (NF,) int32
    # --- map lines ---------------------------------------------------------------
    ln_ep: torch.Tensor         # (NL, 6) world endpoints
    ln_dir: torch.Tensor        # (NL, 3)
    ln_desc: torch.Tensor       # (NL, 8) int32
    ln_valid: torch.Tensor      # (NL,) bool
    ln_obs_count: torch.Tensor  # (NL,) int32
    ln_visible: torch.Tensor    # (NL,) int32
    ln_found: torch.Tensor      # (NL,) int32
    ln_first_kf: torch.Tensor   # (NL,) int32
    # --- Manhattan frame -----------------------------------------------------------
    R_wm: torch.Tensor          # (3, 3)
    manhattan_ok: torch.Tensor  # () bool
    # --- counters --------------------------------------------------------------------
    n_pts: torch.Tensor         # () int32
    n_kfs: torch.Tensor         # () int32
    n_lns: torch.Tensor         # () int32
    kf_next_seq: torch.Tensor   # () int32


def make_empty_state(cfg: SlamConfig, device=None) -> MapState:
    dev = resolve_device(device)
    m = cfg.map
    K = cfg.orb.max_keypoints
    NP, NK, NF, NL, Q, W = (m.max_points, m.max_keyframes, m.max_planes,
                            m.max_lines, cfg.plane.cloud_points, m.vocab_words)
    Fp = cfg.plane.max_planes
    Fl = cfg.line.max_lines
    f32, i32 = torch.float32, torch.int32

    def z(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def full(shape, v, dtype=i32):
        return torch.full(shape, v, dtype=dtype, device=dev)

    kf_pl_obs = z((NK, Fp, 4))
    kf_pl_obs[:, :, 2] = 1.0
    pl_coef = z((NF, 4))
    pl_coef[:, 2] = 1.0
    return MapState(
        pt_pos=z((NP, 3)), pt_normal=z((NP, 3)),
        pt_desc=z((NP, 8), i32), pt_desc_ring=z((NP, m.desc_ring, 8), i32),
        pt_valid=z(NP, torch.bool),
        pt_visible=z(NP, i32), pt_found=z(NP, i32),
        pt_obs_count=z(NP, i32), pt_first_kf=z(NP, i32),
        pt_angle=z(NP), pt_dist_min=z(NP), pt_dist_max=z(NP),
        kf_pose=torch.eye(4, device=dev).repeat(NK, 1, 1),
        kf_valid=z(NK, torch.bool), kf_seq=full((NK,), -1),
        kf_ts=z(NK), kf_uv=z((NK, K, 2)), kf_ur=z((NK, K)),
        kf_xyz=z((NK, K, 3)), kf_desc=z((NK, K, 8), i32),
        kf_sigma2=torch.ones((NK, K), device=dev), kf_angle=z((NK, K)),
        kf_kp_valid=z((NK, K), torch.bool),
        kf_mp=full((NK, K), -1), kf_bow=z((NK, W)),
        kf_word=z((NK, K), i32),
        kf_pl=full((NK, Fp), -1), kf_pl_par=full((NK, Fp), -1),
        kf_pl_ver=full((NK, Fp), -1), kf_pl_obs=kf_pl_obs,
        kf_ln=full((NK, Fl), -1), kf_ln_obs=z((NK, Fl, 3)),
        kf_ln_xyz=z((NK, Fl, 6)),
        pl_coef=pl_coef, pl_valid=z(NF, torch.bool),
        pl_cloud=z((NF, Q, 3)), pl_cloud_valid=z((NF, Q), torch.bool),
        pl_obs_count=z(NF, i32), pl_first_kf=full((NF,), -1),
        ln_ep=z((NL, 6)), ln_dir=z((NL, 3)), ln_desc=z((NL, 8), i32),
        ln_valid=z(NL, torch.bool), ln_obs_count=z(NL, i32),
        ln_visible=z(NL, i32), ln_found=z(NL, i32),
        ln_first_kf=full((NL,), -1),
        R_wm=torch.eye(3, device=dev),
        manhattan_ok=z((), torch.bool),
        n_pts=z((), i32), n_kfs=z((), i32), n_lns=z((), i32),
        kf_next_seq=z((), i32),
    )
