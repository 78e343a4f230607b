"""Trajectory export in TUM format, and the Manhattan-frame projection.

Counterpart of the JAX package's `io/trajectory.py` (the reference's
System::SaveTrajectoryTUM, src/System.cc:379, SaveKeyFrameTrajectoryTUM
(:441) and SaveTrajectoryManhattan (:489)): rows are ``timestamp tx ty tz qx
qy qz qw`` of T_wc, for evo_ape. The inverse and the quaternion are taken in
float32 with the same formulas as the reference package, on the CPU, so both
write the same text for the same poses. The one step where the order of
rounding differs is the quaternion's norm: XLA sums the squares as a chain
of fused multiply-adds, which `_norm_fma` repeats."""

from __future__ import annotations

import numpy as np
import torch

from dr_slam_torch.geometry import se3


def _T_wc(T_cw) -> torch.Tensor:
    T = T_cw.detach().cpu() if isinstance(T_cw, torch.Tensor) \
        else torch.from_numpy(np.asarray(T_cw))
    return se3.inv_T(T.to(torch.float32))


def _norm_fma(q: np.ndarray) -> np.float32:
    """|q| for a float32 vector, its squares summed in order, each step
    one fused multiply-add: the product and the sum rounded once (exact in
    float64 before the rounding to float32)."""
    acc = np.float32(0.0)
    for x in q.astype(np.float64):
        acc = np.float32(x * x + np.float64(acc))
    return np.sqrt(acc)


def pose_to_tum_row(timestamp: float, T_cw) -> str:
    T_wc = _T_wc(T_cw)
    t = T_wc[:3, 3].numpy()
    q = se3.rot_to_quat_unnormalized(T_wc[:3, :3]).numpy()
    q = q / _norm_fma(q)
    return (f"{timestamp:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
            f"{q[0]:.7f} {q[1]:.7f} {q[2]:.7f} {q[3]:.7f}")


def save_trajectory_tum(path: str, timestamps, poses_cw) -> None:
    """Write a full-frame trajectory (System.cc:379-440)."""
    with open(path, "w") as f:
        for ts, T in zip(timestamps, poses_cw):
            f.write(pose_to_tum_row(float(ts), T) + "\n")


def save_keyframe_trajectory_tum(path: str, timestamps, poses_cw,
                                 valid=None) -> None:
    """Write a keyframe-only trajectory (System.cc:441-487)."""
    with open(path, "w") as f:
        for i, (ts, T) in enumerate(zip(timestamps, poses_cw)):
            if valid is not None and not bool(valid[i]):
                continue
            f.write(pose_to_tum_row(float(ts), T) + "\n")


def save_trajectory_manhattan(path: str, timestamps, poses_cw,
                              R_mw=None) -> None:
    """Write the camera positions rotated into the Manhattan frame by the
    world -> Manhattan rotation (System.cc:489-562)."""
    R = np.eye(3) if R_mw is None else np.asarray(R_mw)
    with open(path, "w") as f:
        for ts, T_cw in zip(timestamps, poses_cw):
            p = R @ _T_wc(T_cw)[:3, 3].numpy()
            f.write(f"{float(ts):.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f}\n")


def load_trajectory_tum(path: str):
    """-> (timestamps (N,), T_wc (N, 4, 4))."""
    ts, Ts = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            v = [float(x) for x in line.split()]
            ts.append(v[0])
            R = se3.quat_to_rot(torch.tensor(v[4:8], dtype=torch.float32))
            T = np.eye(4)
            T[:3, :3] = R.numpy()
            T[:3, 3] = v[1:4]
            Ts.append(T)
    return np.asarray(ts), np.asarray(Ts)
