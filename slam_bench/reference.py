"""The plain reference that decides `correct`: the true camera poses, which
the benchmark itself defines (`frames.walk_poses`), brought into the map's
frame, and plain numpy arithmetic that compares the poses the program
returned with them. It imports nothing of the program and takes nothing
the program made; the program's outputs are only read here to be judged.

The map's frame is the camera frame of the first frame the map was built
from (the program puts its first keyframe at the origin), so the true pose
of frame i in the map's frame is T_cw(i) @ inv(T_cw(anchor)).

Numbers compared (each against its limit in `limits/<cell>.json`):
- `step_mm`: over consecutive frames, the largest gap between the program's
  and the true camera displacement, in mm: the per-frame motion that the
  front-end, the tracker and `pose_optimize` produce; `step_mean_mm`, the
  mean of the same gaps;
- `turn_mean_mdeg`: the mean over consecutive frames of the angle of the
  program's relative rotation against the true one, in thousandths of a
  degree (`turn_mdeg`, their largest, is printed and not compared);
- `kf_step_mm`: between keyframes consecutive in insertion order, the
  largest gap between the program's (after local mapping) and the true
  displacement, in mm;
- `orth_err`: over every pose judged (frames and keyframes), the largest
  entry of |R R^T - I|: each pose is a rigid motion to float32 rounding;
- `map_diff`: entries of the map that differ between the map as saved and
  the map as loaded (an exact comparison).
Printed beside them, not compared: the largest camera-centre error in the
map's frame (drift) and the ATE RMSE after Umeyama alignment."""

from __future__ import annotations

import numpy as np


def in_map_frame(T_cw_true: np.ndarray, T_anchor: np.ndarray) -> np.ndarray:
    """True world -> camera poses (N, 4, 4) re-expressed with the anchor
    camera's frame as the world."""
    return np.asarray(T_cw_true, np.float64) @ np.linalg.inv(
        np.asarray(T_anchor, np.float64))


def centres(T_cw: np.ndarray) -> np.ndarray:
    """Camera centres (N, 3): -R^T t."""
    T = np.asarray(T_cw, np.float64)
    return -np.einsum("nji,nj->ni", T[:, :3, :3], T[:, :3, 3])


def _angle_deg(R: np.ndarray) -> np.ndarray:
    """Rotation angles of (..., 3, 3) matrices, atan2(|axis part|, cos
    part), exact to rounding near 0 where arccos of the trace is not."""
    c = (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0
    w = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.degrees(np.arctan2(np.linalg.norm(w, axis=-1) / 2.0, c))


def step_gaps(est: np.ndarray, true: np.ndarray) -> tuple:
    """(displacement gaps in mm, rotation gaps in millidegrees), one per
    pair of consecutive poses of est and true (N, 4, 4)."""
    est = np.asarray(est, np.float64)
    true = np.asarray(true, np.float64)
    d_est = np.diff(centres(est), axis=0)
    d_true = np.diff(centres(true), axis=0)
    moved = np.linalg.norm(d_est - d_true, axis=-1) * 1e3
    R_e, R_t = est[:, :3, :3], true[:, :3, :3]
    rel_e = R_e[1:] @ np.swapaxes(R_e[:-1], -1, -2)
    rel_t = R_t[1:] @ np.swapaxes(R_t[:-1], -1, -2)
    turned = _angle_deg(rel_e @ np.swapaxes(rel_t, -1, -2)) * 1e3
    return moved, turned


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares rigid alignment src -> dst of (N, 3) points:
    (R, t) with dst ~ R @ src + t."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, _, Vt = np.linalg.svd(xd.T @ xs / len(src))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    return R, mu_d - R @ mu_s


def ate_rmse(est_pos: np.ndarray, true_pos: np.ndarray) -> float:
    """Absolute trajectory error RMSE after rigid Umeyama alignment
    (evo_ape's translation part, fixed scale)."""
    est = np.asarray(est_pos, np.float64)
    true = np.asarray(true_pos, np.float64)
    if len(est) >= 3:
        R, t = umeyama_alignment(est, true)
        est = est @ R.T + t
    return float(np.sqrt(((est - true) ** 2).sum(-1).mean()))


def orth_err(T: np.ndarray) -> float:
    """The largest entry of |R R^T - I| over poses (N, 4, 4)."""
    R = np.asarray(T, np.float64)[:, :3, :3]
    return float(np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max())


def frame_readings(est: np.ndarray, true: np.ndarray) -> dict:
    """The per-frame numbers of poses est against true (N, 4, 4), both in
    the map's frame."""
    moved, turned = step_gaps(est, true)
    drift = np.linalg.norm(centres(est) - centres(true), axis=-1)
    return {"step_mm": float(moved.max()), "step_mean_mm": float(moved.mean()),
            "turn_mean_mdeg": float(turned.mean()),
            "turn_mdeg": float(turned.max()), "orth_err": orth_err(est),
            "drift_mm": float(drift.max() * 1e3),
            "ate_mm": ate_rmse(centres(est), centres(true)) * 1e3}


def with_keyframes(readings: dict, kf_est: np.ndarray,
                   kf_true: np.ndarray) -> dict:
    """`readings` with `kf_step_mm` of the keyframes' poses (K, 4, 4) in
    insertion order, and their rigidity folded into `orth_err`."""
    moved, _ = step_gaps(kf_est, kf_true)
    out = dict(readings)
    out["kf_step_mm"] = float(moved.max()) if len(moved) else float("inf")
    out["orth_err"] = max(out["orth_err"], orth_err(kf_est))
    return out


def map_diff(saved: dict, loaded: dict) -> int:
    """Entries that differ between two maps given as {field: array}; a
    field missing from either, or of another shape, counts whole."""
    n = 0
    for k in saved.keys() | loaded.keys():
        a, b = saved.get(k), loaded.get(k)
        if a is None or b is None or a.shape != b.shape:
            n += int((a if a is not None else b).size)
            continue
        same = (a == b) | (np.isnan(a) & np.isnan(b)) \
            if a.dtype.kind == "f" else (a == b)
        n += int(a.size - np.count_nonzero(same))
    return n


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit: each reading has to be at most its limit, and a reading that is
    missing or not a number fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        v = readings.get(name)
        good = v is not None and np.isfinite(v) and v <= limit
        ok &= bool(good)
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
