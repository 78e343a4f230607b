"""Trajectory evaluation (ATE / RPE) and structured per-frame metrics.

Counterpart of the JAX package's `io/metrics.py`. The reference scores with
the external evo tools (run.sh:2-3: ``evo_ape tum <gt> CameraTrajectory.txt
-va``) and logs with raw couts; here an evo-equivalent ATE-RMSE (Umeyama
alignment, fixed scale by default, as evo's for SLAM) and JSONL metrics.
Plain numpy on the host."""

from __future__ import annotations

import json
import time
from typing import IO

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares rigid alignment src -> dst. Points are (N, 3).

    Returns (R, t, s) with dst ~ s * R @ src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray,
             align: bool = True, with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after (optional) Umeyama alignment:
    evo_ape's translation_part metric."""
    est = np.asarray(est_positions, dtype=np.float64)
    gt = np.asarray(gt_positions, dtype=np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        R, t, s = umeyama_alignment(est, gt, with_scale)
        est = est @ (s * R).T + t
    err = est - gt
    return float(np.sqrt((err ** 2).sum(-1).mean()))


def rpe(est_poses_wc: np.ndarray, gt_poses_wc: np.ndarray, delta: int = 1):
    """Relative pose error: (trans_rmse [m], rot_rmse [rad]) over delta-frame
    increments (evo_rpe equivalent)."""
    est = np.asarray(est_poses_wc, dtype=np.float64)
    gt = np.asarray(gt_poses_wc, dtype=np.float64)
    terrs, rerrs = [], []
    for i in range(len(est) - delta):
        de = np.linalg.inv(est[i]) @ est[i + delta]
        dg = np.linalg.inv(gt[i]) @ gt[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1) / 2, -1, 1)
        rerrs.append(np.arccos(c))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))


class MetricsLogger:
    """Structured JSONL metrics: one JSON object per event,
    {"t": wall_time, "event": ..., **fields}."""

    def __init__(self, path: str | None = None):
        self._fh: IO | None = open(path, "a") if path else None
        self.records: list[dict] = []

    def log(self, event: str, **fields):
        rec = {"t": time.time(), "event": event, **fields}
        self.records.append(rec)
        if self._fh:
            self._fh.write(json.dumps(rec, default=_to_py) + "\n")
            self._fh.flush()

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def _to_py(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    return str(o)
