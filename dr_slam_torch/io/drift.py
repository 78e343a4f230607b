"""Progressive-drift injection for loop-closure evaluation.

Counterpart of the JAX package's `io/drift.py`. The synthetic world's
plane, Manhattan and depth anchors hold natural drift below what loop
closing has to undo, so the evaluation injects it: every keyframe moves by a
twist scaled with its insertion sequence, every point, plane and line moves
with its newest observing keyframe, and the live pose rides the full twist
-- locally consistent, globally drifted. The map is edited on the host in
numpy and written back to the tracker's device."""

from __future__ import annotations

import numpy as np
import torch


def drift_T(frac: float, xi_t=(0.35, 0.0, 0.15), xi_r: float = 0.07
            ) -> np.ndarray:
    """SE3 twist at drift fraction ``frac`` in [0, 1]: a y-axis rotation of
    xi_r*frac radians plus translation xi_t*frac."""
    th = xi_r * frac
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                          [-np.sin(th), 0, np.cos(th)]], np.float32)
    T[:3, 3] = np.asarray(xi_t, np.float32) * frac
    return T


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def inject_progressive_drift(tr, xi_t=(0.35, 0.0, 0.15), xi_r: float = 0.07
                             ) -> None:
    """Apply progressive gauge drift to a `Tracker`'s map in place: keyframe
    k moves by drift_T(seq_k / max_seq); every landmark moves with its
    newest observing keyframe; the live pose rides the full twist."""
    tr.flush()
    st = tr.map_state
    kf_valid = _np(st.kf_valid)
    seqs = _np(st.kf_seq)
    max_seq = seqs.max()
    kf_pose = _np(st.kf_pose).copy()

    def newest_observer(kf_tab, n_items):
        newest = np.full(n_items, -1, np.int64)
        newest_seq = np.full(n_items, -1, np.int64)
        for k in np.where(kf_valid)[0]:
            ids = kf_tab[k][kf_tab[k] >= 0]
            upd = seqs[k] > newest_seq[ids]
            newest[ids[upd]] = k
            newest_seq[ids[upd]] = seqs[k]
        return newest

    shifts = {}
    for k in np.where(kf_valid)[0]:
        S = drift_T(seqs[k] / max(max_seq, 1), xi_t, xi_r)
        shifts[int(k)] = S
        kf_pose[k] = kf_pose[k] @ np.linalg.inv(S)
        if int(k) in tr.kf_pose_host:
            tr.kf_pose_host[int(k)] = (tr.kf_pose_host[int(k)]
                                       @ np.linalg.inv(S))
    pt = _np(st.pt_pos).copy()
    pt_newest = newest_observer(_np(st.kf_mp), pt.shape[0])
    for p in np.where(_np(st.pt_valid))[0]:
        S = shifts.get(int(pt_newest[p]))
        if S is not None:
            pt[p] = S[:3, :3] @ pt[p] + S[:3, 3]

    # planes and lines drift with their newest observing keyframe too, as
    # real odometry drift carries the whole local map
    pl_coef = _np(st.pl_coef).copy()
    pl_cloud = _np(st.pl_cloud).copy()
    pl_newest = newest_observer(_np(st.kf_pl), pl_coef.shape[0])
    for f in np.where(_np(st.pl_valid))[0]:
        S = shifts.get(int(pl_newest[f]))
        if S is not None:
            pl_coef[f] = np.linalg.inv(S).T @ pl_coef[f]
            pl_coef[f] /= np.linalg.norm(pl_coef[f][:3])
            if pl_coef[f][3] < 0:
                pl_coef[f] *= -1
            pl_cloud[f] = pl_cloud[f] @ S[:3, :3].T + S[:3, 3]
    ln_ep = _np(st.ln_ep).copy()
    ln_dir = _np(st.ln_dir).copy()
    ln_newest = newest_observer(_np(st.kf_ln), ln_ep.shape[0])
    for l in np.where(_np(st.ln_valid))[0]:
        S = shifts.get(int(ln_newest[l]))
        if S is not None:
            ln_ep[l, :3] = S[:3, :3] @ ln_ep[l, :3] + S[:3, 3]
            ln_ep[l, 3:] = S[:3, :3] @ ln_ep[l, 3:] + S[:3, 3]
            ln_dir[l] = S[:3, :3] @ ln_dir[l]

    dev = tr.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    tr.map_state = st._replace(kf_pose=t(kf_pose), pt_pos=t(pt),
                               pl_coef=t(pl_coef), pl_cloud=t(pl_cloud),
                               ln_ep=t(ln_ep), ln_dir=t(ln_dir))
    tr.T_cw = t(_np(tr.T_cw) @ np.linalg.inv(drift_T(1.0, xi_t, xi_r)))
