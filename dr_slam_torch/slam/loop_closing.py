"""Loop closing: detection, geometric verification, correction, global BA.

Counterpart of the JAX package's `slam/loop_closing.py` (the capability of
the reference's LoopClosing thread, src/LoopClosing.cc): DetectLoop (:108)
with BoW candidates gated by the covisible neighbours' least score and a
consistency streak over consecutive keyframes; ComputeSim3 (:277) as
descriptor matches between two keyframes' measured 3D points, Horn-RANSAC
and a stereo reprojection refinement; CorrectLoop (:448) as one pose-graph
solve, every landmark moved with its newest observer's correction, a seam
fuse, then a global bundle adjustment.

The global BA runs as the reference's detached thread does
(LoopClosing.cc:625): `dispatch_gba` enqueues it on a CUDA stream of its
own behind an event, so the tracker's stream does not wait for it, and
`resolve_gba` merges it once the event has passed (at once on the CPU). The
host still pays for enqueueing every launch of the solve at dispatch
(`dispatch_seconds`). Detection and edge building run on the host in numpy
over a few (NK,)-sized readbacks, as in the reference package."""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.associate import keyframe_db
from dr_slam_torch.associate.vocabulary import bow_scores
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.geometry import se3
from dr_slam_torch.ops.hamming import hamming_matrix, mutual_best_matches
from dr_slam_torch.optimize.global_ba import bundle_adjust, problem_from_state
from dr_slam_torch.optimize.pose_graph import PoseGraph, optimize_pose_graph
from dr_slam_torch.optimize.pose_opt import PoseObservations, pose_optimize
from dr_slam_torch.optimize.sim3 import sim3_ransac
from dr_slam_torch.slam import map_ops
from dr_slam_torch.slam.state import MapState
from dr_slam_torch.utils.profiling import stage_span


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _covis_counts(state: MapState, kf_id: int) -> torch.Tensor:
    """(NK,) shared-map-point counts between kf_id and every keyframe."""
    return map_ops.covisible_keyframes(state, state.kf_mp[kf_id])


def _covis_full(state: MapState) -> torch.Tensor:
    """(NK, NK) shared-point counts as one product of the (NK, NP)
    observation indicator with itself (KeyFrame::UpdateConnections). The
    counts are integers far below 2^24 and TF32 is off: exact."""
    NK, K = state.kf_mp.shape
    NP = state.pt_pos.shape[0]
    dev = state.kf_mp.device
    rows = torch.arange(NK, device=dev).repeat_interleave(K)
    cols = state.kf_mp.reshape(-1).to(torch.int64)
    # unobserved entries go to a dump column
    ind = torch.zeros((NK, NP + 1), dtype=torch.float32, device=dev)
    ind.index_put_((rows, torch.where(cols >= 0, cols, NP)),
                   torch.ones((), device=dev))
    ind = ind[:, :NP]
    C = ind @ ind.T
    v = state.kf_valid.to(torch.float32)
    return C * v[:, None] * v[None, :]


def _match_kf_pairs(state: MapState, kf_a: int, kf_b: int):
    """Descriptor matches between two keyframes' depth-backed features ->
    camera-frame 3D pairs for Horn alignment, from the keyframes' stored
    measured backprojections (kf_xyz), which are rigid per keyframe where
    drift-deformed map positions are not; plus the matched feature index
    in kf_b for the reprojection refinement."""
    def depth_ok(kf):
        z = state.kf_xyz[kf][:, 2]
        return (state.kf_ur[kf] >= 0) & (z > 0.1) & (z < 8.0)

    va = state.kf_kp_valid[kf_a] & depth_ok(kf_a)
    vb = state.kf_kp_valid[kf_b] & depth_ok(kf_b)
    D = torch.where(va[:, None] & vb[None, :],
                    hamming_matrix(state.kf_desc[kf_a], state.kf_desc[kf_b]),
                    torch.inf)
    match, _ = mutual_best_matches(D, max_dist=60.0, ratio=0.8)
    ok = match >= 0
    Xa = state.kf_xyz[kf_a]
    Xb = state.kf_xyz[kf_b][torch.clamp(match, min=0)]
    return Xa, Xb, ok, match


def _refine_loop_rel(state: MapState, cur_kf: int, Xa, match_b, ok, T_rel,
                     K4, bf: float):
    """Refine the loop transform by the reprojection of the loop keyframe's
    measured points (camera-frame Xa) against their matched stereo
    observations (u, v, uR) in the current keyframe (the role of
    OptimizeSim3, Optimizer.cc:3982). A trust region keeps the Horn
    estimate if the refinement moved more than 0.3 m / 0.2 rad from it. The
    acceptance count uses a fixed 8 px radius. -> (T_rel, n_ok)."""
    K = Xa.shape[0]
    mb = torch.clamp(match_b, min=0)
    uv_b = state.kf_uv[cur_kf][mb]
    ur_b = state.kf_ur[cur_kf][mb]
    sigma2 = state.kf_sigma2[cur_kf][mb]
    obs = PoseObservations.empty(K, 1, 1, 1, Xa.device)._replace(
        pt_world=Xa, pt_obs=torch.cat([uv_b, ur_b[:, None]], -1),
        pt_inv_sigma2=1.0 / torch.clamp(sigma2, min=1e-6), pt_valid=ok)
    opt = pose_optimize(T_rel, obs, K4, bf=bf, n_rounds=2, n_iters=8)
    d = opt.T_cw @ se3.inv_T(T_rel)
    moved_t = torch.linalg.norm(d[:3, 3])
    moved_r = torch.arccos(torch.clamp((torch.trace(d[:3, :3]) - 1) / 2,
                                       -1, 1))
    good = (opt.n_inliers >= 15) & (moved_t < 0.3) & (moved_r < 0.2)
    T_out = torch.where(good, opt.T_cw, T_rel)
    Xc = se3.transform_points(T_out, Xa)
    err = torch.linalg.norm(se3.project(K4, Xc) - uv_b, dim=-1)
    return T_out, torch.sum(ok & (Xc[:, 2] > 0.1) & (err < 8.0))


@dataclass
class LoopCloser:
    """`LoopCloser(cfg, device=...)`; `device` defaults to cuda and raises
    without a GPU unless "cpu" is passed. The correction's stages run in
    `stage_span`s (`loop.pose_graph`, `loop.reanchor`, `loop.fuse`)."""
    cfg: SlamConfig
    min_kf_gap: int = 10          # temporal exclusion window
    consistency_needed: int = 2   # consecutive detections (reference: 3)
    run_gba: bool = True
    gba_async: bool = True        # the detached global BA (LoopClosing.cc:625)
    device: object = None
    dispatch_seconds: float = 0.0  # host time of the last dispatch_gba
    gba_events: tuple = None       # CUDA events around the last GBA's work
    _pending_gba: object = None
    _consistency: dict = field(default_factory=dict)
    _last_fire_seq: int = -1000   # cooldown (mLastLoopKFid, LoopClosing.cc:114)
    # accepted loop constraints, kept for every later correction as the
    # reference's essential graph keeps its loop edges; keyed by insertion
    # sequence so slot reuse cannot alias an edge:
    # (seq_loop, seq_cur, T_rel 4x4: T_cur' = T_rel @ T_loop)
    _accepted_loops: list = field(default_factory=list)

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def process(self, state: MapState, cur_kf: int,
                odom: dict | None = None) -> tuple[MapState, bool]:
        """One detection step for the freshly inserted keyframe cur_kf.

        Two detection paths feed the same verification and correction: the
        classic one (BoW candidates among non-covisible keyframes,
        LoopClosing.cc:108), and the seam one (cur_kf became strongly
        covisible with a temporally distant keyframe: the tracker
        reconnected across the loop). `odom`: {seq -> (prev_seq, T_rel)}
        measured at insertion (Tracker.kf_odom_host), the temporal edges'
        measurements."""
        if int(state.n_kfs) < self.min_kf_gap + 2:
            return state, False

        # ---- detection -----------------------------------------------------
        valid = _host(state.kf_valid)
        seq = _host(state.kf_seq)
        if int(seq[cur_kf]) - self._last_fire_seq < self.min_kf_gap:
            return state, False  # cooldown after a correction
        scores = _host(bow_scores(state.kf_bow[cur_kf], state.kf_bow,
                                  state.kf_valid))
        covis = _host(_covis_counts(state, cur_kf))
        neighbor = covis > 10
        neighbor[cur_kf] = True
        recent = np.abs(seq - seq[cur_kf]) < self.min_kf_gap
        min_score = float(scores[neighbor & (scores > 0)].min()) \
            if (neighbor & (scores > 0)).any() else 0.05
        # shared-word gate, the neighbours' minScore floor, then group
        # accumulation (KeyFrameDatabase.cc:76-199, LoopClosing.cc:135)
        common = _host(keyframe_db.common_word_counts(
            state.kf_bow[cur_kf], state.kf_bow, state.kf_valid))
        allowed = valid & ~neighbor & ~recent
        candidates = keyframe_db.group_candidates(
            scores, common, _host(_covis_full(state)), allowed,
            min_score=min_score)
        if len(candidates) == 0:
            self._consistency = {}
            confirmed = []
        else:
            # consistency across consecutive keyframes (LoopClosing.cc:
            # 199-257), keyed by insertion sequence
            new_consistency = {}
            confirmed = []
            for c in candidates:
                streak = 1 + max((v for k, v in self._consistency.items()
                                  if abs(k - seq[c]) <= 3), default=0)
                new_consistency[int(seq[c])] = streak
                if streak >= self.consistency_needed:
                    confirmed.append(int(c))
            self._consistency = new_consistency

        # ---- geometric verification (ComputeSim3) -----------------------------
        # the best by score plus the oldest by sequence: true loop partners
        # are old, self-similar false positives cluster near the recent end
        by_score = sorted(confirmed, key=lambda c: -scores[c])[:5]
        by_age = sorted(confirmed, key=lambda c: seq[c])[:3]
        trials = [(b, False) for b in dict.fromkeys(by_age + by_score)]
        # seam partner: the strongest covisible keyframe far back in sequence
        seam_mask = (valid & (covis > 30)
                     & (np.abs(seq - seq[cur_kf]) > self.min_kf_gap))
        if seam_mask.any():
            partner = int(np.argmax(np.where(seam_mask, covis, -1)))
            if partner not in [b for b, _ in trials]:
                trials.append((partner, True))

        for best, is_seam in trials:
            Xa, Xb, ok, match_b = _match_kf_pairs(state, best, cur_kf)
            n_pairs = int(torch.sum(ok))
            if n_pairs < 20:
                continue
            # T maps candidate-frame coordinates to current-frame ones
            T_rel, _, n_inl = sim3_ransac(Xa, Xb, ok, inlier_dist=0.10)
            # a seam correction rewrites the graph off one pair: demand a
            # dominant rigid consensus
            need = max(30, int(0.4 * n_pairs)) if is_seam else 12
            if int(n_inl) < need:
                continue
            T_rel, n_reproj = _refine_loop_rel(
                state, cur_kf, Xa, match_b, ok, T_rel, self.cfg.camera.K4,
                self.cfg.camera.bf)
            if int(n_reproj) < 12:
                continue
            # fire only where the graph disagrees with the measurement
            poses = _host(state.kf_pose)
            T_est = poses[cur_kf] @ np.linalg.inv(poses[best])
            delta = _host(T_rel) @ np.linalg.inv(T_est)
            d_t = float(np.linalg.norm(delta[:3, 3]))
            d_r = float(np.arccos(np.clip(
                (np.trace(delta[:3, :3]) - 1) / 2, -1, 1)))
            if d_t < 0.02 and d_r < 0.005:
                continue

            # ---- correction ---------------------------------------------------
            state = self._correct(state, cur_kf, best, T_rel, odom)
            self._accepted_loops.append(
                (int(seq[best]), int(seq[cur_kf]),
                 _host(T_rel).astype(np.float32)))
            self._consistency = {}
            self._last_fire_seq = int(seq[cur_kf])
            return state, True
        return state, False

    # ------------------------------------------------------------------
    def _correct(self, state: MapState, cur_kf: int, loop_kf: int,
                 T_rel: torch.Tensor, odom: dict | None = None) -> MapState:
        """Essential-graph correction (CorrectLoop, LoopClosing.cc:448)."""
        dev = self.device
        NK = state.kf_pose.shape[0]
        valid = _host(state.kf_valid)
        seq = _host(state.kf_seq)
        alive = np.where(valid)[0]
        order = alive[np.argsort(seq[alive])]  # slots in temporal order
        poses_np = _host(state.kf_pose)

        # edge table: the temporal chain (measured by the odometry captured
        # at insertion where it exists), near-temporal covisibility edges,
        # past loop edges and the new loop edge
        edges_i, edges_j, weights, meas = [], [], [], []
        odom = odom or {}
        for a, b in zip(order[:-1], order[1:]):
            edges_i.append(int(a))
            edges_j.append(int(b))
            weights.append(1.0)
            rec = odom.get(int(seq[b]))
            if rec is not None and rec[0] == int(seq[a]):
                # stored: T_b @ inv(T_a); the edge measures T_a @ inv(T_b)
                meas.append(np.linalg.inv(rec[1]).astype(np.float32))
            else:
                meas.append(poses_np[a] @ np.linalg.inv(poses_np[b]))

        def _odom_rel(lo_seq: int, hi_seq: int):
            """T_lo @ inv(T_hi) composed from per-insertion odometry, or
            None where the prev-pointer chain is broken (reloc/reset)."""
            X = np.eye(4, dtype=np.float64)
            s = hi_seq
            while s != lo_seq:
                rec = odom.get(s)
                if rec is None or rec[0] >= s:
                    return None
                X = np.linalg.inv(rec[1]) @ X
                s = rec[0]
                if s < lo_seq:
                    return None
            return X.astype(np.float32)

        # covisibility edges: near-temporal pairs only (a seam-spanning
        # edge measured from current estimates would freeze the drift),
        # measured by the odometry chain where it is complete
        covis_full = _host(_covis_full(state))
        seq_gap = np.abs(seq[:, None] - seq[None, :])
        eligible = (valid[None, :] & valid[:, None] & (covis_full > 15)
                    & (seq_gap > 1) & (seq_gap <= self.min_kf_gap))
        masked = np.where(eligible, covis_full, -1.0)
        kk = min(4, masked.shape[1] - 1)
        top = np.argpartition(-masked, kk, axis=1)[:, :kk]
        for k in order:
            for j in top[k]:
                if masked[k, j] > 0:
                    edges_i.append(int(k))
                    edges_j.append(int(j))
                    weights.append(1.0)
                    sk, sj = int(seq[k]), int(seq[j])
                    rel = (_odom_rel(sk, sj) if sk < sj
                           else _odom_rel(sj, sk))
                    if rel is not None:
                        m = rel if sk < sj else np.linalg.inv(rel)
                        meas.append(m.astype(np.float32))
                    else:
                        meas.append(poses_np[k] @ np.linalg.inv(poses_np[j]))
        # past accepted loop edges (KeyFrame::mspLoopEdges)
        slot_of_seq = {int(seq[s]): int(s) for s in order}
        for s_loop, s_cur, T_l in self._accepted_loops:
            a = slot_of_seq.get(s_loop)
            b = slot_of_seq.get(s_cur)
            if a is None or b is None:
                continue  # one endpoint was culled; the constraint is gone
            edges_i.append(a)
            edges_j.append(b)
            weights.append(10.0)
            meas.append(np.linalg.inv(T_l).astype(np.float32))
        # the loop edge: T_cur' = T_rel @ T_loop => T_loop inv(T_cur) = inv(T_rel)
        edges_i.append(int(loop_kf))
        edges_j.append(int(cur_kf))
        weights.append(10.0)
        meas.append(np.linalg.inv(_host(T_rel)).astype(np.float32))

        E = len(edges_i)
        fixed = torch.zeros(NK, dtype=torch.bool, device=dev)
        fixed[int(order[0])] = True   # the oldest alive keyframe: the gauge
        # odometry and covisibility edges are robust; the RANSAC-verified
        # weight-10 loop edges are exempt
        g = PoseGraph(
            poses=state.kf_pose, pose_valid=state.kf_valid,
            edge_i=torch.tensor(edges_i, device=dev),
            edge_j=torch.tensor(edges_j, device=dev),
            edge_T_ij=torch.from_numpy(np.stack(meas).astype(np.float32)
                                       ).to(dev),
            edge_valid=torch.ones(E, dtype=torch.bool, device=dev),
            edge_weight=torch.tensor(weights, dtype=torch.float32,
                                     device=dev),
            fixed=fixed,
            edge_robust=torch.tensor([wgt <= 1.0 for wgt in weights],
                                     device=dev))
        with stage_span("loop.pose_graph"):
            new_poses = optimize_pose_graph(g)
        with stage_span("loop.reanchor"):
            state = _reanchor_map(state, new_poses)

        # SearchAndFuse (LoopClosing.cc:633): the recent keyframes' points
        # merge into their older duplicates around the seam, at most K a
        # call
        with stage_span("loop.fuse"):
            K = state.kf_mp.shape[1]
            recent_slots = valid & (seq >= seq[cur_kf] - 5)
            seam_np = (_host(state.pt_valid)
                       & recent_slots[np.clip(_host(state.pt_first_kf), 0,
                                              None)])
            seam_idx = np.where(seam_np)[0]
            NP = seam_np.shape[0]
            for s in range(0, len(seam_idx), K):
                batch = np.zeros(NP, dtype=bool)
                batch[seam_idx[s:s + K]] = True
                state = map_ops.fuse_points_mask(
                    state, torch.from_numpy(batch).to(dev), fuse_dist=0.10)

        if self.run_gba and not self.gba_async:
            kf_pose, pt_pos, pl_coef, ln_ep = self._global_ba(state)
            state = state._replace(kf_pose=kf_pose, pt_pos=pt_pos,
                                   pl_coef=pl_coef, ln_ep=ln_ep)
        return state

    def _global_ba(self, state: MapState) -> tuple:
        """The global BA over the whole map: 4 Gauss-Newton steps of 30 CG
        iterations, the problem built in a `ba.problem` span."""
        with stage_span("ba.problem"):
            prob = problem_from_state(state)
        return bundle_adjust(prob, self.cfg.camera.K4, n_gn_iters=4,
                             n_cg_iters=30)

    # ------------------------------------------------------------------
    def dispatch_gba(self, state: MapState, guard_gen: int = 0) -> None:
        """Enqueue the post-correction global BA without waiting for it: on
        the GPU on a side stream behind the current one, with the state's
        tensors marked as used there, between two timing events
        (`gba_events`). Its host enqueue time is kept in
        `dispatch_seconds`."""
        if not (self.run_gba and self.gba_async):
            return
        t0 = time.perf_counter()
        stream = event = None
        if state.kf_pose.is_cuda:
            stream = torch.cuda.Stream(device=state.kf_pose.device)
            stream.wait_stream(torch.cuda.current_stream())
            for t in state:
                t.record_stream(stream)
            with torch.cuda.stream(stream):
                start = torch.cuda.Event(enable_timing=True)
                start.record(stream)
                out = self._global_ba(state)
                event = torch.cuda.Event(enable_timing=True)
                event.record(stream)
            self.gba_events = (start, event)
        else:
            out = self._global_ba(state)
        self.dispatch_seconds = time.perf_counter() - t0
        self._pending_gba = (out, state.kf_valid, state.kf_seq,
                             state.pt_valid, state.pl_valid, state.ln_valid,
                             guard_gen, event)

    def gba_ready(self) -> bool:
        """Whether a dispatched global BA has finished on the device."""
        event = self._pending_gba[-1] if self._pending_gba else None
        return event is None or event.query()

    def resolve_gba(self, state: MapState, guard_gen: int = 0,
                    block: bool = False) -> MapState | None:
        """Merge a finished global BA into the current state; None if
        nothing is pending, it has not finished (and `block` is False), or
        the map was destructively changed since dispatch.

        BA results apply only to slots that still hold the same entity as
        at dispatch: keyframes by (valid, insertion seq), landmarks by valid
        at both times and a bounded position change (the slot-table form of
        the reference's post-GBA re-anchoring, LoopClosing.cc:706-790)."""
        if self._pending_gba is None:
            return None
        (out, sv, ss, spt, spl, sln, gen, event) = self._pending_gba
        if gen != guard_gen:
            self._pending_gba = None   # reloc / reset / load since dispatch
            return None
        if not (block or self.gba_ready()):
            return None                # still computing; try at the next KF
        self._pending_gba = None
        if event is not None:
            cur = torch.cuda.current_stream()
            cur.wait_event(event)
            for t in out:
                t.record_stream(cur)
        kf_pose_ba, pt_ba, pl_ba, ln_ba = out
        same_kf = sv & state.kf_valid & (ss == state.kf_seq)
        kf_pose = torch.where(same_kf[:, None, None], kf_pose_ba,
                              state.kf_pose)
        same_pt = spt & state.pt_valid & (
            torch.linalg.norm(pt_ba - state.pt_pos, dim=-1) < 0.5)
        pt_pos = torch.where(same_pt[:, None], pt_ba, state.pt_pos)
        same_pl = spl & state.pl_valid & (
            torch.linalg.norm(pl_ba - state.pl_coef, dim=-1) < 0.5)
        pl_coef = torch.where(same_pl[:, None], pl_ba, state.pl_coef)
        same_ln = sln & state.ln_valid & (
            torch.linalg.norm(ln_ba - state.ln_ep, dim=-1) < 1.0)
        ln_ep = torch.where(same_ln[:, None], ln_ba, state.ln_ep)
        return state._replace(kf_pose=kf_pose, pt_pos=pt_pos,
                              pl_coef=pl_coef, ln_ep=ln_ep)


def _newest_observer(obs_tab, kp_ok, kf_valid, kf_seq, n_items: int,
                     fallback) -> torch.Tensor:
    """(n_items,) keyframe slot of each landmark's newest (highest insertion
    seq) observer, from an (NK, K) id table; `fallback` where a landmark has
    no live observer. A scatter-max of (seq * NK + slot) codes, unobserved
    entries into a dump slot."""
    NK, K = obs_tab.shape
    flat = obs_tab.reshape(-1).to(torch.int64)
    kfs = torch.arange(NK, device=flat.device).repeat_interleave(K)
    ok = (flat >= 0) & kp_ok.reshape(-1) & kf_valid[kfs]
    code = torch.where(ok, kf_seq[kfs].to(torch.int64) * NK + kfs, -1)
    best = torch.full((n_items + 1,), -1, dtype=torch.int64,
                      device=flat.device).scatter_reduce(
        0, torch.where(ok, flat, n_items), code, reduce="amax",
        include_self=True)[:n_items]
    return torch.where(best >= 0, best % NK, fallback.to(torch.int64))


def _reanchor_map(state: MapState, new_poses: torch.Tensor) -> MapState:
    """Move each landmark with its newest observing keyframe's correction,
    X' = inv(T_new_ref) @ T_old_ref @ X (CorrectLoop's landmark
    propagation, LoopClosing.cc:448+); planes and lines move the same way,
    and the keyframe poses become `new_poses`."""
    def corr_of(ref):
        """inv(T_new) @ T_old per landmark: world -> corrected world."""
        return se3.inv_T(new_poses[ref]) @ state.kf_pose[ref]

    def moved(A, X):
        return torch.einsum("nij,nj->ni", A[:, :3, :3], X) + A[:, :3, 3]

    pt_ref = _newest_observer(state.kf_mp, state.kf_kp_valid, state.kf_valid,
                              state.kf_seq, state.pt_pos.shape[0],
                              torch.clamp(state.pt_first_kf, min=0))
    pt_pos = torch.where(state.pt_valid[:, None],
                         moved(corr_of(pt_ref), state.pt_pos), state.pt_pos)

    # planes: X' = A X  =>  p' = inv(A)^T p; clouds move with A
    every_pl = torch.ones(state.kf_pl.shape, dtype=torch.bool,
                          device=state.kf_pl.device)
    pl_ref = _newest_observer(state.kf_pl, every_pl, state.kf_valid,
                              state.kf_seq, state.pl_coef.shape[0],
                              torch.clamp(state.pl_first_kf, min=0))
    A_pl = corr_of(pl_ref)
    p_new = torch.einsum("nji,nj->ni", se3.inv_T(A_pl), state.pl_coef)
    p_new = p_new / torch.clamp(torch.linalg.norm(p_new[:, :3], dim=-1,
                                                  keepdim=True), min=1e-9)
    p_new = p_new * torch.where(p_new[:, 3:4] < 0, -1.0, 1.0)
    pl_coef = torch.where(state.pl_valid[:, None], p_new, state.pl_coef)
    cloud_new = (torch.einsum("nij,nqj->nqi", A_pl[:, :3, :3], state.pl_cloud)
                 + A_pl[:, None, :3, 3])
    pl_cloud = torch.where(state.pl_valid[:, None, None], cloud_new,
                           state.pl_cloud)

    # lines: both endpoints and the direction move with the correction
    every_ln = torch.ones(state.kf_ln.shape, dtype=torch.bool,
                          device=state.kf_ln.device)
    ln_ref = _newest_observer(state.kf_ln, every_ln, state.kf_valid,
                              state.kf_seq, state.ln_ep.shape[0],
                              torch.clamp(state.ln_first_kf, min=0))
    A_ln = corr_of(ln_ref)
    ln_new = torch.cat([moved(A_ln, state.ln_ep[:, :3]),
                        moved(A_ln, state.ln_ep[:, 3:])], -1)
    ln_ep = torch.where(state.ln_valid[:, None], ln_new, state.ln_ep)
    dir_new = torch.einsum("nij,nj->ni", A_ln[:, :3, :3], state.ln_dir)
    ln_dir = torch.where(state.ln_valid[:, None], dir_new, state.ln_dir)
    return state._replace(pt_pos=pt_pos, pl_coef=pl_coef, pl_cloud=pl_cloud,
                          ln_ep=ln_ep, ln_dir=ln_dir, kf_pose=new_poses)
