"""Multi-sequence tracking: N independent sequences advanced together, one
step each per call.

Counterpart of the JAX package's `parallel/multi_seq.py`, which places one
sequence on each device of a mesh under `shard_map` (no collectives, every
`lax.cond` branch dynamic per device). On one GPU the port advances each
sequence through `device_track_step` in turn, on one stream: the same
per-sequence code as a `DeviceLoopTracker`, so sequence s's records equal a
single tracker's on the same frames (bit for bit on the CPU; on the GPU up
to the atomics of scatter-adds). The frames of all sequences go to the
device in one copy per step; the carries are kept stacked, with a leading
sequence axis, as the reference keeps them."""

from __future__ import annotations

import numpy as np
import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.frontend.frame import ingest
from dr_slam_torch.slam.device_loop import (REC_SIZE, STATE_NAMES, LoopCarry,
                                            device_track_step, init_carry)


def _stack(trees: list):
    """NamedTuples of tensors (nested) -> one with a leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*[_stack(list(xs)) for xs in zip(*trees)])


def _index(tree, s: int):
    """Sequence `s` of a stacked carry (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[s]
    return type(tree)(*[_index(x, s) for x in tree])


def stack_carries(cfg: SlamConfig, n: int, map_states=None,
                  device=None) -> LoopCarry:
    """A LoopCarry with a leading sequence axis of size n."""
    return _stack([init_carry(cfg, None if map_states is None
                              else map_states[i], device=device)
                   for i in range(n)])


class MultiSequenceTracker:
    """`MultiSequenceTracker(cfg, n_seq, device=...)`: DeviceLoopTracker
    semantics over n_seq sequences; `device` defaults to cuda and raises
    without a GPU unless "cpu" is passed.

    `track()` takes stacked frames (n_seq, H, W) and timestamps (n_seq,)
    and steps every sequence; `flush()` reads everything back once and
    returns the per-sequence dicts `DeviceLoopTracker.flush()` would."""

    def __init__(self, cfg: SlamConfig, n_seq: int, device=None,
                 map_states=None, localization_only: bool = False):
        self.cfg = cfg
        self.n = int(n_seq)
        self.device = resolve_device(device)
        self.localization_only = bool(localization_only)
        self.carries = stack_carries(cfg, self.n, map_states, self.device)
        self._initialized = [None if map_states is not None else False
                             for _ in range(self.n)]
        self._records: list = []      # (n, REC_SIZE) device tensors
        self._ts: list = []           # (n,) float64 per step
        self.readbacks: list = []     # per step, per sequence

    def track(self, grays, depths, timestamps) -> torch.Tensor:
        g, d = ingest(grays, depths, self.cfg.camera, self.device)
        ts = np.asarray(timestamps, np.float64)
        carries, recs, reads = [], [], []
        for s in range(self.n):
            c, rec, info = device_track_step(
                _index(self.carries, s), g[s], d[s], float(ts[s]), self.cfg,
                self.localization_only, self._initialized[s])
            self._initialized[s] = info.initialized
            carries.append(c)
            recs.append(rec)
            reads.append(info.readbacks)
        self.carries = _stack(carries)
        rec = torch.stack(recs)
        self._records.append(rec)
        self._ts.append(ts)
        self.readbacks.append(reads)
        return rec

    def flush(self) -> list:
        """One readback; [dict per sequence] with records / trajectory /
        states / n_keyframes (DeviceLoopTracker.flush's layout)."""
        if not self._records:
            return [{"records": np.zeros((0, REC_SIZE), np.float32),
                     "trajectory": [], "states": [], "n_keyframes": 0}
                    for _ in range(self.n)]
        recs = torch.stack(self._records).cpu().numpy()       # (T, n, REC)
        ts = np.stack(self._ts)                                # (T, n)
        n_kfs = torch.sum(self.carries.map_state.kf_valid, 1).tolist()
        out = []
        for s in range(self.n):
            r = recs[:, s]
            out.append({
                "records": r,
                "trajectory": [(ts[t, s],
                                r[t, :16].reshape(4, 4).astype(np.float64))
                               for t in range(r.shape[0])],
                "states": [STATE_NAMES.get(float(x[16]), "OK") for x in r],
                "n_keyframes": int(n_kfs[s]),
            })
        return out
