"""Multi-sequence tracking: N independent sequences advanced together, one
step each per call.

Counterpart of the JAX package's `parallel/multi_seq.py`, which places one
sequence on each device of a mesh under `shard_map` (no collectives, every
`lax.cond` branch dynamic per device). The port advances each sequence
through `device_track_step` in turn, each on its own device (a mesh's) or
all on one: the same per-sequence code as a `DeviceLoopTracker`, so
sequence s's records equal a single tracker's on the same frames (bit for
bit on the CPU; on the GPU up to the atomics of scatter-adds). Each
sequence keeps its own carry on its device; `carries` stacks them with a
leading sequence axis, as the reference keeps them."""

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


def _to(tree, device):
    """A carry (nested NamedTuples of tensors) on `device`."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*[_to(x, device) for x in tree])


def stack_carries(cfg: SlamConfig, n: int, map_states=None,
                  device=None) -> LoopCarry:
    """A LoopCarry with a leading sequence axis of size n."""
    return _stack([init_carry(cfg, None if map_states is None
                              else map_states[i], device=device)
                   for i in range(n)])


class MultiSequenceTracker:
    """`MultiSequenceTracker(cfg, n_seq, device=...)`: DeviceLoopTracker
    semantics over n_seq sequences on one device; `device` defaults to cuda
    and raises without a GPU unless "cpu" is passed.
    `MultiSequenceTracker(cfg, mesh=mesh, axis="seq")`: one sequence per
    mesh device (`parallel.sharded_ba.make_mesh`), sequence s on
    mesh.devices[s], as the reference places one per device.

    `track()` takes stacked frames (n_seq, H, W) and timestamps (n_seq,)
    and steps every sequence; `flush()` gathers the records on the first
    device, reads everything back once and returns the per-sequence dicts
    `DeviceLoopTracker.flush()` would."""

    def __init__(self, cfg: SlamConfig, n_seq: int | None = None,
                 device=None, map_states=None,
                 localization_only: bool = False, mesh=None,
                 axis: str = "seq"):
        self.cfg = cfg
        if mesh is not None:
            self.devices = list(mesh.devices[:mesh.shape[axis]])
        else:
            self.devices = [resolve_device(device)] * int(n_seq)
        self.n = len(self.devices)
        self.device = self.devices[0]
        self.localization_only = bool(localization_only)
        self._carries = [init_carry(cfg, None if map_states is None
                                    else map_states[s], device=d)
                         for s, d in enumerate(self.devices)]
        self._initialized = [None if map_states is not None else False
                             for _ in range(self.n)]
        self._records: list = []      # (n, REC_SIZE) device tensors
        self._ts: list = []           # (n,) float64 per step
        self.readbacks: list = []     # per step, per sequence

    @property
    def carries(self) -> LoopCarry:
        """The sequences' carries stacked on the first device."""
        return _stack([_to(c, self.device) for c in self._carries])

    def track(self, grays, depths, timestamps) -> torch.Tensor:
        ts = np.asarray(timestamps, np.float64)
        recs, reads = [], []
        for s, dev in enumerate(self.devices):
            g, d = ingest(grays[s], depths[s], self.cfg.camera, dev)
            c, rec, info = device_track_step(
                self._carries[s], g, d, float(ts[s]), self.cfg,
                self.localization_only, self._initialized[s])
            self._carries[s] = c
            self._initialized[s] = info.initialized
            recs.append(rec.to(self.device))
            reads.append(info.readbacks)
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
        n_kfs = torch.stack([torch.sum(c.map_state.kf_valid).to(self.device)
                             for c in self._carries]).tolist()
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
