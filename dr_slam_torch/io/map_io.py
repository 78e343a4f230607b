"""Map save/load: the `.npz` layout of the JAX package's `io/map_io.py`, both ways.

Descriptor fields are written as uint32, as the JAX package writes them, and
held as int32 tensors with the same bits. `from_jax_state` carries a JAX
`MapState` (given as a dict of numpy arrays) into the port: it is how the
port is given a map that the JAX package built."""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from dr_slam_torch import resolve_device
from dr_slam_torch.config import SlamConfig
from dr_slam_torch.slam.state import MapState, make_empty_state

_PACKED = ("pt_desc", "pt_desc_ring", "kf_desc", "ln_desc")


def _to_tensor(name: str, arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype == np.bool_:
        return torch.from_numpy(arr.copy()).to(dev)
    if name in _PACKED:
        return torch.from_numpy(
            np.ascontiguousarray(arr).astype(np.uint32).view(np.int32)).to(dev)
    if np.issubdtype(arr.dtype, np.integer):
        return torch.from_numpy(arr.astype(np.int32)).to(dev)
    return torch.from_numpy(arr.astype(np.float32)).to(dev)


def from_jax_state(fields: Mapping[str, np.ndarray], device=None) -> MapState:
    """A JAX `MapState` as numpy arrays (`state._asdict()` through
    `np.asarray`, or an opened `.npz`) -> the port's `MapState`."""
    dev = resolve_device(device)
    return MapState(**{k: _to_tensor(k, fields[k], dev)
                       for k in MapState._fields})


def save_map(path: str, state: MapState) -> None:
    out = {}
    for k, v in state._asdict().items():
        a = v.detach().cpu().numpy()
        out[k] = a.view(np.uint32) if k in _PACKED else a
    np.savez_compressed(path, **out)


def load_map(path: str, cfg: SlamConfig, device=None) -> MapState:
    """Read a map written by either package; shapes must match `cfg`."""
    dev = resolve_device(device)
    data = dict(np.load(path if path.endswith(".npz") else path + ".npz"))
    template = make_empty_state(cfg, device="cpu")
    fields = {}
    for k, tmpl in template._asdict().items():
        if k == "pt_desc_ring" and k not in data:
            # maps saved before the observation ring existed
            data[k] = np.broadcast_to(data["pt_desc"][:, None, :],
                                      tuple(tmpl.shape))
        elif k == "kf_word" and k not in data:
            # maps saved before the word-id cache existed
            from dr_slam_torch.associate.vocabulary import word_ids
            NK, K = tmpl.shape
            desc = _to_tensor("kf_desc", data["kf_desc"], torch.device("cpu"))
            data[k] = word_ids(desc.reshape(NK * K, 8),
                               cfg.map.vocab_words).reshape(NK, K).numpy()
        elif k in ("pt_dist_min", "pt_dist_max") and k not in data:
            data[k] = tmpl.numpy()
        if tuple(data[k].shape) != tuple(tmpl.shape):
            raise ValueError(
                f"map field {k}: saved shape {data[k].shape} != configured "
                f"{tuple(tmpl.shape)}; load with the same capacity config")
        fields[k] = data[k]
    return from_jax_state(fields, dev)
