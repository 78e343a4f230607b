"""Sharded bundle adjustment and the data-parallel front-end over a list of
devices.

Counterpart of the JAX package's `parallel/sharded_ba.py`. There, the
observation axis of the global BA is sharded over a device mesh, the
parameters are replicated, and XLA turns the J^T r and J^T J v reductions
into psums. Here a `Mesh` is a list of torch devices (one entry per shard;
a device may repeat, as JAX's virtual host devices do), each shard is a
BAProblem holding a slice of the observation rows and a copy of the
parameters, and `optimize.global_ba.bundle_adjust_shards` moves each
shard's J^T r and J^T J v to the first device and sums them there in shard
order. The observation tables dominate a map's memory and split; the
parameters and the conjugate-gradient state are replicated.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from dr_slam_torch.optimize.global_ba import (BAProblem, StructBlocks,
                                              bundle_adjust_shards)
from dr_slam_torch.utils.profiling import stage_span


@dataclass(frozen=True)
class Mesh:
    """A one-axis device mesh: `devices` in shard order, `shape[axis]` the
    number of shards."""
    devices: tuple
    axis_names: tuple
    shape: dict


def make_mesh(n_devices: int | None = None, axis: str = "obs",
              devices=None) -> Mesh:
    """The first n_devices of `devices` (default: every visible CUDA
    device) as a one-axis mesh. A list may repeat a device (["cpu"] * 8,
    ["cuda:0"] * 4): its shards then split the work on that one device.
    Raises when fewer devices than asked for are there."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. ['cpu'] * 8) to build a mesh on the CPU")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = [torch.device(d) for d in devices]
    n = n_devices or len(devs)
    if len(devs) < n:
        raise ValueError(
            f"make_mesh: requested {n} devices but only {len(devs)} are "
            f"available ({[str(d) for d in devs]}); a silently truncated "
            f"mesh would not exercise the multi-device paths")
    return Mesh(devices=tuple(devs[:n]), axis_names=(axis,),
                shape={axis: n})


def _row_slices(m: int, n: int) -> list:
    """n contiguous row ranges covering m rows, JAX's block layout (blocks
    of ceil(m / n) rows, the last ones shorter or empty)."""
    block = -(-m // n)
    return [slice(min(i * block, m), min((i + 1) * block, m))
            for i in range(n)]


def shard_problem(p: BAProblem, mesh: Mesh, axis: str = "obs") -> list:
    """One BAProblem per mesh device: the observation rows (`obs_*`,
    `pobs_*`, `lobs_*`) split into contiguous blocks over the mesh, the
    parameters and their free masks copied to every device."""
    n = mesh.shape[axis]
    obs = _row_slices(p.obs_kf.shape[0], n)
    s = p.struct
    if s is not None:
        pobs = _row_slices(s.pobs_kf.shape[0], n)
        lobs = _row_slices(s.lobs_kf.shape[0], n)
    shards = []
    for i, dev in enumerate(mesh.devices):
        o = obs[i]
        q = BAProblem(
            kf_pose=p.kf_pose.to(dev), pt_pos=p.pt_pos.to(dev),
            obs_kf=p.obs_kf[o].to(dev), obs_pt=p.obs_pt[o].to(dev),
            obs_uv=p.obs_uv[o].to(dev), obs_z=p.obs_z[o].to(dev),
            obs_inv_sigma2=p.obs_inv_sigma2[o].to(dev),
            obs_valid=p.obs_valid[o].to(dev),
            kf_free=p.kf_free.to(dev), pt_free=p.pt_free.to(dev))
        if s is not None:
            a, b = pobs[i], lobs[i]
            q = q._replace(struct=StructBlocks(
                pl_coef=s.pl_coef.to(dev), pl_free=s.pl_free.to(dev),
                pobs_kf=s.pobs_kf[a].to(dev), pobs_pl=s.pobs_pl[a].to(dev),
                pobs_coef=s.pobs_coef[a].to(dev),
                pobs_kind=s.pobs_kind[a].to(dev),
                pobs_valid=s.pobs_valid[a].to(dev),
                ln_ep=s.ln_ep.to(dev), ln_free=s.ln_free.to(dev),
                lobs_kf=s.lobs_kf[b].to(dev), lobs_ln=s.lobs_ln[b].to(dev),
                lobs_line=s.lobs_line[b].to(dev),
                lobs_ep3=s.lobs_ep3[b].to(dev),
                lobs_valid=s.lobs_valid[b].to(dev)))
        shards.append(q)
    return shards


def sharded_bundle_adjust(p: BAProblem, K4, mesh: Mesh, axis: str = "obs",
                          **kw):
    """bundle_adjust with the observations sharded over the mesh; the same
    tuple as `bundle_adjust`, on mesh.devices[0]. Structural (plane/line)
    observation tables shard over the same axis."""
    with stage_span("ba.problem"):
        shards = shard_problem(p, mesh, axis)
    return bundle_adjust_shards(shards, K4, **kw)


def batched_frontend(imgs, mesh: Mesh, axis: str = "data", **orb_kw):
    """ORB on an (N, H, W) frame batch split over the mesh devices in
    contiguous blocks; -> (uv, desc, valid), each with a leading N axis, on
    mesh.devices[0]."""
    from dr_slam_torch.ops.orb import extract_orb

    imgs = torch.as_tensor(imgs)
    outs = []
    for dev, rows in zip(mesh.devices,
                         _row_slices(imgs.shape[0], mesh.shape[axis])):
        for img in imgs[rows].to(dev, torch.float32):
            kp = extract_orb(img, **orb_kw)
            outs.append((kp.uv, kp.desc, kp.valid))
    home = mesh.devices[0]
    return tuple(torch.stack([o[j].to(home) for o in outs]) for j in range(3))
