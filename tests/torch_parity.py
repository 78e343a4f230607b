"""Helpers shared by the parity tests of the PyTorch port against the JAX
package: the small configurations of tests/test_tracking_e2e.py and
tests/test_loop_closure.py in both packages, the carriers of frame features,
map states and device-loop carries from JAX into the port, and the wait
that makes the JAX tracker's deferred decision lag by exactly one frame."""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch

from dr_slam_tpu.config import (CameraConfig, LineConfig, MapConfig, ORBConfig,
                                SlamConfig)
from dr_slam_torch import config as tconfig
from dr_slam_torch.frontend.frame import FrameFeatures
from dr_slam_torch.io.map_io import from_jax_state
from dr_slam_torch.ops.lines import LineFeatures
from dr_slam_torch.ops.orb import Keypoints
from dr_slam_torch.ops.planes import PlaneSegmentation


def small_cfg(deferred: bool = True) -> SlamConfig:
    """tests/test_tracking_e2e.py's configuration (320x240, 512 keypoints,
    4096 map points, 32 keyframes, 512 vocabulary words)."""
    cfg = SlamConfig(
        camera=CameraConfig(fx=267.7, fy=269.6, cx=160.0, cy=120.0,
                            width=320, height=240, bf=20.0),
        orb=ORBConfig(n_features=400, n_levels=4, max_keypoints=512),
        line=LineConfig(max_lines=32),
        map=MapConfig(max_points=4096, max_lines=512, max_planes=32,
                      max_keyframes=32, vocab_words=512))
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, deferred_readback=deferred))


def loop_cfg() -> SlamConfig:
    """tests/test_loop_closure.py's configuration: small_cfg with keyframe
    culling off, 15 / 6 px match windows and a loop consistency of 1 (the
    port's is dr_slam_torch._smoke.loop_small_cfg)."""
    cfg = small_cfg()
    return cfg.replace(tracking=dataclasses.replace(
        cfg.tracking, run_kf_culling=False, motion_search_radius=15.0,
        local_search_radius=6.0, loop_consistency=1))


def wait_pending(system) -> None:
    """Wait for every pending deferred frame of a JAX System's tracker, so
    its next frame resolves them: the decision lags by exactly one frame,
    as the port's does on the CPU."""
    import jax
    for entry in system.tracker._pending:
        jax.block_until_ready(entry[2].bundle)


@contextlib.contextmanager
def shipped_codebooks():
    """Register the shipped codebooks (vocab512.npz, vocab.npz) in both
    packages for the block, as their `System`s do, then restore both
    registries. Unregistered, both packages fall back to the same seeded
    random codebook; the fixtures and the JAX `System` runs these tests
    compare with use the shipped ones, and a bare tracker or
    `DeviceLoopTracker` registers none. Both packages' codebook caches are
    cleared on the way in and on the way out, and so are JAX's jit caches:
    a jitted program bakes the codebook in when it is traced."""
    import jax
    from dr_slam_tpu.associate import vocabulary as jvoc
    from dr_slam_torch._smoke import shipped_codebooks as port_codebooks

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    saved = dict(jvoc._trained_signs)

    def clear():
        jvoc._codebook_signs.cache_clear()
        jax.clear_caches()

    clear()
    for name in ("vocab512.npz", "vocab.npz"):
        with np.load(os.path.join(root, "dr_slam_tpu", "data", name)) as data:
            jvoc.set_vocabulary(data["words"])
    try:
        with port_codebooks():
            yield
    finally:
        jvoc._trained_signs.clear()
        jvoc._trained_signs.update(saved)
        clear()


def to_port(cfg: SlamConfig) -> tconfig.SlamConfig:
    fields = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        fields[f.name] = (getattr(tconfig, type(v).__name__)(**dataclasses.asdict(v))
                          if dataclasses.is_dataclass(v) else v)
    return tconfig.SlamConfig(**fields)


def tensor(x) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor; uint32 bits become int32."""
    a = np.array(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def feats_to_port(f) -> FrameFeatures:
    """JAX FrameFeatures -> the port's, on the CPU, bit for bit."""
    def conv(cls, nt):
        return cls(**{k: tensor(v) for k, v in nt._asdict().items()})
    return FrameFeatures(
        kp=conv(Keypoints, f.kp), kp_depth=tensor(f.kp_depth),
        kp_ur=tensor(f.kp_ur), kp_xyz=tensor(f.kp_xyz),
        normals=tensor(f.normals), normals_valid=tensor(f.normals_valid),
        planes=conv(PlaneSegmentation, f.planes),
        lines=conv(LineFeatures, f.lines))


def state_to_port(st):
    return from_jax_state({k: np.asarray(v) for k, v in st._asdict().items()},
                          "cpu")


CARRY_SCALARS = ("T_cw", "velocity", "R_cm", "ref_kf", "lost", "frame_id",
                 "last_kf_frame", "last_kf_inliers")


def carry_arrays(carry, prefix: str = "") -> dict:
    """A JAX `LoopCarry` as numpy arrays: "<prefix>map__<field>" for the
    map state, "<prefix><field>" for the rest (the fixtures' layout)."""
    out = {f"{prefix}map__{k}": np.asarray(v)
           for k, v in carry.map_state._asdict().items()}
    out.update({f"{prefix}{k}": np.asarray(getattr(carry, k))
                for k in CARRY_SCALARS})
    return out


def carry_to_port(carry, prefix: str = "", device="cpu"):
    """A JAX `LoopCarry`, or its arrays as `carry_arrays` lays them out (a
    fixture's), -> the port's `LoopCarry` on `device`, bit for bit; the
    reference keyframe slot becomes int64."""
    from dr_slam_torch.slam.device_loop import LoopCarry

    arrays = carry if isinstance(carry, dict) else carry_arrays(carry)
    dev = torch.device(device)
    m = f"{prefix}map__"
    st = from_jax_state({k[len(m):]: v for k, v in arrays.items()
                         if k.startswith(m)}, dev)
    dtypes = {"ref_kf": torch.int64, "lost": torch.bool}

    def scalar(k):
        x = torch.from_numpy(np.array(arrays[prefix + k]))
        return x.to(dtypes.get(k, x.dtype)).to(dev)
    return LoopCarry(map_state=st, **{k: scalar(k) for k in CARRY_SCALARS})


def assert_states_match(jst, tst, atol: float, fields=None) -> None:
    """Integer and bool fields exactly equal, float fields within atol."""
    for f in fields or jst._fields:
        a = np.asarray(getattr(jst, f))
        b = getattr(tst, f).numpy()
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(b, a, err_msg=f)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=f)


@contextlib.contextmanager
def jax_system_lagged_by_one():
    """Patch the JAX `System.track_rgbd` for the block: after each frame it
    waits for the pending frames' bundles (`wait_pending`), so the deferred
    decision lags by exactly one frame as the port's does on the CPU, and it
    records (result, reference keyframe, system) in the list it yields."""
    from dr_slam_tpu.slam.system import System

    calls = []
    track = System.track_rgbd

    def wrapped(self, *a, **kw):
        res = track(self, *a, **kw)
        wait_pending(self)
        calls.append((res, self.tracker.ref_kf, self))
        return res
    System.track_rgbd = wrapped
    try:
        yield calls
    finally:
        System.track_rgbd = track


def load_script(name: str):
    """scripts/<name>.py as a module."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def write_small_yaml(path) -> str:
    """small_cfg() as a reference-style YAML file, for the run scripts'
    --config (both packages' `load_config` read it back as small_cfg())."""
    cfg = small_cfg()
    cam = cfg.camera
    keys = {"Camera.fx": cam.fx, "Camera.fy": cam.fy, "Camera.cx": cam.cx,
            "Camera.cy": cam.cy, "Camera.width": cam.width,
            "Camera.height": cam.height, "Camera.bf": cam.bf,
            "DepthMapFactor": cam.depth_factor,
            "ORBextractor.nFeatures": cfg.orb.n_features,
            "ORBextractor.nLevels": cfg.orb.n_levels,
            "ORBextractor.maxKeypoints": cfg.orb.max_keypoints,
            "Line.MaxLines": cfg.line.max_lines,
            "Map.MaxPoints": cfg.map.max_points,
            "Map.MaxLines": cfg.map.max_lines,
            "Map.MaxPlanes": cfg.map.max_planes,
            "Map.MaxKeyFrames": cfg.map.max_keyframes,
            "Map.VocabWords": cfg.map.vocab_words}
    with open(path, "w") as f:
        f.write("%YAML:1.0\n" + "".join(f"{k}: {v}\n" for k, v in keys.items()))
    return str(path)
