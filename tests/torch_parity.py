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
from dr_slam_torch import _smoke
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


TRACKER_HOST = ("last_kf_frame", "ref_kf", "frame_id", "only_tracking",
                "_seq_counter", "_last_inliers", "_last_matches",
                "_last_man_ok", "_reloc_failures", "_n_kfs_host", "_map_gen",
                "_hard_gen")


def out_to_port(out):
    """A JAX `TrackStepOut` -> the port's, on the CPU, bit for bit."""
    from dr_slam_torch.slam.track_step import TrackStepOut

    return TrackStepOut(**{k: state_to_port(v) if k == "new_map_state"
                           else tensor(v) for k, v in out._asdict().items()})


def tracker_to_port(jt, pt) -> None:
    """Seat a JAX `Tracker`'s state in the port's `Tracker` `pt` between two
    frames: the map, the pose, velocity and Manhattan rotation, the host
    bookkeeping, and each pending deferred frame (its features, its track
    step's outputs and the poses to roll back to), so that `pt`'s next
    frame resolves what the JAX tracker's next frame would."""
    from dr_slam_torch.slam.tracking import TrackState, _HostBundle

    pt.map_state = state_to_port(jt.map_state)
    pt.T_cw, pt.velocity, pt.R_cm = (tensor(x) for x in
                                     (jt.T_cw, jt.velocity, jt.R_cm))
    pt.state = TrackState[jt.state.name]
    for k in TRACKER_HOST:
        setattr(pt, k, getattr(jt, k))
    for k in ("kf_pose_host", "kf_seq_host", "kf_odom_host"):
        setattr(pt, k, dict(getattr(jt, k)))
    pt.trajectory = [(ts, np.asarray(T)) for ts, T in jt.trajectory]
    pt.kf_log = list(jt.kf_log)
    pt._ref_kf_cache = None
    pt._pending.clear()
    for (ts, feats, out, T_prev, R_prev, fid, loc, gen, hard) in jt._pending:
        o = out_to_port(out)
        pt._pending.append((ts, feats_to_port(feats), o, _HostBundle(o.bundle),
                            tensor(T_prev), tensor(R_prev), fid, loc, gen,
                            hard))


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


@contextlib.contextmanager
def projected_tracked_pose():
    """Patch the JAX track_step for the block: the pose of its second
    (structural) pose solve gets its rotation projected onto SO(3) with
    `se3.orthonormalize_rotation`, so the pose, the velocity, the Manhattan
    rotation and the bundle that follow from it are the projected pose's,
    as in the port's `slam/track_step.py`. Patch before the first trace."""
    from dr_slam_tpu.geometry import se3
    from dr_slam_tpu.slam import track_step as ts

    solve = ts.pose_optimize

    def projected(*a, struct_on=False, **kw):
        out = solve(*a, struct_on=struct_on, **kw)
        if not struct_on:
            return out
        T = out.T_cw
        return out._replace(T_cw=se3.make_T(
            se3.orthonormalize_rotation(T[:3, :3]), T[:3, 3]))

    ts.pose_optimize = projected
    try:
        yield
    finally:
        ts.pose_optimize = solve


def jax_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2):
    """The JAX package's jitted `build_pyramid` with the port's signature
    (CPU tensors in and out): swapped for the port's
    `dr_slam_torch.ops.image.build_pyramid`, the witness that a gap is not
    the pyramid's (the port's pyramid is JAX's bit for bit on the CPU,
    tests/test_torch_resize.py)."""
    import jax.numpy as jnp
    from dr_slam_tpu.ops import image as jimage

    levels = jimage.build_pyramid(jnp.asarray(img.numpy()),
                                  n_levels=n_levels, scale=scale)
    return tuple(torch.from_numpy(np.array(x)) for x in levels)


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


def jax_wall_sequence(cfg, n: int):
    """`_smoke.wall_sequence` rendered by the JAX package."""
    from dr_slam_tpu.io import synthetic

    cam = cfg.camera
    return synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(n, step=0.02), K4=cam.K4,
        height=cam.height, width=cam.width)


def jax_office_sequence():
    """The office world of tests/test_transfer_validation.py rendered by
    the JAX package: the box room with wall-seated clutter, the corridor
    path at 1.5 cm per frame and Kinect-like quadratic depth noise."""
    from dr_slam_tpu.io import synthetic

    cam = _smoke.office_cfg(small_cfg()).camera
    room = synthetic.BoxRoom()
    return synthetic.SyntheticSequence(
        synthetic.corridor_trajectory(_smoke.OFFICE_FRAMES, room=room,
                                      step=0.015),
        K4=cam.K4, height=cam.height, width=cam.width, room=room,
        boxes=synthetic.office_clutter(room), depth_noise=True,
        quadratic_noise=True)


def numpy_frames(seq, n: int) -> list:
    """Frames 0..n-1 of a JAX sequence as float32 numpy (gray, depth)."""
    return [tuple(np.asarray(x, np.float32) for x in seq.render(i))
            for i in range(n)]


WALL_STAGES = ("add_keyframe", "cull_map", "triangulate_with_kf",
               "fuse_new_points", "map_ba", "cull_one_keyframe")


def _snap(x):
    """A JAX array or pytree of them as numpy (a copy: the JAX map
    operations donate their inputs); anything else as it is."""
    import jax

    if isinstance(x, tuple) or hasattr(x, "shape"):
        return jax.tree_util.tree_map(np.array, x)
    return x


@contextlib.contextmanager
def recorded_jax_passes(calls: set, counter: list):
    """Record every stage of the JAX `Tracker`'s keyframe pass (the
    `WALL_STAGES`: its map operations and `Tracker._map_ba`) while
    `counter[0]`, the caller's call index, is in `calls`: a list of (call,
    stage, args, kwargs, output), all as numpy (`_snap`)."""
    from dr_slam_tpu.slam import map_ops as jm
    from dr_slam_tpu.slam.tracking import Tracker

    log, saved = [], {n: getattr(jm, n) for n in WALL_STAGES if n != "map_ba"}
    map_ba = Tracker._map_ba

    def wrap(name, fn):
        def recorded(*a, **kw):
            if counter[0] not in calls:
                return fn(*a, **kw)
            args = [_snap(x) for x in a]
            kws = {k: _snap(v) for k, v in kw.items()}
            out = fn(*a, **kw)
            log.append((counter[0], name, args, kws,
                        _snap(out[0] if name == "add_keyframe" else out)))
            return out
        return recorded

    def recorded_ba(self, center_kf=None):
        if counter[0] not in calls:
            return map_ba(self, center_kf=center_kf)
        before = _snap(self.map_state)
        map_ba(self, center_kf=center_kf)
        log.append((counter[0], "map_ba", [before],
                    {"center_kf": _snap(center_kf)}, _snap(self.map_state)))

    for n, fn in saved.items():
        setattr(jm, n, wrap(n, fn))
    Tracker._map_ba = recorded_ba
    try:
        yield log
    finally:
        for n, fn in saved.items():
            setattr(jm, n, fn)
        Tracker._map_ba = map_ba


def port_stage(name: str, args: list, kw: dict, tcfg):
    """The port's counterpart of a stage `recorded_jax_passes` recorded, on
    the recorded (JAX) inputs. -> the map state it returns."""
    from dr_slam_torch.slam import map_ops as tm
    from dr_slam_torch.slam.tracking import map_ba

    st = state_to_port(args[0])

    def slot(x):
        return torch.as_tensor(np.asarray(x)).long()

    if name == "add_keyframe":
        _, feats, T, ts, mp, pm, lm, bow = args[:8]
        blocked = kw.get("blocked")
        return tm.add_keyframe(
            st, feats_to_port(feats), tensor(T), ts, tensor(mp),
            tm.PlaneMatches(*(tensor(x) for x in pm)), tensor(lm),
            tensor(bow), tcfg,
            blocked=None if blocked is None else tensor(blocked))[0]
    if name == "triangulate_with_kf":
        return tm.triangulate_with_kf(st, slot(args[1]), slot(args[2]),
                                      args[3], **kw)
    if name == "fuse_new_points":
        return tm.fuse_new_points(st, slot(args[1]), **kw)
    if name == "map_ba":
        return map_ba(st, tcfg, center_kf=slot(kw["center_kf"]))
    return getattr(tm, name)(st, **kw)


def run_both_systems(cfg, frames, before=None, flush_last: bool = False):
    """The JAX `System` (lagged by one frame, rotations projected onto
    SO(3)) and the port's, on the CPU, over the same numpy frames, each call
    recorded by `_smoke.BehaviourRecorder`. `before(i, jax_system,
    port_system)` runs before call i; with `flush_last` the last call is
    flushed. Capping torch's threads is the caller's. -> (jax arrays, port
    arrays, jax System, port System)."""
    from dr_slam_torch.slam.system import System as TSystem
    from dr_slam_tpu.slam.system import System

    with projected_tracked_pose(), jax_system_lagged_by_one():
        systems = (System(cfg, enable_loop_closing=False),
                   TSystem(to_port(cfg), enable_loop_closing=False,
                           device="cpu"))
        recs = [_smoke.BehaviourRecorder(s) for s in systems]
        for i, (g, d) in enumerate(frames):
            if before is not None:
                before(i, *systems)
            for r in recs:
                r.track(g, d, i / 30.0, flush=flush_last
                        and i == len(frames) - 1)
    return (*(r.arrays() for r in recs), *systems)


class JaxRenders:
    """The protocol's sequence (`_smoke.accuracy_sequence`) with JAX's
    renders of its poses."""

    def __init__(self, device, port_sequence=_smoke.accuracy_sequence):
        from dr_slam_tpu.io.synthetic import SyntheticSequence

        port = port_sequence(device)
        self.poses_cw, self.device = port.poses_cw, port.device
        self.port = port
        self.jax = SyntheticSequence(self.poses_cw, K4=port.K4,
                                     height=port.height, width=port.width)

    def __len__(self):
        return len(self.poses_cw)

    def render(self, i):
        return tuple(torch.from_numpy(np.array(x, np.float32))
                     for x in self.jax.render(i))
