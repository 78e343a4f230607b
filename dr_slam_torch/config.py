"""Configuration: typed, immutable dataclasses that accept the reference
YAML key names (Examples/RGB-D/TUM3.yaml: Camera.*, ORBextractor.*,
Plane.*), plus the fixed capacities the device tables are built with.

This is the port's own copy of the configuration the JAX package uses, cut
to what the per-frame tracking path reads; the field names, defaults and
presets are the same, so one config describes a run of either package."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 535.4
    fy: float = 539.2
    cx: float = 320.1
    cy: float = 247.6
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    bf: float = 40.0          # baseline * fx (reference Camera.bf)
    depth_factor: float = 5000.0  # DepthMapFactor (TUM 16U -> meters)
    th_depth: float = 40.0    # ThDepth: close/far point threshold in b units
    rgb: int = 1

    @property
    def K4(self):
        return (self.fx, self.fy, self.cx, self.cy)

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def th_depth_m(self) -> float:
        """Close/far depth threshold in meters (mThDepth = mbf*ThDepth/fx,
        Tracking.cc:155)."""
        return self.bf * self.th_depth / self.fx


@dataclasses.dataclass(frozen=True)
class ORBConfig:
    n_features: int = 1000       # ORBextractor.nFeatures (TUM3.yaml:40)
    scale_factor: float = 1.2    # ORBextractor.scaleFactor
    n_levels: int = 8            # ORBextractor.nLevels
    ini_th_fast: int = 20        # ORBextractor.iniThFAST
    min_th_fast: int = 7         # ORBextractor.minThFAST
    max_keypoints: int = 1024    # fixed keypoint capacity (>= n_features)
    cell_size: int = 16          # grid cell for spatially-uniform selection
    patch_size: int = 31
    half_patch: int = 15


@dataclasses.dataclass(frozen=True)
class LineConfig:
    max_lines: int = 64
    keep_top: int = 40
    min_length: float = 25.0     # pixels
    grad_threshold: float = 20.0
    n_samples: int = 32          # depth samples along segment for 3D fit
    ransac_iters: int = 64


@dataclasses.dataclass(frozen=True)
class PlaneConfig:
    association_ang_ref: float = 0.985     # cos 10deg  Plane.AssociationAngRef
    association_dis_ref: float = 0.05      # meters     Plane.AssociationDisRef
    vertical_threshold: float = 0.0871     # cos 85deg  Plane.VerticalThreshold
    parallel_threshold: float = 0.9962     # cos 5deg   Plane.ParallelThreshold
    angle_info: float = 0.5                # Plane.AngleInfo
    distance_info: float = 50.0            # Plane.DistanceInfo
    chi2: float = 100.0                    # Plane.Chi2
    vp_chi2: float = 50.0                  # Plane.VPChi2 (par/ver edges)
    max_point_dist: float = 0.1            # MaxPointDistanceFromPlane gate
    block: int = 8                 # pixels per tile side
    max_planes: int = 8            # planes kept per frame
    min_blocks: int = 10           # min member tiles
    merge_angle_cos: float = 0.985
    merge_dist: float = 0.05
    mse_factor: float = 2.5e-3     # planarity MSE gate: (factor * z^2)^2
    max_depth: float = 5.0
    cloud_points: int = 256        # stored per-plane sample cloud size
    detect_cylinders: bool = False
    max_cylinders: int = 3


@dataclasses.dataclass(frozen=True)
class ManhattanConfig:
    cone_angle_normals: float = 0.2018   # rad (Tracking.cc:1234)
    cone_angle_lines: float = 0.1018     # rad (Tracking.cc:1260)
    mean_shift_kernel: float = 20.0      # exp(-20 ||x||^2) (Tracking.cc:1529)
    min_sn_ratio: float = 0.05           # minNumOfSN = |normals|/20
    n_iterations: int = 3                # fixed-point calls per frame
    converge_tol: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MapConfig:
    max_points: int = 32768
    max_lines: int = 4096
    max_planes: int = 128
    max_keyframes: int = 512
    max_kf_planes: int = 16    # plane observations per keyframe
    vocab_words: int = 4096    # BoW vocabulary size
    desc_ring: int = 4         # stored descriptors per map point


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    min_frames: int = 10
    max_frames: int = 30
    kf_ref_ratio: float = 0.75
    kf_collapse_ratio: float = 0.25
    kf_close_tracked_max: int = 100
    kf_close_untracked_min: int = 70
    kf_min_inliers: int = 15
    init_min_depth_points: int = 200
    motion_search_radius: float = 28.0
    local_search_radius: float = 8.0    # stage-2 rematch window
    reloc_search_radius: float = 10.0
    # Candidate compaction in match_points_projection: gather in-frustum
    # point rows into a buffer this size before the matcher. <= 0 scans the
    # whole point table.
    match_candidates: int = 0
    # Kept so configs written for the JAX package load unchanged; the port's
    # matcher is chosen by the tensors' device, not by this field.
    pallas_matcher: object = "auto"
    use_lines_in_pose: bool = True
    use_planes_in_pose: bool = True
    translation_only_with_manhattan: bool = False
    use_ref_kf_anchor: bool = True
    run_ba_on_keyframe: bool = True
    run_cull_on_keyframe: bool = True
    run_fuse_on_keyframe: bool = True
    run_triangulation: bool = True
    run_kf_culling: bool = True
    fuse_dist: float = 0.05
    use_local_ba: bool = True
    local_ba_window: int = 8
    use_struct_in_ba: bool = True
    deferred_readback: bool = True
    loop_consistency: int = 2


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    use_viewer: bool = False
    keyframe_size: float = 0.05
    point_size: float = 2.0
    camera_size: float = 0.08


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: ORBConfig = dataclasses.field(default_factory=ORBConfig)
    line: LineConfig = dataclasses.field(default_factory=LineConfig)
    plane: PlaneConfig = dataclasses.field(default_factory=PlaneConfig)
    manhattan: ManhattanConfig = dataclasses.field(default_factory=ManhattanConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    viewer: ViewerConfig = dataclasses.field(default_factory=ViewerConfig)
    save_path: str = "./output"

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


# Reference YAML keys (Examples/RGB-D/*.yaml) -> config fields.
_YAML_MAP: Mapping[str, tuple] = {
    "Camera.fx": ("camera", "fx", float),
    "Camera.fy": ("camera", "fy", float),
    "Camera.cx": ("camera", "cx", float),
    "Camera.cy": ("camera", "cy", float),
    "Camera.k1": ("camera", "k1", float),
    "Camera.k2": ("camera", "k2", float),
    "Camera.p1": ("camera", "p1", float),
    "Camera.p2": ("camera", "p2", float),
    "Camera.k3": ("camera", "k3", float),
    "Camera.width": ("camera", "width", int),
    "Camera.height": ("camera", "height", int),
    "Camera.fps": ("camera", "fps", float),
    "Camera.bf": ("camera", "bf", float),
    "Camera.RGB": ("camera", "rgb", int),
    "ThDepth": ("camera", "th_depth", float),
    "DepthMapFactor": ("camera", "depth_factor", float),
    "ORBextractor.nFeatures": ("orb", "n_features", int),
    "ORBextractor.scaleFactor": ("orb", "scale_factor", float),
    "ORBextractor.nLevels": ("orb", "n_levels", int),
    "ORBextractor.iniThFAST": ("orb", "ini_th_fast", int),
    "ORBextractor.minThFAST": ("orb", "min_th_fast", int),
    "Plane.AssociationAngRef": ("plane", "association_ang_ref", float),
    "Plane.AssociationDisRef": ("plane", "association_dis_ref", float),
    "Plane.VerticalThreshold": ("plane", "vertical_threshold", float),
    "Plane.ParallelThreshold": ("plane", "parallel_threshold", float),
    "Plane.AngleInfo": ("plane", "angle_info", float),
    "Plane.DistanceInfo": ("plane", "distance_info", float),
    "Plane.Chi2": ("plane", "chi2", float),
    "Plane.VPChi2": ("plane", "vp_chi2", float),
    "Plane.MFVerticalThreshold": ("plane", "vertical_threshold", float),
    "Map.MaxPoints": ("map", "max_points", int),
    "Map.MaxLines": ("map", "max_lines", int),
    "Map.MaxPlanes": ("map", "max_planes", int),
    "Map.MaxKeyFrames": ("map", "max_keyframes", int),
    "Map.VocabWords": ("map", "vocab_words", int),
    "ORBextractor.maxKeypoints": ("orb", "max_keypoints", int),
    "Line.MaxLines": ("line", "max_lines", int),
    "Viewer.KeyFrameSize": ("viewer", "keyframe_size", float),
    "Viewer.PointSize": ("viewer", "point_size", float),
    "Viewer.CameraSize": ("viewer", "camera_size", float),
}


def load_config(path_or_dict: Any = None, **overrides) -> SlamConfig:
    """Build a SlamConfig, optionally from a reference-style YAML file
    (which may start with the OpenCV ``%YAML:1.0`` directive line)."""
    cfg = SlamConfig()
    if path_or_dict is None:
        data = {}
    elif isinstance(path_or_dict, Mapping):
        data = dict(path_or_dict)
    else:
        import yaml

        with open(path_or_dict) as f:
            text = f.read()
        if text.startswith("%YAML"):
            text = text.split("\n", 1)[1]
        data = yaml.safe_load(text) or {}

    groups: dict[str, dict] = {}
    for key, value in data.items():
        if key in _YAML_MAP:
            group, field, cast = _YAML_MAP[key]
            groups.setdefault(group, {})[field] = cast(value)
        elif key == "SavePath.path":
            cfg = cfg.replace(save_path=str(value))
    for group, fields in groups.items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group), **fields)})
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def tum_freiburg3() -> SlamConfig:
    """Preset matching Examples/RGB-D/TUM3.yaml."""
    return load_config({
        "Camera.fx": 535.4, "Camera.fy": 539.2,
        "Camera.cx": 320.1, "Camera.cy": 247.6,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 5000.0,
        "ORBextractor.nFeatures": 1000,
        "ORBextractor.scaleFactor": 1.2,
        "ORBextractor.nLevels": 8,
        "ORBextractor.iniThFAST": 20,
        "ORBextractor.minThFAST": 7,
    })


def icl_nuim() -> SlamConfig:
    """Preset matching Examples/RGB-D/ICL.yaml camera model."""
    return load_config({
        "Camera.fx": 481.2, "Camera.fy": 480.0,
        "Camera.cx": 319.5, "Camera.cy": 239.5,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 5000.0,
    })


def tum_freiburg1() -> SlamConfig:
    """Preset matching Examples/RGB-D/TUM1.yaml (fr1 sequences; strong
    radial distortion, so the undistortion path is exercised)."""
    return load_config({
        "Camera.fx": 517.306408, "Camera.fy": 516.469215,
        "Camera.cx": 318.643040, "Camera.cy": 255.313989,
        "Camera.k1": 0.262383, "Camera.k2": -0.953104,
        "Camera.p1": -0.005358, "Camera.p2": 0.002628,
        "Camera.k3": 1.163314,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 5000.0,
    })


def tum_freiburg2() -> SlamConfig:
    """Preset matching Examples/RGB-D/TUM2.yaml (fr2 sequences; note the
    non-standard DepthMapFactor 5208)."""
    return load_config({
        "Camera.fx": 520.908620, "Camera.fy": 521.007327,
        "Camera.cx": 325.141442, "Camera.cy": 249.701764,
        "Camera.k1": 0.231222, "Camera.k2": -0.784899,
        "Camera.p1": -0.003257, "Camera.p2": -0.000105,
        "Camera.k3": 0.917205,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 5208.0,
    })


def tamu() -> SlamConfig:
    """Preset matching Examples/RGB-D/TAMU.yaml (Kinect corridors)."""
    return load_config({
        "Camera.fx": 525.0, "Camera.fy": 525.0,
        "Camera.cx": 319.5, "Camera.cy": 239.5,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 5000.0,
    })


def realsense() -> SlamConfig:
    """Preset matching Examples/RGB-D/Realsense.yaml (live D4xx capture;
    millimeter depth units)."""
    return load_config({
        "Camera.fx": 609.70550296798035, "Camera.fy": 609.09579671294716,
        "Camera.cx": 319.16667152289227, "Camera.cy": 235.58360480225772,
        "Camera.k1": 0.092615504465028850, "Camera.k2": -0.18082438825995681,
        "Camera.p1": -0.00065484100374765971,
        "Camera.p2": -0.00035829351558557421,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 1000.0,
    })


def tartanair() -> SlamConfig:
    """Preset matching Examples/RGB-D/TartanAir.yaml (synthetic flight;
    ideal pinhole, millimeter depth units)."""
    return load_config({
        "Camera.fx": 320.0, "Camera.fy": 320.0,
        "Camera.cx": 320.0, "Camera.cy": 240.0,
        "Camera.width": 640, "Camera.height": 480,
        "Camera.fps": 30.0, "Camera.bf": 40.0,
        "DepthMapFactor": 1000.0,
    })
