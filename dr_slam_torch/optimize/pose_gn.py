"""The pose solve's CUDA kernel: its build, its input checks and its launch.

`csrc/pose_gn.cu` runs every round and Gauss-Newton step of
`pose_opt.pose_optimize` for one frame in a single launch (one thread
block); the plain body it computes is `pose_opt._pose_optimize_plain`. It
is built with nvcc for sm_90a on first use into `dr_slam_torch/_build/`
and loaded with ctypes, like the matcher.

`solve` checks its inputs (dtype, shape, contiguity, one CUDA device),
allocates the results with `torch.empty` and enqueues the kernel on the
current stream: no host sync, no fallback. It raises before any launch on
an input the kernel does not take, and after it if the launch returns a
CUDA error."""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from dr_slam_torch.utils.build import NVCC_FLAGS, build_library, nvcc

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "pose_gn.cu")

# the observation set's fields the kernel reads: name -> (dtype, trailing
# shape, which count its rows are)
_OBS = {
    "pt_world": (torch.float32, (3,), "NP"), "pt_obs": (torch.float32, (3,), "NP"),
    "pt_inv_sigma2": (torch.float32, (), "NP"), "pt_valid": (torch.bool, (), "NP"),
    "ln_world": (torch.float32, (6,), "NL"), "ln_obs": (torch.float32, (3,), "NL"),
    "ln_inv_sigma2": (torch.float32, (), "NL"), "ln_valid": (torch.bool, (), "NL"),
    "pl_world": (torch.float32, (4,), "NF"), "pl_obs": (torch.float32, (4,), "NF"),
    "pl_valid": (torch.bool, (), "NF"),
    "par_world": (torch.float32, (4,), "NS"), "par_obs": (torch.float32, (4,), "NS"),
    "par_valid": (torch.bool, (), "NS"),
    "ver_world": (torch.float32, (4,), "NS"), "ver_obs": (torch.float32, (4,), "NS"),
    "ver_valid": (torch.bool, (), "NS"),
}


class _Problem(ctypes.Structure):
    """csrc/pose_gn.cu: PoseGnProblem, field for field."""
    _fields_ = ([("T_init", ctypes.c_void_p)]
                + [(name, ctypes.c_void_p) for name in _OBS]
                + [(name, ctypes.c_void_p) for name in
                   ("T_out", "pt_in", "ln_in", "pl_in", "n_inliers", "chi2")]
                + [(name, ctypes.c_int) for name in
                   ("NP", "NL", "NF", "NS", "n_rounds", "n_iters",
                    "translation_only", "struct_on", "use_prior")]
                + [(name, ctypes.c_float) for name in
                   ("fx", "fy", "cx", "cy", "bf", "angle_info", "dist_info",
                    "plane_chi2", "vp_chi2", "sqrt_plane_chi2",
                    "sqrt_vp_chi2", "damping", "prior_wt", "prior_wr")])


def build() -> dict:
    """Compile the kernel (if this source has not been built yet) and return
    {"path", "seconds", "log"}."""
    return build_library(_SRC, "pose_gn", nvcc("csrc/pose_gn.cu"), NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    lib.pose_gn_launch.argtypes = [ctypes.POINTER(_Problem), ctypes.c_void_p]
    lib.pose_gn_launch.restype = ctypes.c_int
    return lib


def check_inputs(T_init: torch.Tensor, obs) -> dict:
    """The counts {"NP", "NL", "NF", "NS"} of an observation set the kernel
    takes; ValueError on a dtype, shape, device or layout it does not."""
    def need(name, x, dtype, shape):
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"pose_gn: {name} must be {shape} {dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"pose_gn: {name} must be contiguous")
        if x.device != T_init.device:
            raise ValueError(f"pose_gn: {name} is on {x.device}, T_init on "
                             f"{T_init.device}")

    need("T_init", T_init, torch.float32, (4, 4))
    counts = {}
    for name, (dtype, tail, count) in _OBS.items():
        x = getattr(obs, name)
        n = counts.setdefault(count, x.shape[0] if x.dim() else -1)
        need(name, x, dtype, (n,) + tail)
    return counts


def solve(T_init: torch.Tensor, obs, K4, bf: float, translation_only: bool,
          struct_on: bool, n_rounds: int, n_iters: int, angle_info: float,
          dist_info: float, plane_chi2: float, vp_chi2: float, damping: float,
          prior_sigma_t: float, prior_sigma_r: float) -> tuple:
    """One launch of the kernel on `pose_optimize`'s arguments -> (T_cw,
    pt_inlier, ln_inlier, pl_inlier, n_inliers, chi2), the fields of
    `PoseOptResult`, still being computed on the current stream."""
    counts = check_inputs(T_init, obs)
    dev = T_init.device
    if dev.type != "cuda":
        raise ValueError(f"pose_gn: the kernel takes CUDA tensors, got {dev}; "
                         "pose_optimize runs CPU tensors through its plain "
                         "body")
    use_prior = prior_sigma_t > 0 and prior_sigma_r > 0
    out = (torch.empty((4, 4), dtype=torch.float32, device=dev),
           torch.empty(counts["NP"], dtype=torch.bool, device=dev),
           torch.empty(counts["NL"], dtype=torch.bool, device=dev),
           torch.empty(counts["NF"], dtype=torch.bool, device=dev),
           torch.empty((), dtype=torch.int64, device=dev),
           torch.empty((), dtype=torch.float32, device=dev))
    fx, fy, cx, cy = (float(k) for k in K4)
    prob = _Problem(
        T_init.data_ptr(), *(getattr(obs, name).data_ptr() for name in _OBS),
        *(x.data_ptr() for x in out),
        counts["NP"], counts["NL"], counts["NF"], counts["NS"],
        n_rounds, n_iters, bool(translation_only), bool(struct_on), use_prior,
        fx, fy, cx, cy, bf, angle_info, dist_info, plane_chi2, vp_chi2,
        plane_chi2 ** 0.5, vp_chi2 ** 0.5, damping,
        1.0 / prior_sigma_t ** 2 if use_prior else 0.0,
        1.0 / prior_sigma_r ** 2 if use_prior else 0.0)
    with torch.cuda.device(dev):   # the launch goes to the current device
        err = _library().pose_gn_launch(
            ctypes.byref(prob), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"pose_gn launch failed: CUDA error {err}")
    return out
