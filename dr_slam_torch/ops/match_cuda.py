"""Gated top-2 Hamming matcher: the CUDA kernel's wrapper and its plain
PyTorch version.

Counterpart of the JAX package's `ops/match_pallas.py` (the TPU kernel
`gated_top2_hamming`), which `match_points_projection` runs twice per frame.
The Hopper kernel is `csrc/gated_top2_hamming.cu`, built with nvcc for
sm_90a on first use into `dr_slam_torch/_build/` and loaded with ctypes.

The wrapper dispatches on the tensors' device: CPU tensors go through
`gated_top2_hamming_ref`, CUDA tensors through the kernel (a failed build or
launch raises; there is no fallback). The kernel reads the packed (K, 8) and
(NC, 8) int32 descriptors directly; the plain version scores the same pairs
with a +/-1 float32 matmul in 4096-candidate chunks, merging chunks the way
the reference scan path (the JAX package's `slam/map_ops._match_scan_path`) does.
Both break ties toward the lowest index, so they agree bit for bit."""

from __future__ import annotations

import ctypes
import functools
import os

import torch

from dr_slam_torch.ops.orb import bits_to_signs, unpack_bits
from dr_slam_torch.utils.build import NVCC_FLAGS, build_library, nvcc

# Candidate padding rule of the matcher contract (as in the Pallas wrapper):
# NC must be a multiple of TILE_C, padded with pt_valid = False.
TILE_C = 512
_SCAN_CHUNK = 4096

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "csrc", "gated_top2_hamming.cu")


def build() -> dict:
    """Compile the kernel (if this source has not been built yet) and return
    {"path", "seconds", "log"}."""
    return build_library(_SRC, "gated_top2_hamming",
                         nvcc("csrc/gated_top2_hamming.cu"), NVCC_FLAGS)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    fn = lib.gated_top2_hamming_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_void_p] * 9
    fn.restype = ctypes.c_int
    lib.gated_top2_hamming_chunk.argtypes = []
    lib.gated_top2_hamming_chunk.restype = ctypes.c_int
    return lib


# What the kernel reads: name -> (dtype, trailing shape, byte alignment).
_KERNEL_ARGS = {
    "kp_desc": (torch.int32, (8,), 16), "kp_uv": (torch.float32, (2,), 8),
    "kp_valid": (torch.bool, (), 1), "kp_octave": (torch.int32, (), 4),
    "pt_desc": (torch.int32, (8,), 16), "pt_uv": (torch.float32, (2,), 8),
    "pt_rad": (torch.float32, (), 4), "pt_lvl": (torch.int32, (), 4),
    "pt_si": (torch.bool, (), 1), "pt_valid": (torch.bool, (), 16),
}


def _check(name: str, x: torch.Tensor, n: int) -> None:
    dtype, tail, align = _KERNEL_ARGS[name]
    if x.dtype != dtype or tuple(x.shape) != (n,) + tail:
        raise ValueError(f"gated_top2_hamming: {name} must be {(n,) + tail} "
                         f"{dtype}, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % align:
        raise ValueError(f"gated_top2_hamming: {name} must be contiguous and "
                         f"{align}-byte aligned")


def gated_top2_hamming(kp_desc, kp_uv, kp_valid, kp_octave,
                       pt_desc, pt_uv, pt_rad, pt_lvl, pt_si, pt_valid):
    """Gated top-2 Hamming match.

    kp_desc (K, 8) int32 packed, kp_uv (K, 2) float32, kp_valid (K,) bool,
    kp_octave (K,) int32 (zeros with pt_si all False disable the level
    gate); pt_desc (NC, 8) int32 packed, pt_uv (NC, 2) float32, pt_rad (NC,)
    float32, pt_lvl (NC,) int32, pt_si and pt_valid (NC,) bool, NC a
    multiple of TILE_C (pad with pt_valid = False). CPU tensors may hold
    any dtype the plain version casts from.

    Returns (best_d (K,) f32, best_i (K,) int32, second_d (K,) f32,
    col_best_k (NC,) int32)."""
    K, NC = kp_desc.shape[0], pt_desc.shape[0]
    if NC % TILE_C:
        raise ValueError(f"candidate count {NC} is not a multiple of {TILE_C}")
    dev = kp_desc.device
    args = (kp_uv, kp_valid, kp_octave, pt_desc, pt_uv, pt_rad, pt_lvl,
            pt_si, pt_valid)
    if any(a.device != dev for a in args):
        raise ValueError("gated_top2_hamming: all inputs must share a device")
    if dev.type == "cpu":
        return gated_top2_hamming_ref(kp_desc, *args)
    if dev.type != "cuda":
        raise ValueError(f"gated_top2_hamming: unsupported device {dev}")
    if K == 0:
        raise ValueError("gated_top2_hamming: no keypoints")
    inputs = (kp_desc,) + args
    for name, x in zip(_KERNEL_ARGS, inputs):
        _check(name, x, K if name.startswith("kp_") else NC)
    bufs = kernel_buffers(K, NC, dev)
    launch_kernel(inputs, bufs)
    gated_top2_hamming.launches += 1
    best, second, idx, colk = bufs[-4:]
    return best, idx, second, colk


gated_top2_hamming.launches = 0


def kernel_buffers(K: int, NC: int, device) -> tuple:
    """The kernel's scratch and outputs, uninitialised: per-chunk row keys
    (best, second), the live slots in ascending order, the per-slot column
    keys, the live count, then best, second, idx and colk."""
    n_chunks = -(-NC // _library().gated_top2_hamming_chunk())
    f32, i32 = torch.float32, torch.int32
    return (torch.empty((n_chunks, K, 2), dtype=i32, device=device),
            torch.empty(NC, dtype=i32, device=device),
            torch.empty(NC, dtype=i32, device=device),
            torch.empty(1, dtype=i32, device=device),
            torch.empty(K, dtype=f32, device=device),
            torch.empty(K, dtype=f32, device=device),
            torch.empty(K, dtype=i32, device=device),
            torch.empty(NC, dtype=i32, device=device))


def launch_kernel(inputs: tuple, bufs: tuple) -> None:
    """Enqueue the kernel on the current stream, on inputs that
    `gated_top2_hamming` has checked, into `kernel_buffers(K, NC)`. Adds
    nothing to the launch count: the wrapper does that."""
    K, NC = inputs[0].shape[0], inputs[4].shape[0]
    err = _library().gated_top2_hamming_launch(
        *(x.data_ptr() for x in inputs), K, NC,
        *(b.data_ptr() for b in bufs),
        torch.cuda.current_stream(inputs[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gated_top2_hamming launch failed: CUDA error {err}")


def gated_top2_hamming_ref(kp_desc, kp_uv, kp_valid, kp_octave,
                           pt_desc, pt_uv, pt_rad, pt_lvl, pt_si, pt_valid):
    """Plain PyTorch version of `gated_top2_hamming` (same arguments and
    results): the reference scan path, +/-1 float32 matmul per 4096-candidate
    chunk, chunks without a valid candidate skipped."""
    K, NC = kp_desc.shape[0], pt_desc.shape[0]
    dev = kp_desc.device
    C = min(_SCAN_CHUNK, NC)
    signs_kp = bits_to_signs(unpack_bits(kp_desc))             # (K, 256)
    kp_oct = kp_octave.to(torch.int32)
    kp_ok = kp_valid.to(torch.bool)
    pt_ok = pt_valid.to(torch.bool)
    pt_si = pt_si.to(torch.bool)
    best_d = torch.full((K,), torch.inf, device=dev)
    second_d = torch.full((K,), torch.inf, device=dev)
    best_i = torch.zeros((K,), dtype=torch.int32, device=dev)
    col_best = torch.zeros((NC,), dtype=torch.int32, device=dev)
    for off in range(0, NC, C):
        sl = slice(off, off + C)
        vc = pt_ok[sl]
        if not bool(vc.any()):
            continue
        sg = bits_to_signs(unpack_bits(pt_desc[sl]))
        ham = (256.0 - signs_kp @ sg.T) * 0.5                   # (K, C)
        du = torch.abs(kp_uv[:, 0:1] - pt_uv[sl][None, :, 0])
        dv = torch.abs(kp_uv[:, 1:2] - pt_uv[sl][None, :, 1])
        rad = pt_rad[sl][None, :]
        gate = (du < rad) & (dv < rad) & vc[None, :] & kp_ok[:, None]
        dlvl = torch.abs(kp_oct[:, None] - pt_lvl[sl].to(torch.int32)[None, :])
        gate &= (dlvl <= 1) | ~pt_si[sl][None, :]
        D = torch.where(gate, ham, torch.full_like(ham, torch.inf))
        cmin = torch.amin(D, 1)
        carg = torch.argmin(D, 1)
        csec = torch.amin(D.scatter(1, carg[:, None], torch.inf), 1)
        new_best = torch.minimum(best_d, cmin)
        second_d = torch.minimum(torch.maximum(best_d, cmin),
                                 torch.minimum(second_d, csec))
        best_i = torch.where(cmin < best_d, (carg + off).to(torch.int32), best_i)
        best_d = new_best
        col_best[sl] = torch.argmin(D, 0).to(torch.int32)
    return best_d, best_i, second_d, col_best
