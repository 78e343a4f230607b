"""Compile a C++ or CUDA source of the package into a shared library on
first use, into `dr_slam_torch/_build/` (git-ignored). The library's name
carries a hash of the source, the compiler's flags and the build host (the
compiler's `--version`, the machine's architecture, name and C library), so
an edited source, a changed flag or a library built on another host is
rebuilt and never loaded; the build writes a temporary file and renames it,
so concurrent builds never load a half-written one."""

from __future__ import annotations

import functools
import hashlib
import os
import platform
import shutil
import subprocess
import time

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")

# the package's CUDA sources: Hopper only, a plain C interface for ctypes
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc(src: str) -> str:
    """The CUDA compiler: `$CUDA_HOME/bin/nvcc`, else
    `/usr/local/cuda/bin/nvcc`, else `nvcc` on the PATH. Raises
    RuntimeError naming `src` where there is none."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(f"nvcc not found: the CUDA toolkit is needed to "
                           f"build {src}")
    return found


@functools.lru_cache(maxsize=None)
def host_identity(compiler: str) -> str:
    """The compiler's `--version` and the host it runs on: what a library
    built here depends on beyond its source and flags."""
    try:
        version = subprocess.run([compiler, "--version"], capture_output=True,
                                 text=True).stdout
    except OSError:
        version = "not runnable"
    return "\n".join([compiler, version, platform.machine(), platform.node(),
                      " ".join(platform.libc_ver())])


def library_path(src: str, stem: str, compiler: str, flags: list,
                 libs=()) -> str:
    with open(src, "rb") as f:
        key = f.read() + "\n".join([" ".join([*flags, *libs]),
                                    host_identity(compiler)]).encode()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{stem}_{digest}.so")


def build_library(src: str, stem: str, compiler: str, flags: list,
                  libs=()) -> dict:
    """`compiler flags... src -o lib<stem>_<hash>.so libs...` (libraries
    after the source, as the linker resolves them in order), unless that
    library exists -> {"path", "seconds", "log"}. Raises RuntimeError with
    the compiler's message if it fails or cannot be run."""
    lib = library_path(src, stem, compiler, flags, libs)
    if os.path.exists(lib):
        return {"path": lib, "seconds": 0.0, "log": "cached"}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([compiler, *flags, src, "-o", tmp, *libs],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"{compiler} could not be run: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{compiler} failed on {os.path.basename(src)} "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return {"path": lib, "seconds": time.perf_counter() - t0,
            "log": proc.stderr}
