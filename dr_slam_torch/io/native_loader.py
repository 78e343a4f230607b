"""ctypes binding of the C++ frame loader (`csrc/frame_loader.cpp`).

Counterpart of the JAX package's `io/native_loader.py`: a background C++
thread decodes a TUM sequence's PNG pairs (its own inflate and unfilter on
zlib, no libpng) into gray and metre-depth float32 frames and holds them in
a bounded prefetch ring, so decoding overlaps tracking. The source is a
byte-for-byte copy of the repository's `native/frame_loader.cpp`; it is
built from the port's own tree with g++ on first use into
`dr_slam_torch/_build/` (git-ignored; the library name carries a hash of
the source, the flags and the build host). Frames the decoder rejects
(palette, interlaced, corrupt) are read by the port's Pillow reader
(`io/tum.py`), which raises if the file is unreadable: a host decode path,
never a black frame."""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from dr_slam_torch.io.tum import image_size
from dr_slam_torch.utils.build import build_library, library_path

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "frame_loader.cpp")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-lz", "-lpthread"]


def build() -> dict:
    """Compile the loader (unless this source is built already) ->
    {"path", "seconds", "log"}; raises with g++'s message on failure."""
    return build_library(_SRC, "frame_loader", "g++", CXX_FLAGS, LIBS)


def build_native(force: bool = False) -> bool:
    """Build the loader; True on success (the reference's interface)."""
    lib = library_path(_SRC, "frame_loader", "g++", CXX_FLAGS, LIBS)
    if force and os.path.exists(lib):
        os.remove(lib)
    try:
        build()
    except RuntimeError:
        return False
    return True


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["path"])
    lib.loader_open.restype = ctypes.c_void_p
    lib.loader_open.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_int]
    lib.loader_next_ex.restype = ctypes.c_int
    lib.loader_next_ex.argtypes = [
        ctypes.c_void_p,
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"),
        ctypes.POINTER(ctypes.c_int)]
    lib.loader_close.argtypes = [ctypes.c_void_p]
    return lib


class NativeTUMLoader:
    """Iterator over (index, timestamp, gray, depth) with C++ decoding and
    prefetch. Raises if the loader cannot be built (the caller may use
    `TUMDataset` instead)."""

    def __init__(self, dataset, queue_cap: int = 4):
        """dataset: a TUMDataset (its association rows and paths)."""
        try:
            self._lib = _library()
        except RuntimeError as e:
            raise RuntimeError(
                "native loader unavailable (TUMDataset reads the same "
                f"frames): {e}") from e
        self.dataset = dataset
        self.timestamps = [r[0] for r in dataset.rows]
        self.w, self.h = image_size(os.path.join(dataset.root,
                                                 dataset.rows[0][1]))
        gp = [os.path.join(dataset.root, r[1]).encode() for r in dataset.rows]
        dp = [os.path.join(dataset.root, r[3]).encode() for r in dataset.rows]
        paths = ctypes.c_char_p * len(gp)
        self._handle = self._lib.loader_open(
            paths(*gp), paths(*dp), len(gp), self.w, self.h,
            float(dataset.depth_factor), queue_cap)

    def __iter__(self):
        """Yields (index, timestamp, gray, depth). A frame whose PNGs the
        decoder rejected is read by `TUMDataset`, which raises if it is
        unreadable."""
        gray = np.empty((self.h, self.w), np.float32)
        depth = np.empty((self.h, self.w), np.float32)
        err = ctypes.c_int(0)
        while True:
            idx = self._lib.loader_next_ex(self._handle, gray, depth,
                                           ctypes.byref(err))
            if idx < 0:
                break
            if err.value != 0:
                fr = self.dataset[idx]
                yield idx, self.timestamps[idx], fr.gray, fr.depth
                continue
            yield idx, self.timestamps[idx], gray.copy(), depth.copy()

    def close(self):
        if self._handle:
            self._lib.loader_close(self._handle)
            self._handle = None
