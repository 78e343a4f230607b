"""TUM RGB-D dataset loading and export.

Counterpart of the JAX package's `io/tum.py` (the reference's LoadImages and
associate parsing, Examples/RGB-D/main.cc:138, and the 16U depth conversion
of src/Frame.cc): a sequence directory is read through its
``associate.txt`` (``t_rgb rgb/... t_depth depth/...`` rows), or through
``rgb.txt`` and ``depth.txt`` paired by nearest timestamp. Frames are host
numpy arrays: gray float32 in [0, 255], depth float32 metres (the 16-bit
PNG value over the depth factor), the same expressions as the reference, so
the arrays are bit-equal. PNGs are decoded and written with Pillow;
`io/native_loader.py` is the threaded C++ decode path."""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass
class RGBDFrame:
    timestamp: float
    gray: np.ndarray       # (H, W) float32 in [0, 255]
    depth: np.ndarray      # (H, W) float32 metres, 0 = invalid
    rgb_path: str = ""
    depth_path: str = ""


def _read_rows(path: str) -> list[list[str]]:
    """The whitespace-split fields of each non-empty, non-comment line."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                rows.append(line.split())
    return rows


def parse_associations(path: str) -> list[tuple[float, str, float, str]]:
    return [(float(p[0]), p[1], float(p[2]), p[3])
            for p in _read_rows(path) if len(p) >= 4]


def associate(rgb_file: str, depth_file: str, max_dt: float = 0.02
              ) -> list[tuple[float, str, float, str]]:
    """Greedy nearest-timestamp pairing of the rgb.txt and depth.txt
    listings (the role of the TUM associate.py tool): each rgb frame takes
    its nearest depth frame if it is within `max_dt` and not taken."""
    rgb = [(float(p[0]), p[1]) for p in _read_rows(rgb_file)]
    depth = [(float(p[0]), p[1]) for p in _read_rows(depth_file)]
    dts = np.array([d[0] for d in depth])
    rows, used = [], set()
    for t, rel in rgb:
        j = int(np.argmin(np.abs(dts - t)))
        if abs(dts[j] - t) < max_dt and j not in used:
            used.add(j)
            rows.append((t, rel, depth[j][0], depth[j][1]))
    return rows


def read_gray(path: str) -> np.ndarray:
    """A PNG as float32 gray in [0, 255] (colour converted by Pillow's "L",
    as the reference does). Raises if the file cannot be read."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img.convert("L"), dtype=np.float32)


def read_depth(path: str, depth_factor: float) -> np.ndarray:
    """A 16-bit depth PNG as float32 metres (value / depth_factor)."""
    from PIL import Image
    with Image.open(path) as img:
        return np.asarray(img, dtype=np.float32) / depth_factor


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file, read from its header."""
    from PIL import Image
    with Image.open(path) as img:
        return img.size


class TUMDataset:
    """Iterates RGBDFrames from a TUM-format sequence directory."""

    def __init__(self, root: str, associations: str | None = None,
                 depth_factor: float = 5000.0):
        self.root = root
        self.depth_factor = depth_factor
        if associations is None:
            for cand in ("associate.txt", "associations.txt",
                         "association.txt"):
                p = os.path.join(root, cand)
                if os.path.exists(p):
                    associations = p
                    break
        if associations is not None and os.path.exists(associations):
            self.rows = parse_associations(associations)
        else:
            self.rows = associate(os.path.join(root, "rgb.txt"),
                                  os.path.join(root, "depth.txt"))

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, i: int) -> RGBDFrame:
        t_rgb, rgb_rel, _, depth_rel = self.rows[i]
        rgb_path = os.path.join(self.root, rgb_rel)
        depth_path = os.path.join(self.root, depth_rel)
        return RGBDFrame(timestamp=t_rgb, gray=read_gray(rgb_path),
                         depth=read_depth(depth_path, self.depth_factor),
                         rgb_path=rgb_path, depth_path=depth_path)

    def __iter__(self) -> Iterator[RGBDFrame]:
        for i in range(len(self)):
            yield self[i]


def export_tum_sequence(out_dir: str, poses_cw: Sequence[np.ndarray],
                        render_fn, depth_factor: float = 5000.0,
                        fps: float = 30.0, t0: float = 1000.0) -> str:
    """Write a TUM-format RGB-D sequence directory: ``rgb/*.png`` 8-bit
    gray, ``depth/*.png`` 16-bit sensor units (metres times the depth
    factor), the ``rgb.txt`` / ``depth.txt`` listings, ``associate.txt``
    and ``groundtruth.txt`` (T_wc rows, ``t tx ty tz qx qy qz qw``). The
    files are byte-identical to the reference package's for the same
    inputs.

    render_fn(i) -> (gray [0, 255], depth metres) arrays. Returns out_dir."""
    from PIL import Image

    from dr_slam_torch.io.trajectory import pose_to_tum_row

    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "depth"), exist_ok=True)
    rgb_rows, depth_rows, assoc_rows, gt_rows = [], [], [], []
    for i, T_cw in enumerate(poses_cw):
        t = t0 + i / fps
        gray, depth = (np.asarray(x) for x in render_fn(i))
        g8 = np.clip(gray + 0.5, 0, 255).astype(np.uint8)
        d16 = np.clip(depth * depth_factor + 0.5, 0, 65535).astype(np.uint16)
        rgb_rel = f"rgb/{t:.6f}.png"
        depth_rel = f"depth/{t:.6f}.png"
        Image.fromarray(g8).save(os.path.join(out_dir, rgb_rel))
        Image.fromarray(d16).save(os.path.join(out_dir, depth_rel))
        rgb_rows.append(f"{t:.6f} {rgb_rel}")
        depth_rows.append(f"{t:.6f} {depth_rel}")
        assoc_rows.append(f"{t:.6f} {rgb_rel} {t:.6f} {depth_rel}")
        gt_rows.append(pose_to_tum_row(t, np.asarray(T_cw)))
    header = "# timestamp filename\n"
    files = {"rgb.txt": header + "\n".join(rgb_rows) + "\n",
             "depth.txt": header + "\n".join(depth_rows) + "\n",
             "associate.txt": "\n".join(assoc_rows) + "\n",
             "groundtruth.txt": "# timestamp tx ty tz qx qy qz qw\n"
             + "\n".join(gt_rows) + "\n"}
    for name, text in files.items():
        with open(os.path.join(out_dir, name), "w") as f:
            f.write(text)
    return out_dir


def load_groundtruth(path: str) -> tuple[np.ndarray, np.ndarray]:
    """TUM groundtruth.txt -> (timestamps (N,), poses (N, 7) tx..qw)."""
    ts, poses = [], []
    for p in _read_rows(path):
        vals = [float(v) for v in p]
        if len(vals) >= 8:
            ts.append(vals[0])
            poses.append(vals[1:8])
    return np.asarray(ts), np.asarray(poses)
