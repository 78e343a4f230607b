"""Planar mesh export to PLY.

Counterpart of the JAX package's `io/mesh_export.py` (the capability of the
reference's MeshViewer and Mesh, src/MeshViewer.cc:35-80): each map plane's
sample cloud is projected onto the plane, gridded in the plane's own 2D
frame and triangulated as a regular grid (where the reference runs PCL's
greedy projection triangulation). Host numpy over the plane fields of the
port's `MapState`, read back once; the same expressions and the same
seeded colours as the reference, so the PLY is byte-identical."""

from __future__ import annotations

import numpy as np

from dr_slam_torch import to_numpy


def _plane_basis(n: np.ndarray):
    a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
    t1 = np.cross(n, a)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(n, t1)
    return t1, t2


def plane_meshes(state, cell: float = 0.10):
    """-> (vertices (V, 3), faces (F, 3), colours (V, 3) uint8) over the
    valid planes with at least 8 cloud samples."""
    pl_coef, pl_valid, clouds, cvalid = (
        to_numpy(getattr(state, f))
        for f in ("pl_coef", "pl_valid", "pl_cloud", "pl_cloud_valid"))
    verts, faces, colors = [], [], []
    rng = np.random.RandomState(7)
    for i in np.where(pl_valid)[0]:
        pts = clouds[i][cvalid[i]]
        if len(pts) < 8:
            continue
        n, d = pl_coef[i, :3], pl_coef[i, 3]
        t1, t2 = _plane_basis(n)
        # project the samples onto the plane, grid them in (t1, t2)
        proj = pts - ((pts @ n + d)[:, None]) * n
        uv = np.stack([proj @ t1, proj @ t2], -1)
        lo = uv.min(0)
        ij = np.floor((uv - lo) / cell).astype(int)
        occupied = set(map(tuple, ij))
        color = (rng.rand(3) * 155 + 100).astype(np.uint8)
        base = sum(len(v) for v in verts)
        vid = {}
        for (a, b) in sorted(occupied):
            # the quad's corners in plane coordinates -> 3D
            for corner in [(a, b), (a + 1, b), (a, b + 1), (a + 1, b + 1)]:
                if corner not in vid:
                    u, v = lo + np.asarray(corner) * cell
                    p3 = u * t1 + v * t2 - d * n
                    vid[corner] = base + len(vid)
                    verts.append(p3[None])
                    colors.append(color[None])
            q = [vid[(a, b)], vid[(a + 1, b)], vid[(a, b + 1)],
                 vid[(a + 1, b + 1)]]
            faces.append(np.array([[q[0], q[1], q[2]], [q[1], q[3], q[2]]]))
    if not verts:
        return (np.zeros((0, 3)), np.zeros((0, 3), int),
                np.zeros((0, 3), np.uint8))
    return (np.concatenate(verts), np.concatenate(faces),
            np.concatenate(colors))


def save_mesh_ply(path: str, state, cell: float = 0.10) -> None:
    """The planar map as a coloured ASCII PLY (MeshViewer::SaveMeshModel)."""
    v, f, c = plane_meshes(state, cell)
    with open(path, "w") as fh:
        fh.write("ply\nformat ascii 1.0\n")
        fh.write(f"element vertex {len(v)}\n")
        fh.write("property float x\nproperty float y\nproperty float z\n")
        fh.write("property uchar red\nproperty uchar green\n"
                 "property uchar blue\n")
        fh.write(f"element face {len(f)}\n")
        fh.write("property list uchar int vertex_indices\nend_header\n")
        for p, col in zip(v, c):
            fh.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} "
                     f"{col[0]} {col[1]} {col[2]}\n")
        for tri in f:
            fh.write(f"3 {tri[0]} {tri[1]} {tri[2]}\n")
