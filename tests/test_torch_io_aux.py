"""The port's host-side map exports and small numeric helpers against the
JAX package, on identical inputs.

- Occupancy: `occupancy_grid_2d` and `occupancy_grid_3d` give equal grids
  and origins (integer counts: exact; the origin: bit-equal float32), and
  `save_occupancy_map` and `save_mesh_ply` write byte-identical files, on
  one map carried across by `tests/torch_parity.py`: `synthetic_map_state`
  at the small config, with seeded sample clouds on its planes, points
  outside the 2D height band and points outside the grid. The .npz is
  compared member by member (each stored .npy's bytes), since the zip's
  own headers carry the time of writing.
- `se3.rot_to_quat` within 1e-6 of the JAX function (observed: at most
  6e-8) on rotations that take each of Shepperd's four pivots, the
  reference's quaternion sign included.
- `train_vocabulary` bit-identical (host numpy in both), with more and with
  fewer descriptors than words.
- The vocabulary fallback: with nothing registered, the port's codebook
  for 512 and 4096 words equals the JAX package's bit for bit (both the
  seeded random codebook)."""

import io
import os
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.associate import vocabulary as jvoc
from dr_slam_tpu.geometry import se3 as jse3
from dr_slam_tpu.io import mesh_export as jmesh
from dr_slam_tpu.io import occupancy as jocc
from dr_slam_tpu.io.synthetic import synthetic_map_state
from dr_slam_torch.associate import vocabulary as tvoc
from dr_slam_torch.geometry import se3 as tse3
from dr_slam_torch.io import mesh_export as tmesh
from dr_slam_torch.io import occupancy as tocc

from torch_parity import small_cfg, state_to_port

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def maps():
    """(JAX MapState, the port's) of one map with plane sample clouds."""
    st, _ = synthetic_map_state(small_cfg(), 6, seed=3)
    rng = np.random.RandomState(11)
    coef = np.asarray(st.pl_coef)
    valid = np.asarray(st.pl_valid)
    cloud = np.zeros(st.pl_cloud.shape, np.float32)
    cvalid = np.zeros(st.pl_cloud_valid.shape, bool)
    Q = cloud.shape[1]
    for i in np.where(valid)[0]:
        n, d = coef[i, :3], coef[i, 3]
        a = np.array([1.0, 0, 0]) if abs(n[0]) < 0.9 else np.array([0, 1.0, 0])
        t1 = np.cross(n, a)
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(n, t1)
        m = int(rng.randint(4, Q))       # some planes below the 8-sample floor
        uv = rng.uniform(-1.5, 1.5, (m, 2))
        cloud[i, :m] = (uv[:, :1] * t1 + uv[:, 1:] * t2 - d * n
                        + rng.normal(0, 0.01, (m, 3)))
        cvalid[i, :m] = rng.rand(m) < 0.95
    pos = np.asarray(st.pt_pos).copy()
    pos[:40, 1] = 3.0                    # above the 2D height band
    pos[40:60] += 40.0                   # outside the grid
    st = st._replace(pl_cloud=jnp.asarray(cloud),
                     pl_cloud_valid=jnp.asarray(cvalid),
                     pt_pos=jnp.asarray(pos))
    return st, state_to_port(st)


def test_occupancy_grids_equal(maps):
    jst, tst = maps
    for args in ((0.05, 256), (0.1, 64), (0.02, 128)):
        jg, jo = jocc.occupancy_grid_2d(jst.pt_pos, jst.pt_valid, *args)
        tg, to = tocc.occupancy_grid_2d(tst.pt_pos, tst.pt_valid, *args)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        assert to.dtype == np.asarray(jo).dtype == np.float32
        np.testing.assert_array_equal(to, np.asarray(jo))
    assert np.asarray(jg).sum() > 0
    jg, jo = jocc.occupancy_grid_3d(jst.pt_pos, jst.pt_valid)
    tg, to = tocc.occupancy_grid_3d(tst.pt_pos, tst.pt_valid)
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(to, np.asarray(jo))
    assert np.asarray(jg).sum() > 0
    # a given origin, and no valid point at all
    none = np.zeros(jst.pt_valid.shape, bool)
    jg, jo = jocc.occupancy_grid_2d(jst.pt_pos, none, origin=(-1.0, -2.0))
    tg, to = tocc.occupancy_grid_2d(tst.pt_pos, torch.from_numpy(none),
                                    origin=(-1.0, -2.0))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    np.testing.assert_array_equal(to, np.asarray(jo))


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


def test_saved_occupancy_and_mesh_byte_identical(maps, tmp_path):
    jst, tst = maps
    jocc.save_occupancy_map(str(tmp_path / "j"), jst)
    tocc.save_occupancy_map(str(tmp_path / "t"), tst)
    assert (tmp_path / "t.pgm").read_bytes() == (tmp_path / "j.pgm").read_bytes()
    jm, tm = _npz_members(tmp_path / "j.npz"), _npz_members(tmp_path / "t.npz")
    assert jm == tm and set(jm) == {"grid.npy", "origin.npy",
                                    "resolution.npy"}
    grid = np.load(io.BytesIO(jm["grid.npy"]))
    assert grid.sum() > int(np.asarray(jst.pt_valid).sum()) // 2
    jmesh.save_mesh_ply(str(tmp_path / "j.ply"), jst)
    tmesh.save_mesh_ply(str(tmp_path / "t.ply"), tst)
    text = (tmp_path / "t.ply").read_bytes()
    assert text == (tmp_path / "j.ply").read_bytes()
    jv, jf, jc = jmesh.plane_meshes(jst)
    tv, tf, tc = tmesh.plane_meshes(tst)
    assert len(tv) > 100 and len(tf) > 100
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tc, jc)


def _rotations():
    """Rotations whose largest Shepperd pivot is each of the four: near the
    identity (trace) and near half-turns about x, y and z, plus random."""
    rng = np.random.RandomState(5)
    out = []
    for axis in (None, 0, 1, 2):
        for _ in range(6):
            w = rng.normal(0, 0.2, 3)
            if axis is not None:
                w[axis] += np.pi * rng.choice([-1.0, 1.0]) * 0.97
            out.append(np.asarray(tse3.so3_exp(torch.tensor(
                w, dtype=torch.float32))))
    q = rng.normal(size=(20, 4))
    out += list(np.asarray(tse3.quat_to_rot(torch.tensor(q, dtype=torch.float32))))
    return np.stack(out).astype(np.float32)


def test_rot_to_quat_matches_jax():
    R = _rotations()
    m = R
    pivots = np.stack([m[:, 0, 0] + m[:, 1, 1] + m[:, 2, 2],
                       m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                       m[:, 1, 1] - m[:, 0, 0] - m[:, 2, 2],
                       m[:, 2, 2] - m[:, 0, 0] - m[:, 1, 1]], -1)
    assert set(np.argmax(pivots, -1)) == {0, 1, 2, 3}
    tq = tse3.rot_to_quat(torch.from_numpy(R)).numpy()
    jq = np.asarray(jse3.rot_to_quat(jnp.asarray(R)))
    np.testing.assert_allclose(tq, jq, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tq, axis=-1), 1.0, atol=1e-6)
    # one rotation at a time, as the node calls it
    np.testing.assert_allclose(tse3.rot_to_quat(torch.from_numpy(R[3])).numpy(),
                               jq[3], rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_desc,n_words,iters", [(3000, 64, 3), (40, 64, 2)])
def test_train_vocabulary_bit_identical(n_desc, n_words, iters):
    rng = np.random.RandomState(n_desc)
    centres = rng.randint(0, 2 ** 32, (16, 8), dtype=np.uint64)
    desc = centres[rng.randint(0, 16, n_desc)].astype(np.uint32)
    flips = (rng.rand(n_desc, 8, 32) < 0.1)
    desc ^= (flips * (1 << np.arange(32, dtype=np.uint64))).sum(-1).astype(
        np.uint32)
    want = jvoc.train_vocabulary(desc, n_words=n_words, n_iters=iters)
    got = tvoc.train_vocabulary(desc.view(np.int32), n_words=n_words,
                                n_iters=iters)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_unregistered_codebook_is_the_reference_random_one():
    saved = dict(jvoc._trained_signs), dict(tvoc._trained_signs)
    jvoc._trained_signs.clear()
    tvoc._trained_signs.clear()
    tvoc.get_codebook_signs.cache_clear()
    tvoc._codebook.cache_clear()
    try:
        for W in (512, 4096):
            np.testing.assert_array_equal(tvoc.get_codebook_signs(W),
                                          jvoc.get_codebook_signs(W))
        shipped = np.load(os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "dr_slam_torch", "data", "vocab512.npz"))["words"]
        assert not np.array_equal(tvoc.get_codebook_signs(512),
                                  tvoc.words_to_signs(shipped))
    finally:
        for reg, old in zip((jvoc._trained_signs, tvoc._trained_signs),
                            saved):
            reg.clear()
            reg.update(old)
        tvoc.get_codebook_signs.cache_clear()
        tvoc._codebook.cache_clear()
