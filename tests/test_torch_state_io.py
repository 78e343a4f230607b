"""Parity of the port's map state, map interchange and vocabulary
(dr_slam_torch/slam/state.py, io/map_io.py, associate/vocabulary.py) with
the JAX package.

Every field must round-trip bit for bit in both directions: the JAX
package's uint32 descriptor words are the port's int32 words with the same
bits, and everything else keeps its dtype and value. Word ids are integers
and must match exactly."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dr_slam_tpu.associate import vocabulary as jvoc
from dr_slam_tpu.config import (CameraConfig, LineConfig, MapConfig, ORBConfig,
                                SlamConfig)
from dr_slam_tpu.io import map_io as jio
from dr_slam_tpu.io.synthetic import synthetic_map_state
from dr_slam_tpu.slam.state import make_empty_state as jempty
from dr_slam_torch import config as tconfig
from dr_slam_torch.associate import vocabulary as tvoc
from dr_slam_torch.io import map_io as tio
from dr_slam_torch.slam.state import MapState, make_empty_state as tempty

from torch_parity import shipped_codebooks

torch.set_num_threads(2)

_PACKED = ("pt_desc", "pt_desc_ring", "kf_desc", "ln_desc")


def small_cfgs():
    kw = dict(
        camera=dict(fx=267.7, fy=269.6, cx=160.0, cy=120.0, width=320,
                    height=240, bf=20.0),
        orb=dict(n_features=400, n_levels=4, max_keypoints=256),
        line=dict(max_lines=16),
        map=dict(max_points=2048, max_lines=64, max_planes=8,
                 max_keyframes=16, vocab_words=512))
    j = SlamConfig(camera=CameraConfig(**kw["camera"]), orb=ORBConfig(**kw["orb"]),
                   line=LineConfig(**kw["line"]), map=MapConfig(**kw["map"]))
    t = tconfig.SlamConfig(
        camera=tconfig.CameraConfig(**kw["camera"]),
        orb=tconfig.ORBConfig(**kw["orb"]), line=tconfig.LineConfig(**kw["line"]),
        map=tconfig.MapConfig(**kw["map"]))
    return j, t


def as_numpy(field, v):
    a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return a.view(np.uint32) if field in _PACKED and a.dtype == np.int32 else a


def assert_same_state(port: MapState, ref):
    assert port._fields == ref._fields
    for f in ref._fields:
        a, b = as_numpy(f, getattr(port, f)), np.asarray(getattr(ref, f))
        assert a.shape == b.shape, f
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.fixture
def system_vocabulary():
    """The shipped codebooks registered in both packages as their `System`s
    register them."""
    with shipped_codebooks():
        yield


@pytest.fixture(scope="module")
def jax_map():
    jcfg, tcfg = small_cfgs()
    st, _ = synthetic_map_state(jcfg, n_kfs=12, seed=3)
    rng = np.random.RandomState(0)
    NP = jcfg.map.max_points
    # descriptor words with the top bit set exercise the uint32 -> int32 view
    st = st._replace(
        pt_desc=jnp.asarray(rng.randint(0, 2 ** 32, (NP, 8), dtype=np.uint32)),
        kf_word=jnp.asarray(rng.randint(0, 512, st.kf_word.shape), jnp.int32))
    return jcfg, tcfg, st


def test_empty_state_matches_jax():
    jcfg, tcfg = small_cfgs()
    assert_same_state(tempty(tcfg, device="cpu"), jempty(jcfg))


def test_from_jax_state_is_exact(jax_map):
    _, _, st = jax_map
    port = tio.from_jax_state({k: np.asarray(v) for k, v in st._asdict().items()},
                              "cpu")
    assert port.pt_desc.dtype == torch.int32
    assert bool((port.pt_desc < 0).any())          # top bits carried
    assert_same_state(port, st)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_npz_round_trip_both_ways(jax_map, tmp_path, direction):
    jcfg, tcfg, st = jax_map
    path = str(tmp_path / "map.npz")
    if direction == "jax_to_port":
        jio.save_map(path, st)
        assert_same_state(tio.load_map(path, tcfg, device="cpu"), st)
    else:
        port = tio.from_jax_state(
            {k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
        tio.save_map(path, port)
        with np.load(path) as data:
            assert data["pt_desc"].dtype == np.uint32
        assert_same_state(port, jio.load_map(path, jcfg))


def test_load_map_fills_fields_of_older_maps(jax_map, tmp_path,
                                             system_vocabulary):
    """Maps saved before the observation ring, the word-id cache and the
    scale bounds existed load the same way in both packages."""
    jcfg, tcfg, st = jax_map
    path = str(tmp_path / "old.npz")
    old = {k: np.asarray(v) for k, v in st._asdict().items()
           if k not in ("pt_desc_ring", "kf_word", "pt_dist_min", "pt_dist_max")}
    np.savez_compressed(path, **old)
    assert_same_state(tio.load_map(path, tcfg, device="cpu"),
                      jio.load_map(path, jcfg))


def test_load_map_rejects_other_capacity(jax_map, tmp_path):
    jcfg, tcfg, st = jax_map
    path = str(tmp_path / "map.npz")
    jio.save_map(path, st)
    bigger = tcfg.replace(map=tconfig.MapConfig(max_points=4096, max_lines=64,
                                                max_planes=8, max_keyframes=16,
                                                vocab_words=512))
    with pytest.raises(ValueError, match="pt_pos"):
        tio.load_map(path, bigger, device="cpu")


# --- vocabulary ---------------------------------------------------------------

def test_shipped_vocabularies_are_byte_identical():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("vocab.npz", "vocab512.npz"):
        with open(os.path.join(root, "dr_slam_tpu", "data", name), "rb") as a, \
                open(os.path.join(root, "dr_slam_torch", "data", name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("n_words", [512, 4096, 64])
def test_word_ids_match_jax(n_words, system_vocabulary):
    """512 and 4096 words use the shipped codebooks; 64 words falls back to
    the seeded random codebook in both packages."""
    np.testing.assert_array_equal(tvoc.get_codebook_signs(n_words),
                                  np.asarray(jvoc.get_codebook_signs(n_words),
                                             np.float32))
    rng = np.random.RandomState(n_words)
    desc = rng.randint(0, 2 ** 32, (300, 8), dtype=np.uint32)
    ref = np.asarray(jvoc.word_ids(jnp.asarray(desc), n_words))
    out = tvoc.word_ids(torch.from_numpy(desc.view(np.int32)), n_words)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)
