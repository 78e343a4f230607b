"""Full-size parity of the port's dataset runner and streaming node: phase 9
of chip_smoke.py on the CPU. The 24 frames of
dr_slam_torch/data/mapping_corridor.npz (640x480, the tum_freiburg3
preset) are exported as a TUM sequence and decoded back exactly by the
Pillow reader and the native loader; scripts/run_tum_torch.py runs over
them through the native loader and a `SlamServer` serves frames 0-11 to a
`CameraClient`, against the JAX runner and node in
dr_slam_torch/data/tum_corridor.npz (made by
scripts/make_torch_tum_fixture.py), under the bounds phase 9 holds the
card to (`tracker_gaps`, `node_gaps`, `MESH_TOL`). The shipped codebooks
are registered, as in the JAX runs. Observed on the CPU: states,
keyframes and reference keyframes exact, |dT_cw| 1.0e-3, counts within 1,
the ATE equal (0.0019 m), the mesh's counts equal; node positions within
2.0e-4, 10 of 299 occupancy cells differing. Skips where the native loader
cannot be built (g++, zlib)."""

import pytest
import torch

import chip_smoke
from dr_slam_torch._smoke import load_tum_fixture, shipped_codebooks
from dr_slam_torch.config import tum_freiburg3
from dr_slam_torch.io.native_loader import build_native

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def phase():
    if not build_native():
        pytest.skip("the native loader cannot be built here (g++, zlib)")
    with shipped_codebooks():
        yield chip_smoke.tum_phase(torch.device("cpu"), tum_freiburg3(),
                                   "cpu")


def test_runner_and_node_match_the_jax_runs(phase):
    launches, numbers = phase
    assert launches == {"runner": 0, "node": 0}   # the CPU takes no kernel
    data = load_tum_fixture()
    assert numbers["mesh"][0] > 1000 and numbers["mesh"][1] > 1000
    assert abs(numbers["mesh"][0] - int(data["mesh__n_verts"])) <= \
        chip_smoke.MESH_TOL * int(data["mesh__n_verts"])
    assert numbers["runner_fps"] > 0 and numbers["node_ms"] > 0
