"""The port's configuration (dr_slam_torch/config.py) against the JAX
package's: the seven dataset presets field for field, the spot values of
tests/test_io.py, and reference-YAML loading."""

import dataclasses

import pytest

from dr_slam_tpu import config as J
from dr_slam_torch import config as T

PRESETS = ("tum_freiburg1", "tum_freiburg2", "tum_freiburg3", "icl_nuim",
           "tamu", "realsense", "tartanair")


def _jax_groups(port: T.SlamConfig) -> dict:
    """The port's configuration as a dict without its `detector` group,
    which the JAX package's has not (and which no preset here sets)."""
    assert port.detector is None
    out = dataclasses.asdict(port)
    del out["detector"]
    return out


@pytest.mark.parametrize("name", PRESETS)
def test_preset_equals_the_jax_one(name):
    port, ref = getattr(T, name)(), getattr(J, name)()
    assert _jax_groups(port) == dataclasses.asdict(ref)
    assert port.camera.width == 640 and port.camera.height == 480
    assert port.camera.fps == 30.0 and port.camera.depth_factor > 0


def test_preset_spot_values():
    """tests/test_io.py's values against the reference YAMLs; the three
    distorted cameras carry their coefficients."""
    assert T.tum_freiburg1().camera.k1 == 0.262383
    assert T.tum_freiburg2().camera.depth_factor == 5208.0
    assert T.realsense().camera.depth_factor == 1000.0
    assert T.tartanair().camera.fx == 320.0
    for name in ("tum_freiburg1", "tum_freiburg2", "realsense"):
        cam = getattr(T, name)().camera
        assert all(v != 0.0 for v in (cam.k1, cam.k2, cam.p1, cam.p2)), name
    for name in ("tum_freiburg3", "icl_nuim", "tamu", "tartanair"):
        cam = getattr(T, name)().camera
        assert (cam.k1, cam.k2, cam.p1, cam.p2, cam.k3) == (0.0,) * 5, name


def test_yaml_loading_matches(tmp_path):
    text = ("%YAML:1.0\nCamera.fx: 500.0\nCamera.k1: 0.1\nDepthMapFactor: 1000"
            "\nORBextractor.nLevels: 4\nPlane.AngleInfo: 1.0\n"
            "SavePath.path: out\n")
    path = tmp_path / "cam.yaml"
    path.write_text(text)
    port, ref = T.load_config(str(path)), J.load_config(str(path))
    assert _jax_groups(port) == dataclasses.asdict(ref)
    assert port.camera.fx == 500.0 and port.save_path == "out"
