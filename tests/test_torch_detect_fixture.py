"""Full-size parity of the port's detector, cylinders and viewers: phase 10
of chip_smoke.py on the CPU. `System(tum_freiburg3(), detector=YOLOX(
input_size=640), live_viewer=True)` (YOLOX-s, the seeded random init) over
the 24 frames of dr_slam_torch/data/mapping_corridor.npz, the shipped
trained detector at 256 over six synthetic scenes and a cylinder depth map
at 640x480, against the JAX runs in dr_slam_torch/data/detect_corridor.npz
(made by scripts/make_torch_detect_fixture.py), under the bounds phase 10
holds the card to (`tracker_gaps`, `CAND_TOL`, the JAX test's gate and IoU
> 0.9, `CYL_TOL`, the cylinders' integer outputs exact); then the live
viewer's /state.json and /map.png and the two renders."""

import json

import numpy as np
import torch

import chip_smoke
from dr_slam_torch._smoke import load_detect_fixture
from dr_slam_torch.config import tum_freiburg3

torch.set_num_threads(2)


def test_phase_10_matches_the_jax_runs(capsys):
    launches, numbers = chip_smoke.detect_phase(torch.device("cpu"),
                                                tum_freiburg3(), "cpu")
    assert launches == 0          # the CPU takes the matcher's plain version
    assert numbers["max_abs_err"] == 0.0
    assert numbers["detect_ms"] > 0 and numbers["nms_host_ms"] > 0
    # 26.69 GFLOP at 67 TFLOP/s
    assert 0.35 < numbers["bound_ms"] < 0.45
    out = capsys.readouterr().out
    served = json.loads(out.split("[viewer] /state.json ")[1].split(";")[0])
    data = load_detect_fixture()
    assert served["frame"] == 24
    assert served["n_keyframes"] == int(data["run__n_kfs"])
    assert "render_map and draw_frame_overlay" in out
    assert np.asarray(data["det__frame"]).tolist() == [0, 11, 23]
