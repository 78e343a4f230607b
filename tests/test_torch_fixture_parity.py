"""Full-size parity of the port's front end and tracking step with the JAX
package: `extract_and_track` at 640x480 (the tum_freiburg3 preset) on the
four frames of the smoke fixture (dr_slam_torch/data/smoke_corridor.npz),
chained as chip_smoke.py chains them, on the CPU, against the JAX outputs
stored in the fixture.

The image pyramid was the one source of difference. The JAX package's
`build_pyramid` is jitted, and XLA compiles jax.image.resize's weights with
its own float32 rounding (division by the kernel scale rewritten as a
multiplication by its reciprocal, fused multiply-adds where LLVM vectorizes,
the column sums in 32-row windows) and sums each output of its two dots in
its own order. The port's resize now does the same (ops/image.py,
tests/test_torch_resize.py), so its levels are JAX's, bit for bit. These
tests pin that three ways: the port as it is matches the JAX outputs in every
slot; with the JAX package's pyramid swapped in, it still does; and both
pyramids lie within 1e-4 of a float64 evaluation of the same weights."""

import jax.numpy as jnp
import numpy as np
import torch

from dr_slam_tpu.ops import image as jimage
from dr_slam_torch._smoke import FIXTURE, load_fixture
from dr_slam_torch.config import tum_freiburg3
from dr_slam_torch.ops import image as timage
from dr_slam_torch.slam.track_step import extract_and_track

torch.set_num_threads(2)


def _track_fixture():
    """The four fixture frames through `extract_and_track` on the CPU, state
    chained from frame to frame; returns the outputs and the fixture data."""
    cfg = tum_freiburg3()
    fx = load_fixture("cpu")
    st, T, V, R = fx.state, fx.T_last, fx.velocity, fx.R_cm
    outs = []
    for g, d in fx.frames:
        _, out = extract_and_track(g, d, st, T, V, R, fx.ref_kf, cfg,
                                   device="cpu")
        st, T, V, R = out.new_map_state, out.T_cw, out.velocity, out.R_cm
        outs.append(out)
    return outs, fx.data


def _gaps(out, data, i):
    dT = float(np.abs(out.T_cw.numpy() - data["T_cw"][i]).max())
    mp_mism = int((out.mp_idx.numpy() != data["mp_idx"][i]).sum())
    return dT, mp_mism


def test_port_gap_to_jax_outputs_is_bounded():
    """The port as it is: every fixture frame matches the JAX outputs
    exactly in mp_idx, n_matches and n_inliers (before the port computed
    XLA's resize, 28/0/0/42 of 1024 slots differed and frame 0 was one
    match and one inlier off), and the pose within 1e-5 (observed 3.1e-7:
    float32 sums in another order in the pose solve)."""
    outs, data = _track_fixture()
    for i, out in enumerate(outs):
        dT, mp_mism = _gaps(out, data, i)
        assert mp_mism == 0, (i, mp_mism)
        assert int(out.n_matches) == int(data["n_matches"][i]), i
        assert int(out.n_inliers) == int(data["n_inliers"][i]), i
        assert dT <= 1e-5, (i, dT)


def test_gap_is_the_pyramid_alone(monkeypatch):
    """With the JAX package's jitted `build_pyramid` in place of the port's,
    every fixture frame matches the JAX outputs exactly in mp_idx,
    n_matches and n_inliers, and the pose within 1e-5 (observed 3.7e-7:
    float32 sums in another order in the pose solve)."""

    def jax_pyramid(img, n_levels=8, scale=1.2):
        levels = jimage.build_pyramid(jnp.asarray(img.numpy()),
                                      n_levels=n_levels, scale=scale)
        return tuple(torch.from_numpy(np.array(l)) for l in levels)

    monkeypatch.setattr(timage, "build_pyramid", jax_pyramid)
    outs, data = _track_fixture()
    for i, out in enumerate(outs):
        dT, mp_mism = _gaps(out, data, i)
        assert mp_mism == 0, (i, mp_mism)
        assert int(out.n_matches) == int(data["n_matches"][i]), i
        assert int(out.n_inliers) == int(data["n_inliers"][i]), i
        assert dT <= 1e-5, (i, dT)


def test_port_pyramid_matches_float64():
    """Each level of the port's pyramid on fixture frame 12 (640x480) is
    within 1e-4 grey levels of one resize step evaluated in float64 from
    the port's previous level with the same weight matrices (observed
    2.7e-5 at level 1, 3.0e-5 at most: float32 rounding of the two dots),
    and so is each
    level of the JAX package's jitted pyramid (before the port computed
    XLA's weights, JAX's level 1 lay 2.5e-3 from the float64 evaluation
    with the port's weights)."""
    with np.load(FIXTURE) as fx:
        gray = fx["gray"][0].astype(np.float32)

    def f64_gap(levels, l):
        prev = levels[l - 1].astype(np.float64)
        (h, w), (oh, ow) = prev.shape, levels[l].shape
        ref = (timage._resize_weights(h, oh).astype(np.float64).T @ prev
               @ timage._resize_weights(w, ow).astype(np.float64))
        return float(np.abs(levels[l] - ref).max())

    port = [x.numpy() for x in timage.build_pyramid(torch.from_numpy(gray),
                                                    8, 1.2)]
    assert port[0].shape == (480, 640)
    ref = [np.array(x) for x in jimage.build_pyramid(jnp.asarray(gray),
                                                     n_levels=8, scale=1.2)]
    for l in range(1, len(port)):
        assert f64_gap(port, l) <= 1e-4, (l, f64_gap(port, l))
        assert f64_gap(ref, l) <= 1e-4, (l, f64_gap(ref, l))
