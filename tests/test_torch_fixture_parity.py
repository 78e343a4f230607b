"""Full-size parity of the port's front end and tracking step with the JAX
package: `extract_and_track` at 640x480 (the tum_freiburg3 preset) on the
four frames of the smoke fixture (dr_slam_torch/data/smoke_corridor.npz),
chained as chip_smoke.py chains them, on the CPU, against the JAX outputs
stored in the fixture.

The one source of difference is the image pyramid. The JAX package's
`build_pyramid` is jitted, and inside that jit XLA computes the antialiased
resize weights with its own float32 rounding: its level 1 lies up to 2.5e-3
grey levels from a float64 evaluation of the same weights, where the port's
lies within 3e-5. No float32 ordering of the weight arithmetic reproduces
XLA's weights, so the port keeps its own (the more accurate ones), and these
tests pin the gap three ways: the port as it is stays within stated bounds;
with the JAX package's pyramid swapped in, the port matches exactly; and the
port's pyramid is within 1e-4 of float64."""

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
    """The port as it is. Tolerances, all from the reference's jitted
    pyramid weights (see the module docstring): pyramid levels differ in
    the last bits, which reorders keypoints whose FAST responses are
    near-tied, so a few match slots change (observed 28/0/0/42 of 1024,
    bound 64) and the counts move by one (bound 2%); the pose, solved from
    nearly the same matches, moves by float rounding carried through four
    chained frames (observed 1.5e-4, bound 1e-3)."""
    outs, data = _track_fixture()
    for i, out in enumerate(outs):
        dT, mp_mism = _gaps(out, data, i)
        nm, ni = int(out.n_matches), int(out.n_inliers)
        jm, ji = int(data["n_matches"][i]), int(data["n_inliers"][i])
        assert dT <= 1e-3, (i, dT)
        assert abs(nm - jm) <= 0.02 * jm, (i, nm, jm)
        assert abs(ni - ji) <= 0.02 * ji, (i, ni, ji)
        assert mp_mism <= 64, (i, mp_mism)


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
    2.6e-5 at level 1: float32 rounding of the two matmuls). The JAX
    package's jitted pyramid lies further from float64 at level 1 (observed
    2.5e-3): the port's is the more accurate of the two."""
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
    for l in range(1, len(port)):
        assert f64_gap(port, l) <= 1e-4, (l, f64_gap(port, l))
    ref = [np.array(x) for x in jimage.build_pyramid(jnp.asarray(gray),
                                                     n_levels=8, scale=1.2)]
    assert f64_gap(ref, 1) > 10 * f64_gap(port, 1)
