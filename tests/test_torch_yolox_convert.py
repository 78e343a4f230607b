"""The port's YOLOX checkpoint converter (dr_slam_torch/models/
yolox_convert.py, scripts/convert_yolox_torch.py) against the JAX
package's on the CPU: BatchNorm folding against torch's own BatchNorm, the
converted arrays key for key and bit for bit, the wrong-scale KeyError,
and the script on a `torch.save`d checkpoint. No checkpoint is downloaded:
the official module layout is tests/test_yolox_convert.py's synthetic
YOLOX-s state dict."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dr_slam_tpu.models import yolox as jy
from dr_slam_tpu.models import yolox_convert as jconv
from dr_slam_torch.models import yolox as ty
from dr_slam_torch.models import yolox_convert as tconv
from test_yolox_convert import _official_state_dict
from torch_parity import load_script

torch.set_num_threads(2)


def _assert_params_equal(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    assert a["meta"] == b["meta"]
    for k in a:
        if k != "meta":
            for leaf in ("w", "b"):
                assert a[k][leaf].dtype == b[k][leaf].dtype, (k, leaf)
                assert a[k][leaf].tobytes() == b[k][leaf].tobytes(), (k, leaf)


def test_fold_conv_bn_matches_torch_batchnorm():
    """conv (no bias) + BatchNorm + SiLU in torch == the folded conv + bias
    + SiLU through the port's network convolution (within 2e-5)."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(1, 6, 10, 12).astype(np.float32))
    w = (rng.randn(8, 6, 3, 3) * 0.2).astype(np.float32)
    gamma = rng.rand(8).astype(np.float32) + 0.5
    beta = rng.randn(8).astype(np.float32)
    mean = rng.randn(8).astype(np.float32)
    var = rng.rand(8).astype(np.float32) + 0.1
    bn = torch.nn.BatchNorm2d(8, eps=1e-3).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
        bn.running_mean.copy_(torch.from_numpy(mean))
        bn.running_var.copy_(torch.from_numpy(var))
        want = F.silu(bn(F.conv2d(x, torch.from_numpy(w), padding=1)))
    prm = tconv.fold_conv_bn(w, gamma, beta, mean, var)
    _assert_params_equal({"meta": {}, "c": jconv.fold_conv_bn(
        w, gamma, beta, mean, var)}, {"meta": {}, "c": prm})
    ow = torch.from_numpy(np.ascontiguousarray(prm["w"].transpose(3, 2, 0, 1)))
    got = F.silu(F.conv2d(x, ow, torch.from_numpy(prm["b"]), padding=1))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-5)


def test_convert_state_dict_matches_jax():
    sd = _official_state_dict()
    got = tconv.convert_state_dict(sd)
    _assert_params_equal(jconv.convert_state_dict(sd), got)
    # the layout is init_params'; the converted model runs in the port
    init = ty.init_params()
    assert set(got) == set(init)
    for k in init:
        if k != "meta":
            assert got[k]["w"].shape == init[k]["w"].shape, k
    net = ty.YOLOXNet(got["meta"])
    net.load_state_dict(ty.params_to_state_dict(got))
    outs = net.requires_grad_(False)(torch.rand(1, 3, 64, 64))
    assert all(torch.isfinite(t).all() for lvl in outs for t in lvl)


def test_convert_rejects_wrong_scale():
    sd = {k: v for k, v in _official_state_dict().items()
          if not k.startswith("backbone.backbone.dark5")}
    with pytest.raises(KeyError, match="wrong model scale"):
        tconv.convert_state_dict(sd)


def test_convert_script_on_a_saved_checkpoint(tmp_path):
    """scripts/convert_yolox_torch.py on an official-style {'model': sd}
    .pth (read with weights_only=True), with the optimizer state beside it:
    the .npz loads in both packages to the same arrays, equal to what the
    JAX script writes from the same file."""
    sd = _official_state_dict(seed=3)
    pth = tmp_path / "yolox_s.pth"
    torch.save({"model": sd, "start_epoch": 300,
                "optimizer": {"state": {}, "param_groups": []}}, pth)
    out = tmp_path / "port.npz"
    load_script("convert_yolox_torch").main([str(pth), str(out)])
    ref = tmp_path / "jax.npz"
    jconv.convert_checkpoint(str(pth), str(ref))
    want = jy.load_params(str(ref))
    _assert_params_equal(want, ty.load_params(str(out)))
    _assert_params_equal(want, jy.load_params(str(out)))
    _assert_params_equal(want, tconv.convert_state_dict(sd))
