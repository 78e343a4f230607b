"""Convert official YOLOX torch checkpoints into the detector's .npz layout.

Counterpart of the JAX package's `models/yolox_convert.py` (the reference's
engine-building step: it consumes a TensorRT engine serialized from the
official YOLOX weights, include/YOLOX.h:54, hard-required at startup,
src/System.cc:88). The official .pth checkpoint (Megvii-BaseDetection/YOLOX
releases, e.g. yolox_s.pth) is converted once into an .npz in the layout of
`models/yolox.py:init_params`, HWIO weights with every BatchNorm folded into
its convolution, so inference runs conv + bias + SiLU. The layout is the JAX
package's, so a converted checkpoint loads in both packages.

Mapping (official module path -> param key):
  backbone.backbone.stem.conv            -> stem        (Focus conv)
  backbone.backbone.dark{k}.0            -> down{k-1}
  backbone.backbone.dark{2,3,4}.1        -> csp{1,2,3}  (CSPLayer)
  backbone.backbone.dark5.1.conv{1,2}    -> spp.pre / spp.post
  backbone.backbone.dark5.2              -> csp4
  backbone.lateral_conv0 / reduce_conv1  -> lat2 / lat1
  backbone.C3_p4 / C3_p3 / C3_n3 / C3_n4 -> fpn2 / fpn1 / pan1c / pan2c
  backbone.bu_conv2 / bu_conv1           -> pan1 / pan2
  head.stems.{l}                         -> head{l}.stem
  head.{cls,reg}_convs.{l}.{0,1}         -> head{l}.{cls,reg}{1,2}
  head.{cls,reg,obj}_preds.{l}           -> head{l}.{cls,reg,obj}  (plain conv)
CSPLayer internals: conv1 -> .main, conv2 -> .short, conv3 -> .final,
m.{i}.conv{1,2} -> .b{i}.{1,2}.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

BN_EPS = 1e-3  # official BaseConv: nn.BatchNorm2d(out, eps=1e-3, momentum=0.03)


def fold_conv_bn(w_oihw: np.ndarray, gamma, beta, mean, var,
                 eps: float = BN_EPS) -> dict:
    """conv(no bias) + BN -> conv(w', b') with w' in HWIO.

    y = gamma * (conv(x, w) - mean) / sqrt(var + eps) + beta
      = conv(x, w * s) + (beta - mean * s),  s = gamma / sqrt(var + eps)
    """
    w = np.asarray(w_oihw, np.float32)
    s = np.asarray(gamma, np.float32) / np.sqrt(
        np.asarray(var, np.float32) + eps)
    w = w * s[:, None, None, None]
    b = np.asarray(beta, np.float32) - np.asarray(mean, np.float32) * s
    return {"w": np.transpose(w, (2, 3, 1, 0)), "b": b}  # OIHW -> HWIO


def plain_conv(w_oihw: np.ndarray, bias: np.ndarray) -> dict:
    return {"w": np.transpose(np.asarray(w_oihw, np.float32), (2, 3, 1, 0)),
            "b": np.asarray(bias, np.float32)}


def _base_conv_map(depth_mul: float) -> tuple[dict, dict]:
    """(BaseConv module path -> jnp key, CSPLayer module path -> jnp name)."""
    base = {
        "backbone.backbone.stem.conv": "stem",
        "backbone.backbone.dark2.0": "down1",
        "backbone.backbone.dark3.0": "down2",
        "backbone.backbone.dark4.0": "down3",
        "backbone.backbone.dark5.0": "down4",
        "backbone.backbone.dark5.1.conv1": "spp.pre",
        "backbone.backbone.dark5.1.conv2": "spp.post",
        "backbone.lateral_conv0": "lat2",
        "backbone.reduce_conv1": "lat1",
        "backbone.bu_conv2": "pan1",
        "backbone.bu_conv1": "pan2",
    }
    csp = {
        "backbone.backbone.dark2.1": "csp1",
        "backbone.backbone.dark3.1": "csp2",
        "backbone.backbone.dark4.1": "csp3",
        "backbone.backbone.dark5.2": "csp4",
        "backbone.C3_p4": "fpn2",
        "backbone.C3_p3": "fpn1",
        "backbone.C3_n3": "pan1c",
        "backbone.C3_n4": "pan2c",
    }
    for lvl in range(3):
        base[f"head.stems.{lvl}"] = f"head{lvl}.stem"
        base[f"head.cls_convs.{lvl}.0"] = f"head{lvl}.cls1"
        base[f"head.cls_convs.{lvl}.1"] = f"head{lvl}.cls2"
        base[f"head.reg_convs.{lvl}.0"] = f"head{lvl}.reg1"
        base[f"head.reg_convs.{lvl}.1"] = f"head{lvl}.reg2"
    return base, csp


def convert_state_dict(sd: dict, depth_mul: float = 0.33,
                       width_mul: float = 0.50) -> dict:
    """Official YOLOX state_dict (torch tensors or numpy arrays, with or
    without a leading 'model.' prefix) -> params dict for models/yolox.py
    (the same arrays, bit for bit, as the JAX package's converter)."""
    def npy(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") \
            else np.asarray(t)

    sd = {k[len("model."):] if k.startswith("model.") else k: v
          for k, v in sd.items()}
    base_map, csp_map = _base_conv_map(depth_mul)
    # CSPLayer internals share the BaseConv pattern; expand them in place
    d = lambda n: max(int(round(n * depth_mul)), 1)
    csp_depths = {"csp1": d(3), "csp2": d(9), "csp3": d(9), "csp4": d(3),
                  "fpn2": d(3), "fpn1": d(3), "pan1c": d(3), "pan2c": d(3)}
    for mod, name in csp_map.items():
        base_map[f"{mod}.conv1"] = f"{name}.main"
        base_map[f"{mod}.conv2"] = f"{name}.short"
        base_map[f"{mod}.conv3"] = f"{name}.final"
        for i in range(csp_depths[name]):
            base_map[f"{mod}.m.{i}.conv1"] = f"{name}.b{i}.1"
            base_map[f"{mod}.m.{i}.conv2"] = f"{name}.b{i}.2"

    out: dict = {}
    used = set()
    missing = []
    for mod, key in base_map.items():
        names = [f"{mod}.conv.weight", f"{mod}.bn.weight", f"{mod}.bn.bias",
                 f"{mod}.bn.running_mean", f"{mod}.bn.running_var"]
        if names[0] not in sd:
            missing.append(mod)
            continue
        out[key] = fold_conv_bn(npy(sd[names[0]]), npy(sd[names[1]]),
                                npy(sd[names[2]]), npy(sd[names[3]]),
                                npy(sd[names[4]]))
        used.update(names)
    for lvl in range(3):
        for kind in ("cls", "reg", "obj"):
            wk = f"head.{kind}_preds.{lvl}.weight"
            bk = f"head.{kind}_preds.{lvl}.bias"
            if wk not in sd:
                missing.append(wk)
                continue
            out[f"head{lvl}.{kind}"] = plain_conv(npy(sd[wk]), npy(sd[bk]))
            used.update([wk, bk])
    if missing:
        raise KeyError(f"checkpoint is missing {len(missing)} expected "
                       f"modules, e.g. {missing[:4]} -- wrong model scale "
                       f"(expected depth={depth_mul}, width={width_mul}) "
                       f"or not a YOLOX checkpoint")

    wfn = lambda c: max(int(round(c * width_mul)), 8)
    out["meta"] = {
        "widths": [wfn(64), wfn(128), wfn(256), wfn(512), wfn(1024)],
        "depths": [d(3), d(9), d(9), d(3)],
    }
    leftovers = {k for k in sd
                 if k not in used and "num_batches_tracked" not in k}
    if leftovers:
        warnings.warn(f"{len(leftovers)} checkpoint tensors unused "
                      f"(EMA/optimizer state is expected here): "
                      f"{sorted(leftovers)[:4]}...")
    return out


def convert_checkpoint(pth_path: str, out_npz: str,
                       depth_mul: float = 0.33,
                       width_mul: float = 0.50) -> dict:
    """yolox_{s,m,l,...}.pth -> .npz loadable by `models/yolox.py:
    load_params` of either package. Official release checkpoints wrap the
    weights as {'model': state_dict}; the file is read with
    `weights_only=True`, so it cannot run code."""
    ckpt = torch.load(pth_path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt) if isinstance(ckpt, dict) else ckpt
    params = convert_state_dict(sd, depth_mul, width_mul)
    flat = {}
    for k, v in params.items():
        if k == "meta":
            flat["meta"] = np.asarray(v, dtype=object)
        else:
            flat[k] = np.asarray(v, dtype=object)
    np.savez(out_npz, **flat)
    return params
