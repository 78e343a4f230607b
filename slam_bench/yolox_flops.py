"""The yardstick of the detector's network: YOLOX's floating-point
operations per image, counted from the published layout, and the H100's
float32 peak they are held against.

Layout: Megvii's YOLOX (Ge et al., arXiv:2107.08430; `yolox/models/
darknet.py`, `yolo_pafpn.py`, `yolo_head.py`), YOLOX-s at depth 0.33 and
width 0.50 with the 80 COCO classes. Each convolution counts
2 * k^2 * c_in * c_out * H_out * W_out (a multiply and an add per weight
and output; biases, activations, pools and the decode are left out). The
graph and its output sizes are `yolox_reference.py`'s, run on tensors with
shapes and no data, so the count follows the reference's padding and
strides. At 640 x 640 it reads 26.69e9, against the paper's 26.8 G.

Peak: NVIDIA's H100 SXM data sheet, float32 (not TF32, which the program
keeps off) at 67 TFLOP/s."""

from __future__ import annotations

import functools

H100_FP32_FLOPS_PER_S = 67e12
COCO_CLASSES = 80


def layout(depth_mul: float = 0.33, width_mul: float = 0.50,
           classes: int = COCO_CLASSES) -> dict:
    """{convolution name: (c_out, c_in, k)} of YOLOX at these multipliers,
    under the names `yolox_reference.py` reads."""
    from slam_bench.yolox_reference import _depths

    w = [int(c * width_mul) for c in (64, 128, 256, 512, 1024)]
    n2, n3, n4, n5, nf = _depths(depth_mul)
    convs = {}

    def conv(name, c_in, c_out, k=1):
        convs[name] = (c_out, c_in, k)

    def csp(name, c_in, c_out, n):
        conv(name + "_main", c_in, c_out // 2)
        conv(name + "_short", c_in, c_out // 2)
        conv(name + "_final", c_out, c_out)
        for i in range(n):
            conv(f"{name}_b{i}_1", c_out // 2, c_out // 2)
            conv(f"{name}_b{i}_2", c_out // 2, c_out // 2, 3)

    conv("stem", 12, w[0], 3)              # Focus: 4 pixel phases x 3
    for i, n in enumerate((n2, n3, n4), 1):
        conv(f"down{i}", w[i - 1], w[i], 3)
        csp(f"csp{i}", w[i], w[i], n)
    conv("down4", w[3], w[4], 3)
    conv("spp_pre", w[4], w[4] // 2)
    conv("spp_post", w[4] // 2 * 4, w[4])
    csp("csp4", w[4], w[4], n5)
    conv("lat2", w[4], w[3])
    csp("fpn2", 2 * w[3], w[3], nf)
    conv("lat1", w[3], w[2])
    csp("fpn1", 2 * w[2], w[2], nf)
    conv("pan1", w[2], w[2], 3)
    csp("pan1c", 2 * w[2], w[3], nf)
    conv("pan2", w[3], w[3], 3)
    csp("pan2c", 2 * w[3], w[4], nf)
    for lvl, c in enumerate(w[2:]):
        conv(f"head{lvl}_stem", c, w[2])
        for branch in ("cls1", "cls2", "reg1", "reg2"):
            conv(f"head{lvl}_{branch}", w[2], w[2], 3)
        conv(f"head{lvl}_cls", w[2], classes)
        conv(f"head{lvl}_reg", w[2], 4)
        conv(f"head{lvl}_obj", w[2], 1)
    return convs


@functools.lru_cache(maxsize=None)
def flops(input_size: int = 640, depth_mul: float = 0.33,
          width_mul: float = 0.50) -> int:
    """The network's floating-point operations on one input_size^2 image."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from slam_bench import yolox_reference

    sd = {}
    for name, (c_out, c_in, k) in layout(depth_mul, width_mul).items():
        sd[f"convs.{name}.weight"] = torch.empty(c_out, c_in, k, k,
                                                 device="meta")
        sd[f"convs.{name}.bias"] = torch.empty(c_out, device="meta")
    img = torch.empty(1, 3, input_size, input_size, device="meta")
    with FlopCounterMode(display=False) as counter:
        yolox_reference.heads(sd, img, depth_mul)
    return counter.get_total_flops()
