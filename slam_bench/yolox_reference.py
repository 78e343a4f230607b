"""Plain reference of YOLOX-s: the forward pass and the grid decode in plain
`torch.nn.functional`, in float32 with TF32 off, for holding the program's
detector to. It imports nothing of the program and nothing of JAX.

It follows Megvii's published YOLOX (Ge et al., arXiv:2107.08430;
`yolox/models/darknet.py` CSPDarknet, `yolo_pafpn.py` YOLOPAFPN,
`yolo_head.py` YOLOXHead, `exps/default/yolox_s.py`: depth 0.33, width
0.50): a Focus stem, CSPDarknet with CSP layers and the SPP bottleneck in
dark5, the PAFPN, and a decoupled head per stride (8, 16, 32), SiLU after
every convolution but the three 1x1 predictions. Where the weights it is
given depart from Megvii's module, so does it:

- BatchNorm is folded into each convolution: every convolution carries a
  bias and no normalisation follows it.
- The Focus stem's 12 channels are the four pixel phases (top left, bottom
  left, top right, bottom right) each with its 3 colours, the order of the
  JAX layout's stem weights; it is also Megvii's `Focus` order.
- Padding is XLA's "SAME": a stride-2 convolution over an even extent pads
  0 before and 1 after, where Megvii pads k // 2 on both sides (stride-1
  convolutions pad k // 2 on both sides in both).
- The image is scaled to [0, 1] before the stem.
- The decode clamps the log width and height to [-10, 6] before `exp`.

Weights come as a state dict `{"convs.<name>.weight": (O, I, k, k),
"convs.<name>.bias": (O,)}`, the names those of the JAX layout with "." as
"_" (`stem`, `down1`, `csp1_main`, `csp1_b0_2`, `spp_pre`, `lat2`,
`head0_cls`, ...)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

STRIDES = (8, 16, 32)


def _depths(depth_mul: float) -> tuple:
    """CSP repeats: dark2, dark3, dark4, dark5 and each PAFPN merge."""
    base = max(round(3 * depth_mul), 1)
    return base, base * 3, base * 3, base, round(3 * depth_mul)


class _Net:
    def __init__(self, sd: dict, depth_mul: float):
        self.sd = sd
        self.n = _depths(depth_mul)

    def conv(self, x, name: str, stride: int = 1, act: bool = True):
        w = self.sd[f"convs.{name}.weight"]
        b = self.sd[f"convs.{name}.bias"]
        k = w.shape[-1]
        if stride == 1:
            x = F.pad(x, (k // 2,) * 4)
        else:
            pads = []
            for n in (x.shape[-1], x.shape[-2]):
                total = max((-(-n // stride) - 1) * stride + k - n, 0)
                pads += [total // 2, total - total // 2]
            x = F.pad(x, pads)
        y = F.conv2d(x, w, b, stride)
        return y * torch.sigmoid(y) if act else y

    def csp(self, x, name: str, n: int, shortcut: bool):
        a = self.conv(x, name + "_main")
        for i in range(n):
            h = self.conv(self.conv(a, f"{name}_b{i}_1"), f"{name}_b{i}_2")
            a = a + h if shortcut else h
        return self.conv(torch.cat([a, self.conv(x, name + "_short")], 1),
                         name + "_final")

    def forward(self, img):
        n2, n3, n4, n5, nf = self.n
        x = torch.cat([img[..., ::2, ::2], img[..., 1::2, ::2],
                       img[..., ::2, 1::2], img[..., 1::2, 1::2]], 1)
        x = self.conv(x, "stem")
        x = self.csp(self.conv(x, "down1", 2), "csp1", n2, True)
        d3 = self.csp(self.conv(x, "down2", 2), "csp2", n3, True)
        d4 = self.csp(self.conv(d3, "down3", 2), "csp3", n4, True)
        x = self.conv(self.conv(d4, "down4", 2), "spp_pre")
        x = torch.cat([x] + [F.max_pool2d(x, k, 1, k // 2)
                             for k in (5, 9, 13)], 1)
        d5 = self.csp(self.conv(x, "spp_post"), "csp4", n5, False)

        up = lambda t: t.repeat_interleave(2, -2).repeat_interleave(2, -1)
        fpn0 = self.conv(d5, "lat2")
        f = self.csp(torch.cat([up(fpn0), d4], 1), "fpn2", nf, False)
        fpn1 = self.conv(f, "lat1")
        pan2 = self.csp(torch.cat([up(fpn1), d3], 1), "fpn1", nf, False)
        pan1 = self.csp(torch.cat([self.conv(pan2, "pan1", 2), fpn1], 1),
                        "pan1c", nf, False)
        pan0 = self.csp(torch.cat([self.conv(pan1, "pan2", 2), fpn0], 1),
                        "pan2c", nf, False)
        outs = []
        for lvl, feat in enumerate((pan2, pan1, pan0)):
            h = self.conv(feat, f"head{lvl}_stem")
            c = self.conv(self.conv(h, f"head{lvl}_cls1"), f"head{lvl}_cls2")
            r = self.conv(self.conv(h, f"head{lvl}_reg1"), f"head{lvl}_reg2")
            outs.append((self.conv(r, f"head{lvl}_reg", act=False),
                         self.conv(r, f"head{lvl}_obj", act=False),
                         self.conv(c, f"head{lvl}_cls", act=False)))
        return outs


def heads(sd: dict, img: torch.Tensor, depth_mul: float = 0.33) -> list:
    """img (1, 3, s, s) in [0, 255], s a multiple of 32 -> per stride the
    head tensors (reg (1, 4, h, w), obj (1, 1, h, w), cls (1, C, h, w))."""
    return _Net(sd, depth_mul).forward(img / 255.0)


def decode(outs: list) -> torch.Tensor:
    """The head tensors -> (M, 6) rows x1, y1, x2, y2, score, class: per
    stride, cells in row-major order (Megvii's flatten); centre (reg + cell)
    * stride, size exp(clamp(reg, -10, 6)) * stride, score objectness times
    the best class probability."""
    rows = []
    for (reg, obj, cls), stride in zip(outs, STRIDES):
        _, _, h, w = reg.shape
        reg = reg[0].flatten(1).T
        ys, xs = torch.meshgrid(torch.arange(h, device=reg.device),
                                torch.arange(w, device=reg.device),
                                indexing="ij")
        grid = torch.stack([xs, ys], -1).reshape(-1, 2).to(reg.dtype)
        centre = (reg[:, :2] + grid) * stride
        size = torch.exp(reg[:, 2:4].clamp(-10, 6)) * stride
        p = torch.sigmoid(cls[0].flatten(1).T)
        best, label = p.max(1)
        score = torch.sigmoid(obj[0, 0].flatten()) * best
        rows.append(torch.cat([centre - size / 2, centre + size / 2,
                               score[:, None], label[:, None].to(reg.dtype)],
                              1))
    return torch.cat(rows, 0)
