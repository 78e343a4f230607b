"""YOLOX object detector on PyTorch (the reference's Semanticer).

Counterpart of the JAX package's `models/yolox.py` (the reference's TensorRT
YOLOX, include/YOLOX.h, src/YOLOX.cpp:398): 640x640 input, CSPDarknet + SPP
+ PAFPN + decoupled heads with BatchNorm folded into each convolution and
SiLU activations, a per-stride grid decode and class-aware greedy NMS over
80 COCO classes. The detections feed the 2D overlay only
(FrameDrawer::DrawObjects, src/FrameDrawer.cc:219), never the pose math.

Weights load from an .npz checkpoint in the JAX package's layout (HWIO
`w`, `b` per convolution, and `meta`); `params_to_state_dict` carries them
into the module's OIHW state dict. Without a checkpoint the deterministic
random init (numpy `RandomState(0)`) builds the same weights as the JAX
package's.

Where XLA's "SAME" padding is asymmetric (a stride-2 convolution over an
even extent pads 0 before and 1 after), the pad is explicit: `conv2d`'s own
padding is symmetric and would shift every feature map by one pixel. Ties
in the top-k are broken toward the lower index (`lax.top_k`), and the
greedy NMS runs on the host after one readback of the 128 x 128
suppression matrix: 128 dependent steps, each a few operations, that on
the device would be several hundred launches. `YOLOX.launch` enqueues all
but that pass on a stream of its own, and `YOLOX.resolve` runs it later
(upstream's image and result queues)."""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dr_slam_torch import resolve_device
from dr_slam_torch.ops.image import bilinear_resize
from dr_slam_torch.ops.select import top_k
from dr_slam_torch.utils.profiling import PROFILER

COCO_CLASSES = 80
STRIDES = (8, 16, 32)
MAX_DET = 32


class Detections(NamedTuple):
    boxes: torch.Tensor    # (N, 4) x1, y1, x2, y2 in input pixels
    scores: torch.Tensor   # (N,)
    classes: torch.Tensor  # (N,) int32
    valid: torch.Tensor    # (N,) bool


def _layout(widths, depths) -> list:
    """[(name, c_in, c_out, k)] of every convolution, in the order the JAX
    package's `init_params` creates (and draws) them."""
    ws, ds = widths, depths
    convs = []

    def conv(name, c_in, c_out, k):
        convs.append((name, c_in, c_out, k))

    def csp(name, c_in, c_out, n):
        conv(name + ".main", c_in, c_out // 2, 1)
        conv(name + ".short", c_in, c_out // 2, 1)
        conv(name + ".final", c_out, c_out, 1)
        for i in range(n):
            conv(f"{name}.b{i}.1", c_out // 2, c_out // 2, 1)
            conv(f"{name}.b{i}.2", c_out // 2, c_out // 2, 3)

    conv("stem", 12, ws[0], 3)                 # focus: 12 = 3 * 4
    conv("down1", ws[0], ws[1], 3)
    csp("csp1", ws[1], ws[1], ds[0])
    conv("down2", ws[1], ws[2], 3)
    csp("csp2", ws[2], ws[2], ds[1])
    conv("down3", ws[2], ws[3], 3)
    csp("csp3", ws[3], ws[3], ds[2])
    conv("down4", ws[3], ws[4], 3)
    # SPP bottleneck (official CSPDarknet dark5): 1x1 squeeze, identity +
    # 5/9/13 max-pools, 1x1 expand
    conv("spp.pre", ws[4], ws[4] // 2, 1)
    conv("spp.post", (ws[4] // 2) * 4, ws[4], 1)
    csp("csp4", ws[4], ws[4], ds[3])
    # PAFPN (official YOLOPAFPN: CSP depth = round(3 * d))
    conv("lat2", ws[4], ws[3], 1)
    csp("fpn2", ws[3] * 2, ws[3], ds[3])
    conv("lat1", ws[3], ws[2], 1)
    csp("fpn1", ws[2] * 2, ws[2], ds[3])
    conv("pan1", ws[2], ws[2], 3)
    csp("pan1c", ws[2] * 2, ws[3], ds[3])
    conv("pan2", ws[3], ws[3], 3)
    csp("pan2c", ws[3] * 2, ws[4], ds[3])
    for lvl, c in enumerate([ws[2], ws[3], ws[4]]):     # decoupled heads
        conv(f"head{lvl}.stem", c, ws[2], 1)
        for branch in ("cls1", "cls2", "reg1", "reg2"):
            conv(f"head{lvl}.{branch}", ws[2], ws[2], 3)
        conv(f"head{lvl}.cls", ws[2], COCO_CLASSES, 1)
        conv(f"head{lvl}.reg", ws[2], 4, 1)
        conv(f"head{lvl}.obj", ws[2], 1, 1)
    return convs


def _conv_params(rng, c_in, c_out, k):
    w = rng.randn(k, k, c_in, c_out).astype(np.float32)
    w *= np.sqrt(2.0 / (k * k * c_in))
    return {"w": w, "b": np.zeros(c_out, np.float32)}


def init_params(depth_mul: float = 0.33, width_mul: float = 0.50,
                seed: int = 0) -> dict:
    """YOLOX-s scale: depth 0.33, width 0.50. The same arrays, bit for bit,
    as the JAX package's `init_params`."""
    rng = np.random.RandomState(seed)
    w = lambda c: max(int(round(c * width_mul)), 8)
    d = lambda n: max(int(round(n * depth_mul)), 1)
    p = {"meta": {"widths": [w(64), w(128), w(256), w(512), w(1024)],
                  "depths": [d(3), d(9), d(9), d(3)]}}
    for name, c_in, c_out, k in _layout(p["meta"]["widths"],
                                        p["meta"]["depths"]):
        p[name] = _conv_params(rng, c_in, c_out, k)
    return p


def load_params(path: str) -> dict:
    """An .npz checkpoint in the JAX package's layout; float arrays (stored
    as float16 by the trainer) upcast to float32, extra keys kept."""
    data = np.load(path, allow_pickle=True)
    p = {k: data[k].item() if data[k].dtype == object else data[k]
         for k in data.files}
    for k, v in p.items():
        if isinstance(v, dict):
            p[k] = {kk: (np.asarray(vv, np.float32)
                         if isinstance(vv, np.ndarray)
                         and vv.dtype.kind == "f" else vv)
                    for kk, vv in v.items()}
    return p


def _key(name: str) -> str:
    return name.replace(".", "_")


def params_to_state_dict(params: dict) -> dict:
    """The JAX layout (HWIO `w`, `b` per convolution) -> `YOLOXNet`'s state
    dict (OIHW weights)."""
    meta = params["meta"]
    sd = {}
    for name, *_ in _layout(meta["widths"], meta["depths"]):
        w = np.asarray(params[name]["w"], np.float32)
        sd[f"convs.{_key(name)}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1))))
        sd[f"convs.{_key(name)}.bias"] = torch.from_numpy(
            np.asarray(params[name]["b"], np.float32).copy())
    return sd


def state_dict_to_params(sd: dict, meta: dict) -> dict:
    """`YOLOXNet`'s state dict -> the JAX layout (`meta`, HWIO `w` and `b`
    numpy arrays per convolution): the inverse of `params_to_state_dict`."""
    p = {"meta": meta}
    for name, *_ in _layout(meta["widths"], meta["depths"]):
        w = sd[f"convs.{_key(name)}.weight"].detach().cpu().numpy()
        p[name] = {"w": np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0))),
                   "b": sd[f"convs.{_key(name)}.bias"].detach().cpu().numpy()}
    return p


def _same_pad(n: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's "SAME" padding of one extent: (before, after)."""
    total = max((math.ceil(n / stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class YOLOXNet(nn.Module):
    """CSPDarknet + SPP + PAFPN + decoupled heads, NCHW. Built from a
    checkpoint's `meta` (widths, depths); load weights with
    `load_state_dict(params_to_state_dict(params))`."""

    def __init__(self, meta: dict):
        super().__init__()
        self.depths = list(meta["depths"])
        self.convs = nn.ModuleDict({
            _key(name): nn.Conv2d(c_in, c_out, k)
            for name, c_in, c_out, k in _layout(meta["widths"],
                                                meta["depths"])})

    def conv(self, x, name: str, stride: int = 1, act: bool = True):
        m = self.convs[_key(name)]
        k = m.kernel_size[0]
        (t, b), (l, r) = (_same_pad(x.shape[-2], k, stride),
                          _same_pad(x.shape[-1], k, stride))
        if (t, l) == (b, r):
            y = F.conv2d(x, m.weight, m.bias, stride, padding=(t, l))
        else:
            y = F.conv2d(F.pad(x, (l, r, t, b)), m.weight, m.bias, stride)
        return F.silu(y) if act else y

    def csp(self, x, name: str, n: int, shortcut: bool = True):
        """CSPLayer: the backbone's dark2-4 use residual bottlenecks; dark5
        and every PAFPN merge do not."""
        a = self.conv(x, name + ".main")
        b = self.conv(x, name + ".short")
        for i in range(n):
            h = self.conv(self.conv(a, f"{name}.b{i}.1"), f"{name}.b{i}.2")
            a = a + h if shortcut else h
        return self.conv(torch.cat([a, b], 1), name + ".final")

    def spp(self, x):
        h = self.conv(x, "spp.pre")
        pools = [h] + [F.max_pool2d(h, k, stride=1, padding=k // 2)
                       for k in (5, 9, 13)]
        return self.conv(torch.cat(pools, 1), "spp.post")

    def forward(self, img):
        """img (1, 3, H, W) in [0, 1], H and W multiples of 32 -> the three
        levels' (reg, obj, cls) head tensors."""
        ds = self.depths
        # focus: space-to-depth 2x, in the JAX package's channel order
        x = torch.cat([img[:, :, ::2, ::2], img[:, :, 1::2, ::2],
                       img[:, :, ::2, 1::2], img[:, :, 1::2, 1::2]], 1)
        x = self.conv(x, "stem")
        x = self.csp(self.conv(x, "down1", 2), "csp1", ds[0])
        c3 = self.csp(self.conv(x, "down2", 2), "csp2", ds[1])   # stride 8
        c4 = self.csp(self.conv(c3, "down3", 2), "csp3", ds[2])  # stride 16
        x = self.spp(self.conv(c4, "down4", 2))
        c5 = self.csp(x, "csp4", ds[3], shortcut=False)          # stride 32

        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        nf = ds[3]
        l5 = self.conv(c5, "lat2")
        f4 = self.csp(torch.cat([up(l5), c4], 1), "fpn2", nf, shortcut=False)
        l4 = self.conv(f4, "lat1")
        f3 = self.csp(torch.cat([up(l4), c3], 1), "fpn1", nf, shortcut=False)
        d3 = self.conv(f3, "pan1", 2)
        f4b = self.csp(torch.cat([d3, l4], 1), "pan1c", nf, shortcut=False)
        d4 = self.conv(f4b, "pan2", 2)
        f5 = self.csp(torch.cat([d4, l5], 1), "pan2c", nf, shortcut=False)

        outs = []
        for lvl, feat in enumerate([f3, f4b, f5]):
            h = self.conv(feat, f"head{lvl}.stem")
            hc = self.conv(self.conv(h, f"head{lvl}.cls1"), f"head{lvl}.cls2")
            hr = self.conv(self.conv(h, f"head{lvl}.reg1"), f"head{lvl}.reg2")
            outs.append((self.conv(hr, f"head{lvl}.reg", act=False),
                         self.conv(hr, f"head{lvl}.obj", act=False),
                         self.conv(hc, f"head{lvl}.cls", act=False)))
        return outs


def decode(outs) -> torch.Tensor:
    """Grid / stride decode (YOLOX.h:89-114) of the NCHW head tensors ->
    (M, 6) rows x1, y1, x2, y2, score, class, level by level in row-major
    cell order."""
    rows = []
    for (reg, obj, cls), stride in zip(outs, STRIDES):
        _, _, h, w = reg.shape
        gy = torch.arange(h, dtype=torch.float32,
                          device=reg.device)[:, None].expand(h, w)
        gx = torch.arange(w, dtype=torch.float32,
                          device=reg.device)[None, :].expand(h, w)
        cxy = torch.stack([(reg[0, 0] + gx) * stride,
                           (reg[0, 1] + gy) * stride], -1)
        wh = torch.exp(torch.clamp(reg[0, 2:4], -10, 6)).permute(1, 2, 0) \
            * stride
        score = torch.sigmoid(obj[0, 0])
        cls_p = torch.sigmoid(cls[0])
        best_c = torch.argmax(cls_p, 0)
        best_p = torch.amax(cls_p, 0)
        row = torch.cat([cxy - wh / 2, cxy + wh / 2,
                         (score * best_p)[..., None],
                         best_c[..., None].to(torch.float32)], -1)
        rows.append(row.reshape(-1, 6))
    return torch.cat(rows, 0)


def iou_matrix(boxes: torch.Tensor) -> torch.Tensor:
    """(n, 4) -> (n, n) IoU, row i against every box, in the JAX package's
    expression (so the values, and the NMS decisions, are the same)."""
    a, b = boxes[:, None, :], boxes[None, :, :]
    x1 = torch.maximum(a[..., 0], b[..., 0])
    y1 = torch.maximum(a[..., 1], b[..., 1])
    x2 = torch.minimum(a[..., 2], b[..., 2])
    y2 = torch.minimum(a[..., 3], b[..., 3])
    inter = torch.clamp(x2 - x1, min=0) * torch.clamp(y2 - y1, min=0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / torch.clamp(area_a + area_b - inter, min=1e-6)


def greedy_nms(suppress: np.ndarray, alive: np.ndarray) -> np.ndarray:
    """The JAX package's fixed-iteration greedy pass on the host: candidate
    i is kept if it is alive when its turn comes, and then kills the later
    candidates it suppresses."""
    alive = alive.copy()
    keep = np.zeros_like(alive)
    for i in range(len(alive)):
        if alive[i]:
            keep[i] = True
            row = suppress[i].copy()
            row[i] = False
            alive &= ~row
    return keep


def candidates(dets: torch.Tensor, score_th: float, iou_th: float,
               max_det: int = MAX_DET) -> tuple:
    """`select`'s device half: the top-(4 max_det) rows by score and the
    class-aware suppression matrix with the alive row under it, ((4
    max_det, 6), (4 max_det + 1, 4 max_det) bool)."""
    scores = torch.where(dets[:, 4] >= score_th, dets[:, 4],
                         torch.zeros_like(dets[:, 4]))
    top_s, idx = top_k(scores, max_det * 4)
    cand = dets[idx]
    suppress = (iou_matrix(cand[:, :4]) > iou_th) \
        & (cand[:, None, 5] == cand[None, :, 5])
    return cand, torch.cat([suppress, (top_s > 0)[None]], 0)


def upload(x, device) -> torch.Tensor:
    """A host array or tensor on `device` without a host wait: through
    pinned memory by a non-blocking copy (a copy from pageable memory
    waits for the stream's queued work first)."""
    t = torch.as_tensor(x)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def kept(cand: torch.Tensor, host: np.ndarray,
         max_det: int = MAX_DET) -> Detections:
    """`select`'s host half: greedy NMS over the suppression matrix read
    back (`host`, as `candidates` gives it) -> max_det slots, kept
    first."""
    keep = greedy_nms(host[:-1], host[-1])
    order = np.argsort(~keep, kind="stable")[:max_det]
    sel = cand[upload(order, cand.device)]
    return Detections(boxes=sel[:, :4], scores=sel[:, 4],
                      classes=sel[:, 5].to(torch.int32),
                      valid=upload(keep[order], cand.device))


def select(dets: torch.Tensor, score_th: float, iou_th: float,
           max_det: int = MAX_DET) -> Detections:
    """Top-(4 max_det) by score + class-aware greedy NMS -> max_det slots,
    kept first; one readback of the suppression matrix."""
    cand, suppress = candidates(dets, score_th, iou_th, max_det)
    return kept(cand, suppress.cpu().numpy(), max_det)


class Pending(NamedTuple):
    """A frame's detection on its way: the candidates on the device, the
    suppression matrix's host copy and the CUDA event behind it (None on
    the CPU, where the copy is made at once)."""
    cand: torch.Tensor
    host: torch.Tensor
    event: object


class YOLOX:
    """Detector facade of the reference's YOLOX queue interface
    (include/YOLOX.h:79-81). `device` defaults to cuda.

    `launch(rgb)` enqueues a frame's detection and returns at once: on a
    card, resize, network, decode, the top candidates and their suppression
    matrix run on a CUDA stream of the detector's own, which waits for the
    caller's stream, and the matrix comes back by a non-blocking copy.
    `resolve(pending)` waits for that copy only where it is not done yet
    (one host sync, counted) and runs the greedy NMS on the host.
    `detect(rgb)` is the two in one."""

    def __init__(self, weights: str | None = None, input_size: int = 640,
                 score_th: float = 0.3, iou_th: float = 0.45, device=None,
                 depth_mul: float = 0.33, width_mul: float = 0.50):
        self.device = resolve_device(device)
        self.params = (load_params(weights) if weights
                       else init_params(depth_mul, width_mul))
        self.input_size = input_size
        self.score_th = score_th
        self.iou_th = iou_th
        self.net = YOLOXNet(self.params["meta"])
        self.net.load_state_dict(params_to_state_dict(self.params))
        self.net.requires_grad_(False).to(self.device)
        self.launches = 0
        self._stream = None

    def resize(self, rgb) -> torch.Tensor:
        """rgb (H, W, 3) [0, 255] (array or tensor) -> (3, s, s) float32 on
        the device: jax.image.resize's antialiased bilinear, per channel."""
        x = torch.as_tensor(rgb, dtype=torch.float32, device=self.device)
        s = self.input_size
        return torch.stack([bilinear_resize(x[..., c], s, s)
                            for c in range(3)], 0)

    def heads(self, img: torch.Tensor):
        """(3, s, s) [0, 255] -> the network's head tensors."""
        return self.net(img[None] / 255.0)

    def _enqueue(self, rgb) -> tuple:
        img = self.resize(rgb)
        with PROFILER.device_span("detect.net", self.device):
            outs = self.heads(img)
        return candidates(decode(outs), self.score_th, self.iou_th)

    def launch(self, rgb) -> Pending:
        """rgb (H, W, 3) float32 [0, 255] -> the frame's detection,
        enqueued (see the class)."""
        self.launches += 1
        if self.device.type != "cuda":
            cand, suppress = self._enqueue(rgb)
            return Pending(cand, suppress, None)
        x = upload(torch.as_tensor(rgb, dtype=torch.float32), self.device)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        x.record_stream(side)      # the caller's memory, read on this stream
        with torch.cuda.stream(side):
            cand, suppress = self._enqueue(x)
            host = torch.empty(suppress.shape, dtype=suppress.dtype,
                               pin_memory=True)
            host.copy_(suppress, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        return Pending(cand, host, event)

    def resolve(self, pending: Pending) -> Detections:
        """A launched frame's Detections (see `detect`)."""
        cand, host, event = pending
        if event is not None:
            if not event.query():
                PROFILER.count_sync()
                event.synchronize()
            # read on the caller's stream: not reused by the detector's
            # stream before that
            cand.record_stream(torch.cuda.current_stream(self.device))
        return kept(cand, host.numpy())

    def detect(self, rgb) -> Detections:
        """rgb (H, W, 3) float32 [0, 255] -> Detections in the resized
        (input_size x input_size) image's pixels, like the reference's
        static 640x640 resize (YOLOX.cpp)."""
        return self.resolve(self.launch(rgb))
