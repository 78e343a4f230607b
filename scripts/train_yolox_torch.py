#!/usr/bin/env python
"""Train a tiny YOLOX on synthetic person-like scenes with the PyTorch port:
the twin of scripts/train_yolox.py (the reference hard-requires a TensorRT
engine trained elsewhere, src/System.cc:88; here a small detector is
trained on procedurally generated indoor-ish scenes instead).

The network is the port's `models/yolox.YOLOXNet`, the inference graph
itself at width 0.125 and 256x256 input, starting from `init_params`
(bit-equal to the JAX package's). Assignment is anchor-free and
center-based: each ground-truth box goes to one FPN level by its size, and
the 3x3 cells around its centre are positives. Losses per image: BCE
objectness over all cells, BCE class, IoU and l1 box at the positives, each
positive term divided by that image's own positive count; the batch loss is
the mean of the images' losses (the JAX trainer's `vmap` then mean).
`torch.optim.Adam` under a linear-warmup cosine schedule computes the rate
as optax's `warmup_cosine_decay_schedule` does, and, like optax, uses the
rate at count 0 for the first update, so the first step's rate is 0.

    python scripts/train_yolox_torch.py [--steps 700] [--batch 8]
        [--lr 1e-3] [--out output/yolox_synth.npz] [--device cuda|cpu]

The weights are saved in the JAX package's on-disk format (an object dict
of float16 HWIO `w` and `b` per convolution, plus `meta`), which both
packages' `load_params` read."""

from __future__ import annotations

import argparse
import math
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from dr_slam_torch.models import yolox  # noqa: E402

SIZE = 256
STRIDES = yolox.STRIDES          # (8, 16, 32)
GRIDS = tuple(SIZE // s for s in STRIDES)
MAX_GT = 4
# route GT to level by sqrt(area): <48px -> s8, <112 -> s16, else s32
LEVEL_EDGES = (48.0, 112.0)


# ----------------------------------------------------------------- scenes
def render_scene(rng: np.random.RandomState):
    """(img (S,S,3) float [0,1], boxes (MAX_GT,4) x1y1x2y2, n_gt)."""
    # textured background: low-frequency gradient + blocky clutter
    gy, gx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32) / SIZE
    base = (0.35 + 0.3 * rng.rand()) + 0.25 * (gy * rng.randn() + gx * rng.randn())
    img = np.stack([base + 0.05 * rng.randn()] * 3, -1)
    for _ in range(rng.randint(3, 8)):            # wall/furniture rectangles
        x, y = rng.randint(0, SIZE, 2)
        w, h = rng.randint(20, 90, 2)
        img[y:y + h, x:x + w] += rng.uniform(-0.18, 0.18, 3)
    n = rng.randint(1, MAX_GT + 1)
    boxes = np.zeros((MAX_GT, 4), np.float32)
    for i in range(n):
        # person-like: tall ellipse (torso+legs) + smaller head ellipse
        h = rng.uniform(40, 170)
        w = h * rng.uniform(0.3, 0.45)
        cx = rng.uniform(w / 2 + 2, SIZE - w / 2 - 2)
        cy = rng.uniform(h / 2 + 2, SIZE - h / 2 - 2)
        color = rng.uniform(0.0, 1.0, 3)
        yy, xx = np.mgrid[0:SIZE, 0:SIZE].astype(np.float32)
        body = (((xx - cx) / (w / 2)) ** 2 +
                ((yy - (cy + h * 0.08)) / (h * 0.42)) ** 2) < 1.0
        head_r = h * 0.12
        head = (((xx - cx) / head_r) ** 2 +
                ((yy - (cy - h * 0.38)) / head_r) ** 2) < 1.0
        m = body | head
        img[m] = 0.75 * color + 0.25 * img[m]
        boxes[i] = (cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2)
    img += 0.02 * rng.randn(SIZE, SIZE, 3)
    return np.clip(img, 0, 1).astype(np.float32), boxes, n


def make_batch(rng, bs):
    imgs, boxes, ns = zip(*[render_scene(rng) for _ in range(bs)])
    return (np.stack(imgs), np.stack(boxes),
            np.asarray(ns, np.int32))


# ----------------------------------------------------------------- targets
def _grid(g: int, device) -> tuple:
    """(gy, gx) (g, g) float32 cell row and column indices."""
    r = torch.arange(g, dtype=torch.float32, device=device)
    return r[:, None].expand(g, g), r[None, :].expand(g, g)


def build_targets(boxes: torch.Tensor, n_gt: torch.Tensor) -> list:
    """Dense per-level targets of a batch: boxes (B, MAX_GT, 4) x1y1x2y2,
    n_gt (B,) -> per level (obj (B, g, g), box (B, g, g, 4) cxcywh in
    pixels)."""
    B = boxes.shape[0]
    dev = boxes.device
    out = []
    for lvl, (stride, g) in enumerate(zip(STRIDES, GRIDS)):
        gy, gx = _grid(g, dev)
        obj = torch.zeros((B, g, g), device=dev)
        tbox = torch.zeros((B, g, g, 4), device=dev)
        lo = LEVEL_EDGES[lvl - 1] if lvl > 0 else 0.0
        hi = LEVEL_EDGES[lvl] if lvl < 2 else 1e9
        for i in range(MAX_GT):
            b = boxes[:, i]
            w, h = b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]
            size = torch.sqrt(torch.clamp(w * h, min=1e-6))
            level_ok = (size >= lo) & (size < hi) & (i < n_gt)
            cx, cy = (b[:, 0] + b[:, 2]) / 2, (b[:, 1] + b[:, 3]) / 2
            ci, cj = cy / stride, cx / stride
            near = ((torch.abs(gy - ci[:, None, None] + 0.5) <= 1.5)
                    & (torch.abs(gx - cj[:, None, None] + 0.5) <= 1.5))
            sel = near & level_ok[:, None, None]
            obj = torch.where(sel, 1.0, obj)
            tbox = torch.where(sel[..., None],
                               torch.stack([cx, cy, w, h], -1)[:, None, None],
                               tbox)
        out.append((obj, tbox))
    return out


def _bce(logit, target):
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-torch.abs(logit))))


def loss_batch(net, imgs, boxes, n_gts) -> torch.Tensor:
    """imgs (B, S, S, 3) [0, 1], boxes (B, MAX_GT, 4), n_gts (B,) -> the
    mean over the batch of each image's loss (each image normalised by its
    own positive count, level by level)."""
    outs = net(imgs.permute(0, 3, 1, 2))
    tg = build_targets(boxes, n_gts)
    total = 0.0
    for (reg, obj, cls), (t_obj, t_box), stride, g in zip(
            outs, tg, STRIDES, GRIDS):
        reg = reg.permute(0, 2, 3, 1)                 # (B, g, g, 4)
        obj = obj[:, 0]
        pos = t_obj
        n_pos = torch.clamp(pos.sum((1, 2)), min=1.0)

        def per_image(x):
            return x.sum((1, 2)) / n_pos

        total = total + _bce(obj, t_obj).mean((1, 2)) * 4.0
        # class 0 ("person") at positives
        total = total + per_image(pos * _bce(cls[:, 0], 1.0))
        # predicted box at each cell (the transform of models/yolox.decode)
        gy, gx = _grid(g, imgs.device)
        pcx = (reg[..., 0] + gx) * stride
        pcy = (reg[..., 1] + gy) * stride
        pwh = torch.exp(torch.clamp(reg[..., 2:4], -10, 6)) * stride
        px1, py1 = pcx - pwh[..., 0] / 2, pcy - pwh[..., 1] / 2
        px2, py2 = pcx + pwh[..., 0] / 2, pcy + pwh[..., 1] / 2
        tx1, ty1 = t_box[..., 0] - t_box[..., 2] / 2, t_box[..., 1] - t_box[..., 3] / 2
        tx2, ty2 = t_box[..., 0] + t_box[..., 2] / 2, t_box[..., 1] + t_box[..., 3] / 2
        ix = torch.clamp(torch.minimum(px2, tx2) - torch.maximum(px1, tx1),
                         min=0)
        iy = torch.clamp(torch.minimum(py2, ty2) - torch.maximum(py1, ty1),
                         min=0)
        inter = ix * iy
        union = (px2 - px1) * (py2 - py1) + t_box[..., 2] * t_box[..., 3] - inter
        iou = inter / torch.clamp(union, min=1e-6)
        total = total + per_image(pos * (1.0 - iou)) * 5.0
        # l1 on the raw reg channels stabilises early training
        tcx = t_box[..., 0] / stride - gx
        tcy = t_box[..., 1] / stride - gy
        twh = torch.log(torch.clamp(t_box[..., 2:4] / stride, min=1e-3))
        l1 = (torch.abs(reg[..., 0] - tcx) + torch.abs(reg[..., 1] - tcy)
              + torch.abs(reg[..., 2] - twh[..., 0])
              + torch.abs(reg[..., 3] - twh[..., 1]))
        total = total + per_image(pos * l1) * 0.3
    return total.mean()


# --------------------------------------------------------------- optimiser
def warmup_steps(steps: int) -> int:
    return min(50, max(steps // 10, 1))


def schedule_rate(count: int, lr: float, warm: int, decay: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warm, decay) at `count`,
    in float32 as optax evaluates it: a linear warmup from 0, then a cosine
    decay to 0 over decay - warm steps."""
    f32 = np.float32
    if count < warm:
        frac = f32(1) - f32(min(max(count, 0), warm)) / f32(warm)
        return float(f32(-lr) * frac + f32(lr))
    t = f32(min(count - warm, decay - warm))
    # the cosine of the float32 argument, rounded from float64 (as XLA's)
    arg = f32(math.pi) * t / f32(decay - warm)
    cosine = f32(0.5) * (f32(1) + f32(math.cos(float(arg))))
    return float(f32(lr) * cosine)


def make_optimizer(net, steps: int, lr: float):
    """Adam (optax's defaults: b1 0.9, b2 0.999, eps 1e-8) whose rate is
    the schedule's at the update's count: the base rate is 1 and LambdaLR
    sets it to schedule_rate(count). -> (optimizer, scheduler)."""
    warm = warmup_steps(steps)
    decay = max(steps, warm + 1)
    opt = torch.optim.Adam(net.parameters(), lr=1.0, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda c: schedule_rate(c, lr, warm, decay))
    return opt, sched


def make_net(depth: float, width: float, device):
    """YOLOXNet from the seeded init_params(depth, width), on `device`
    and trainable. -> (net, meta)."""
    params = yolox.init_params(depth, width)
    net = yolox.YOLOXNet(params["meta"])
    net.load_state_dict(yolox.params_to_state_dict(params))
    return net.to(device), params["meta"]


def train_step(net, opt, sched, imgs, boxes, n_gts) -> torch.Tensor:
    """One Adam step on a device batch; -> the batch loss (not read
    back)."""
    opt.zero_grad(set_to_none=True)
    loss = loss_batch(net, imgs, boxes, n_gts)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


def to_device(batch, device) -> tuple:
    imgs, boxes, n_gts = batch
    return (torch.from_numpy(imgs).to(device),
            torch.from_numpy(boxes).to(device),
            torch.from_numpy(n_gts).to(device))


def save_params(net, meta: dict, path: str) -> None:
    """The JAX package's checkpoint format (models/yolox_convert.py's):
    an object dict per convolution, float16 to halve the file;
    load_params upcasts."""
    params = yolox.state_dict_to_params(net.state_dict(), meta)
    flat = {"meta": np.asarray(meta, dtype=object)}
    for k, v in params.items():
        if k == "meta":
            continue
        flat[k] = np.asarray({"w": np.asarray(v["w"], np.float16),
                              "b": np.asarray(v["b"], np.float16)},
                             dtype=object)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path + ".tmp.npz", **flat)
    os.replace(path + ".tmp.npz", path)


def main(argv=None) -> list:
    """Train; -> the per-step losses."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--steps", type=int, default=700)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--width", type=float, default=0.125)
    ap.add_argument("--depth", type=float, default=0.33)
    ap.add_argument("--out", default="output/yolox_synth.npz")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    from dr_slam_torch import resolve_device

    dev = resolve_device(args.device)
    net, meta = make_net(args.depth, args.width, dev)
    opt, sched = make_optimizer(net, args.steps, args.lr)
    rng = np.random.RandomState(7)
    losses = []
    t0 = time.time()
    for it in range(args.steps):
        batch = to_device(make_batch(rng, args.batch), dev)
        losses.append(train_step(net, opt, sched, *batch))
        if it % 200 == 0 or it == args.steps - 1:
            print(f"step {it:4d}  loss {float(losses[-1]):.4f}  "
                  f"({time.time() - t0:.0f}s)", flush=True)
    save_params(net, meta, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out)} bytes)")
    return torch.stack(losses).cpu().tolist()


if __name__ == "__main__":
    main()
