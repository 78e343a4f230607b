"""Line segments + binary descriptors + 3D lifting as fixed-shape tensor code.

Counterpart of the JAX package's `ops/lines.py` (the role of LSD + LBD + the 3D
line RANSAC/MLE of the reference): structure-tensor cells, min-label
chaining of compatible cells (a Python loop of fixed length), top-L
segments by support with a subpixel ridge refinement, line-BRIEF
descriptors, depth-sampled RANSAC + PCA + Mahalanobis MLE lift, and
vanishing-point directions for depth-poor lines."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dr_slam_torch.geometry.se3 import cross
from dr_slam_torch.ops import eig33
from dr_slam_torch.ops import image as image_ops
from dr_slam_torch.ops.orb import pack_bits
from dr_slam_torch.ops.select import top_k


class LineFeatures(NamedTuple):
    seg2d: torch.Tensor      # (L, 4) endpoints x1,y1,x2,y2 (pixels)
    lineq: torch.Tensor      # (L, 3) normalized 2D line equation
    desc: torch.Tensor       # (L, 8) int32 packed 256-bit descriptor
    dir3d: torch.Tensor      # (L, 3) unit 3D direction (camera frame)
    ep3d: torch.Tensor       # (L, 6) 3D endpoints (camera frame)
    has3d: torch.Tensor      # (L,) bool
    valid: torch.Tensor      # (L,) bool
    response: torch.Tensor   # (L,) support strength
    man_dir: torch.Tensor    # (L, 3) Manhattan direction evidence
    man_ok: torch.Tensor     # (L,) bool


def _line_pattern(seed: int = 7, n: int = 256) -> np.ndarray:
    """(n, 4): compare intensity at (t1, o1) vs (t2, o2) in the line frame."""
    rng = np.random.RandomState(seed)
    t = rng.uniform(-0.45, 0.45, (n, 2))
    o = rng.randn(n, 2) * 3.0
    o = np.clip(o, -6, 6)
    return np.stack([t[:, 0], o[:, 0], t[:, 1], o[:, 1]], -1).astype(np.float32)


def _linspace(start: float, stop: float, num: int) -> np.ndarray:
    """float32 linspace computed the way jnp.linspace computes it."""
    f32 = np.float32
    div = num - 1
    step = (np.arange(div, dtype=f32) / f32(div)).astype(f32)
    out = (f32(start) * (f32(1) - step) + f32(stop) * step).astype(f32)
    return np.concatenate([out, np.asarray([stop], f32)])


_LINE_PATTERN = _line_pattern()


@functools.lru_cache(maxsize=32)
def _const(key, device: torch.device) -> torch.Tensor:
    if key == "pattern":
        arr = _LINE_PATTERN
    elif key[0] == "pairs":
        # RANSAC hypotheses: deterministic sample-index pairs
        s_idx = np.linspace(0, key[1] - 1, 8, dtype=np.int64)
        arr = np.array([(i, j) for i in s_idx for j in s_idx if j > i + 2],
                       dtype=np.int64)
    else:
        arr = _linspace(*key)
    return torch.from_numpy(arr).to(device)


def refine_line_mle(X, w_mask, mu0, dir0, n_iters: int = 3):
    """Per-point-covariance Mahalanobis MLE line refinement (IRLS: inverse
    variance times a Huber factor; each round is a weighted PCA).

    X (L, S, 3), w_mask (L, S) in {0,1}, mu0/dir0 (L, 3). -> (mu, dir)."""
    sigma = 0.0012 * torch.square(X[..., 2]) + 1e-3
    inv_s2 = 1.0 / torch.square(sigma)
    mu, d = mu0, dir0
    for _ in range(n_iters):
        rel = X - mu[:, None]
        along = torch.einsum("lsc,lc->ls", rel, d)
        dist = torch.linalg.norm(rel - along[..., None] * d[:, None], dim=-1)
        r = dist / sigma
        huber = torch.clamp(1.345 / torch.clamp(r, min=1e-9), max=1.0)
        w = w_mask * inv_s2 * huber
        wsum = torch.clamp(torch.sum(w, -1), min=1e-6)
        mu2 = torch.sum(X * w[..., None], 1) / wsum[:, None]
        dXw = (X - mu2[:, None]) * torch.sqrt(w)[..., None]
        cov = torch.einsum("lsi,lsj->lij", dXw, dXw) / wsum[:, None, None]
        ev = eig33.eigvals_sym3(cov)
        v = eig33.smallest_eigvec_sym3(-cov, -ev[:, 2])
        sgn = torch.where(torch.sum(v * d, -1, keepdim=True) < 0, -1.0, 1.0)
        mu, d = mu2, v * sgn.to(v.dtype)
    return mu, d


def vp_directions(lineq: torch.Tensor, seg2d: torch.Tensor,
                  valid: torch.Tensor, K4,
                  angle_tol_deg: float = 2.0, min_votes: int = 4):
    """Batched 2D vanishing-point estimation -> per-line 3D directions
    (Frame::VP_estimation / Vp_Ransac, Frame.cc:255-475).

    Returns (dir3 (L, 3) unit camera-frame directions, ok (L,) bool)."""
    fx, fy, cx0, cy0 = K4
    offs = (1, 2, 3, 5, 8, 13)
    li = torch.cat([lineq] * len(offs), 0)                   # (P, 3)
    lj = torch.cat([torch.roll(lineq, -o, dims=0) for o in offs], 0)
    vi = torch.cat([valid] * len(offs), 0)
    vj = torch.cat([torch.roll(valid, -o, dims=0) for o in offs], 0)
    v = cross(li, lj)
    vnorm = torch.linalg.norm(v, dim=-1)
    hyp_ok = vi & vj & (vnorm > 1e-6)
    v = v / torch.clamp(vnorm, min=1e-9)[:, None]

    mid = 0.5 * (seg2d[:, :2] + seg2d[:, 2:])
    d2 = seg2d[:, 2:] - seg2d[:, :2]
    d2 = d2 / torch.clamp(torch.linalg.norm(d2, dim=-1, keepdim=True), min=1e-9)
    to_vp = v[None, :, :2] - v[None, :, 2:3] * mid[:, None, :]   # (L, P, 2)
    to_vp_n = torch.clamp(torch.linalg.norm(to_vp, dim=-1), min=1e-9)
    cosang = torch.abs(torch.einsum("lpc,lc->lp", to_vp, d2)) / to_vp_n
    aligns = cosang > float(np.cos(np.radians(angle_tol_deg)))
    votes = aligns & valid[:, None] & hyp_ok[None, :]
    score = torch.sum(votes, 0)                                  # (P,)
    per_line = torch.where(votes, score[None, :], torch.full_like(votes, -1,
                                                                  dtype=score.dtype))
    best_p = torch.argmax(per_line, -1)
    best_score = torch.gather(per_line, 1, best_p[:, None])[:, 0]
    ok = valid & (best_score >= min_votes)
    vb = v[best_p]
    d3 = torch.stack([(vb[:, 0] - cx0 * vb[:, 2]) / fx,
                      (vb[:, 1] - cy0 * vb[:, 2]) / fy,
                      vb[:, 2]], -1)
    d3 = d3 / torch.clamp(torch.linalg.norm(d3, dim=-1, keepdim=True), min=1e-9)
    return d3, ok


def extract_lines(gray: torch.Tensor, depth: torch.Tensor, K4,
                  max_lines: int = 64, grad_threshold: float = 20.0,
                  min_length: float = 25.0, cell: int = 16,
                  n_samples: int = 32, n_prop: int = 32) -> LineFeatures:
    dev = gray.device
    h, w = gray.shape
    gx, gy = image_ops.sobel_gradients(gray)
    mag2 = gx * gx + gy * gy
    strong = mag2 > grad_threshold ** 2

    gh, gw = h // cell, w // cell
    nb = gh * gw

    def tile(x):
        x = x[:gh * cell, :gw * cell].reshape(gh, cell, gw, cell)
        return x.permute(0, 2, 1, 3).reshape(gh, gw, cell * cell)

    tgx, tgy, tm2 = tile(gx), tile(gy), tile(mag2)
    tst = tile(strong)
    tstf = tst.to(torch.float32)
    jxx = torch.sum(tgx * tgx * tstf, -1)
    jyy = torch.sum(tgy * tgy * tstf, -1)
    jxy = torch.sum(tgx * tgy * tstf, -1)
    tr = jxx + jyy
    phi = 0.5 * torch.atan2(2 * jxy, jxx - jyy)
    lam_diff = torch.sqrt(torch.clamp((jxx - jyy) ** 2 + 4 * jxy ** 2, min=1e-12))
    coherence = lam_diff / torch.clamp(tr, min=1e-6)
    n_strong = torch.sum(tst, -1)

    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    txx, tyy_ = tile(xx), tile(yy)
    pang = torch.atan2(tgy, tgx)
    dang = pang - phi[..., None]
    aligned = (torch.abs(torch.sin(dang)) < 0.38) & tst
    aw = tm2 * aligned
    awsum = torch.clamp(torch.sum(aw, -1), min=1e-6)
    cx_ = torch.sum(txx * aw, -1) / awsum
    cy_ = torch.sum(tyy_ * aw, -1) / awsum

    dirx = -torch.sin(phi)
    diry = torch.cos(phi)

    liney = (coherence > 0.7) & (n_strong > cell * 1.0)

    # ---- chain compatible neighbour cells (label propagation) -------------
    flat = torch.arange(nb, dtype=torch.int32, device=dev).reshape(gh, gw)
    labels = torch.where(liney, flat, torch.full_like(flat, nb))
    centers = torch.stack([cx_, cy_], -1)
    dirs = torch.stack([dirx, diry], -1)

    shifts = ((1, 0), (-1, 0), (0, 1), (0, -1), (1, 1), (1, -1), (-1, 1), (-1, -1))
    yy2 = torch.arange(gh, device=dev)[:, None]
    xx2 = torch.arange(gw, device=dev)[None, :]
    masks = []
    for s in shifts:
        roll = lambda x: torch.roll(x, s, dims=(0, 1))
        d2, c2, ok2 = roll(dirs), roll(centers), roll(liney)
        cosang = torch.abs(torch.sum(dirs * d2, -1))
        dc = c2 - centers
        dist = torch.clamp(torch.linalg.norm(dc, dim=-1), min=1e-6)
        along = torch.abs(torch.sum(dc * dirs, -1)) / dist
        perp = torch.abs(dc[..., 0] * dirs[..., 1] - dc[..., 1] * dirs[..., 0])
        inb = ((yy2 - s[0] >= 0) & (yy2 - s[0] < gh)
               & (xx2 - s[1] >= 0) & (xx2 - s[1] < gw))
        masks.append((cosang > 0.966) & (along > 0.924) & (perp < 3.0)
                     & liney & ok2 & inb)

    for _ in range(n_prop):
        out = labels
        for s, m in zip(shifts, masks):
            nl = torch.roll(labels, s, dims=(0, 1))
            out = torch.where(m, torch.minimum(out, nl), out)
        labels = out
    labels = labels.reshape(-1).to(torch.int64)

    # ---- top-L segments ----------------------------------------------------
    support = torch.zeros(nb + 1, dtype=torch.float32, device=dev).index_add_(
        0, labels, awsum.reshape(-1))
    support[nb] = 0.0
    top_sup, top_lab = top_k(support, max_lines)
    member = (labels[None, :] == top_lab[:, None]) & liney.reshape(-1)[None, :]
    mf = member.to(torch.float32) * awsum.reshape(-1)[None, :]

    msum = torch.clamp(torch.sum(mf, -1), min=1e-6)
    cen = (mf @ centers.reshape(nb, 2)) / msum[:, None]       # (L, 2)
    d0 = centers.reshape(nb, 2)[None] - cen[:, None]          # (L, nb, 2)
    cov_xx = torch.sum(mf * d0[..., 0] ** 2, -1) / msum
    cov_yy = torch.sum(mf * d0[..., 1] ** 2, -1) / msum
    cov_xy = torch.sum(mf * d0[..., 0] * d0[..., 1], -1) / msum
    theta = 0.5 * torch.atan2(2 * cov_xy, cov_xx - cov_yy)
    ldir = torch.stack([torch.cos(theta), torch.sin(theta)], -1)

    # ---- subpixel perpendicular refinement on the gradient ridge ----------
    nrm0 = torch.stack([-ldir[:, 1], ldir[:, 0]], -1)
    stations = _const((-0.35, 0.35, 9), dev)                  # (T,)
    proj0 = torch.einsum("lni,li->ln", d0, ldir)
    zero = torch.zeros_like(proj0)
    span0 = torch.clamp(
        torch.amax(torch.where(member, proj0, zero), -1)
        - torch.amin(torch.where(member, proj0, zero), -1), min=1e-3)
    offs = _const((-3.0, 3.0, 13), dev)                       # (O,)
    pos_ref = (cen[:, None, None, :]
               + stations[None, :, None, None] * span0[:, None, None, None]
               * ldir[:, None, None, :]
               + offs[None, None, :, None] * nrm0[:, None, None, :])
    magmap = torch.sqrt(mag2)
    mv = image_ops.bilinear_sample(magmap, pos_ref.reshape(-1, 2)).reshape(
        pos_ref.shape[:3])                                    # (L, T, O)
    wref = mv * mv
    wsum = torch.clamp(torch.sum(wref, -1), min=1e-6)
    o_per_station = torch.sum(wref * offs[None, None, :], -1) / wsum
    station_ok = wsum > 1e-3
    o_corr = (torch.sum(torch.where(station_ok, o_per_station,
                                    torch.zeros_like(o_per_station)), -1)
              / torch.clamp(torch.sum(station_ok, -1), min=1))
    cen = cen + torch.clamp(o_corr, -3.0, 3.0)[:, None] * nrm0

    # endpoints from extreme projections of member centroids (+half cell)
    proj = torch.where(member, proj0, zero)
    tmin = torch.amin(proj, -1) - cell * 0.5
    tmax = torch.amax(proj, -1) + cell * 0.5
    p1 = cen + tmin[:, None] * ldir
    p2 = cen + tmax[:, None] * ldir
    length = tmax - tmin
    seg2d = torch.cat([p1, p2], -1)

    # canonical direction: brighter side on the left
    nrm = torch.stack([-ldir[:, 1], ldir[:, 0]], -1)
    probe_l = image_ops.bilinear_sample(gray, cen + 4.0 * nrm)
    probe_r = image_ops.bilinear_sample(gray, cen - 4.0 * nrm)
    flip = probe_l < probe_r
    ldir = torch.where(flip[:, None], -ldir, ldir)
    seg2d = torch.where(flip[:, None], torch.cat([p2, p1], -1), seg2d)

    a = -ldir[:, 1]
    b = ldir[:, 0]
    c = -(a * cen[:, 0] + b * cen[:, 1])
    lineq = torch.stack([a, b, c], -1)

    valid = (top_sup > 0) & (length > min_length)

    # ---- descriptor: line-BRIEF in the line frame --------------------------
    pat = _const("pattern", dev)
    mid = cen
    span = length[:, None]
    fsign = torch.where(flip, -1.0, 1.0).to(torch.float32)[:, None, None]
    pos1 = (mid[:, None, :] + pat[None, :, 0:1] * span[:, None] * ldir[:, None, :]
            + pat[None, :, 1:2] * nrm[:, None, :] * fsign)
    pos2 = (mid[:, None, :] + pat[None, :, 2:3] * span[:, None] * ldir[:, None, :]
            + pat[None, :, 3:4] * nrm[:, None, :] * fsign)
    blur = image_ops.gaussian_blur(gray)
    bits = (image_ops.bilinear_sample(blur, pos1)
            < image_ops.bilinear_sample(blur, pos2))
    desc = pack_bits(bits)

    # ---- 3D lifting -----------------------------------------------------------
    t = _const((0.05, 0.95, n_samples), dev)
    samples = p1[:, None, :] + t[None, :, None] * (p2 - p1)[:, None, :]
    dvals = image_ops.nearest_sample(depth, samples)
    fx, fy, cx0, cy0 = K4
    X = torch.stack([(samples[..., 0] - cx0) / fx * dvals,
                     (samples[..., 1] - cy0) / fy * dvals,
                     dvals], -1)                               # (L,S,3)
    dok = dvals > 1e-3

    # RANSAC over deterministic index pairs
    pairs = _const(("pairs", n_samples), dev)
    Pa = X[:, pairs[:, 0]]
    Pb = X[:, pairs[:, 1]]
    ok_h = dok[:, pairs[:, 0]] & dok[:, pairs[:, 1]]
    ldir3 = Pb - Pa
    ldir3 = ldir3 / torch.clamp(torch.linalg.norm(ldir3, dim=-1, keepdim=True),
                                min=1e-9)
    rel = X[:, None, :, :] - Pa[:, :, None, :]                # (L, H, S, 3)
    along3 = torch.einsum("lhsc,lhc->lhs", rel, ldir3)
    perp3 = rel - along3[..., None] * ldir3[:, :, None, :]
    dist3 = torch.linalg.norm(perp3, dim=-1)
    tol = 0.01 + 0.01 * X[..., 2]
    inl = (dist3 < tol[:, None, :]) & dok[:, None, :] & ok_h[..., None]
    votes = torch.sum(inl, -1)                                # (L, H)
    best = torch.argmax(votes, -1)
    n_inl = torch.gather(votes, 1, best[:, None])[:, 0]
    bdir = torch.gather(ldir3, 1, best[:, None, None].expand(-1, 1, 3))[:, 0]
    binl = torch.gather(inl, 1, best[:, None, None].expand(-1, 1, n_samples))[:, 0]

    # PCA refine over inliers
    wl = binl.to(torch.float32)
    wls = torch.clamp(torch.sum(wl, -1), min=1e-6)
    mu = torch.sum(X * wl[..., None], 1) / wls[:, None]
    dX = (X - mu[:, None]) * wl[..., None]
    cov3 = torch.einsum("lsi,lsj->lij", dX, dX) / wls[:, None, None]
    evals = eig33.eigvals_sym3(cov3)
    v = eig33.smallest_eigvec_sym3(-cov3, -evals[:, 2])
    sign = torch.where(torch.sum(v * bdir, -1, keepdim=True) < 0, -1.0, 1.0)
    dir3d = v * sign.to(v.dtype)
    mu, dir3d = refine_line_mle(X, wl, mu, dir3d)
    tproj = torch.einsum("lsc,lc->ls", X - mu[:, None], dir3d)
    tproj = torch.where(binl, tproj, torch.zeros_like(tproj))
    e1 = mu + torch.amin(tproj, -1, keepdim=True) * dir3d
    e2 = mu + torch.amax(tproj, -1, keepdim=True) * dir3d
    has3d = valid & (n_inl >= max(4, n_samples // 4))

    vp_dir, vp_ok = vp_directions(lineq, seg2d, valid, K4)
    man_dir = torch.where(has3d[:, None], dir3d, vp_dir)
    man_ok = has3d | (valid & vp_ok)

    return LineFeatures(
        seg2d=seg2d, lineq=lineq, desc=desc, dir3d=dir3d,
        ep3d=torch.cat([e1, e2], -1), has3d=has3d, valid=valid,
        response=top_sup, man_dir=man_dir, man_ok=man_ok)
