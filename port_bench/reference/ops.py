"""Plain PyTorch operations of SipMask's mathematics, frozen for the
benchmark: box geometry, FCOS points, deformable bilinear sampling by
gathers, GroupNorm with ReLU, SP (spatial-preservation) mask assembly,
the per-positive mask BCE, and YOLACT's fast NMS.

Nothing here imports the program. Every function runs on any device and
in any float type; the benchmark runs it in float32 with TF32 off.

A recorder (:data:`CALLS`) notes the shapes of the calls that the program
hands to its hand-written kernels (deformable sampling, GroupNorm, mask
BCE, mask assembly), so that ``roofline.py`` can count their bytes and
operations from a run of this reference on the ``meta`` device.
"""

from __future__ import annotations

import contextvars

import torch
import torch.nn.functional as F

NEG = -1.0e4

# None, or a list that each kernel-shaped call appends (name, shapes) to
CALLS = contextvars.ContextVar("calls", default=None)


def _note(name, **shapes):
    calls = CALLS.get()
    if calls is not None:
        calls.append((name, shapes))


# ------------------------------------------------------------- geometry

def bbox_overlaps_aligned(a, b, eps: float = 0.0):
    """IoU of aligned xyxy boxes with the +1 pixel convention."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt + 1).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0] + 1) * (a[..., 3] - a[..., 1] + 1)
    area_b = (b[..., 2] - b[..., 0] + 1) * (b[..., 3] - b[..., 1] + 1)
    return overlap / (area_a + area_b - overlap + eps)


def jaccard(a, b):
    """Pairwise IoU without the +1 (YOLACT's): (..., A, 4), (..., B, 4) ->
    (..., A, B); 0 where the union is not positive."""
    max_xy = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    min_xy = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    wh = (max_xy - min_xy).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]))[..., :, None]
    area_b = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))[..., None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def distance2bbox(points, d):
    x, y = points[..., 0], points[..., 1]
    return torch.stack([x - d[..., 0], y - d[..., 1], x + d[..., 2],
                        y + d[..., 3]], -1)


def points(sizes, strides, ranges, device):
    """FCOS points of every level, level-major, row-major in each:
    ((P, 2) [x, y] pixel centres, (P,) strides, (P, 2) regress ranges)."""
    pts, strd, rng = [], [], []
    for (h, w), s, r in zip(sizes, strides, ranges):
        ys, xs = torch.meshgrid(
            torch.arange(h, device=device, dtype=torch.float32) * s + s // 2,
            torch.arange(w, device=device, dtype=torch.float32) * s + s // 2,
            indexing="ij")
        pts.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], -1))
        strd.append(torch.full((h * w,), float(s), device=device))
        rng.append(torch.tensor(r, dtype=torch.float32, device=device)
                   .expand(h * w, 2))
    return torch.cat(pts), torch.cat(strd), torch.cat(rng)


# ------------------------------------------------- deformable convolution

def deform_conv(x, offsets, weight, stride: int, groups: int, kernel: str):
    """3x3 deformable convolution v1 with padding 1, by four gathers.

    x (B, C, H, W); offsets (B, groups*18, Ho, Wo), [dy, dx] per tap,
    group-major; weight (O, C, 3, 3). A corner outside the map reads 0.
    ``kernel`` names the program's kernel for this call (``im2col``: the
    head's FeatureAlign, ``rows``: the backbone's DCN) for the recorder.
    """
    b, c, h, w = x.shape
    _, _, ho, wo = offsets.shape
    k, p, cg = 9, ho * wo, c // groups
    _note(kernel, x=tuple(x.shape), offsets=tuple(offsets.shape),
          out=(b, weight.shape[0], ho, wo), groups=groups)
    off = offsets.reshape(b, groups, k, 2, p)
    dev, dt = x.device, offsets.dtype
    ty = torch.arange(3, device=dev, dtype=dt).repeat_interleave(3)
    tx = torch.arange(3, device=dev, dtype=dt).repeat(3)
    by = (torch.arange(ho, device=dev, dtype=dt) * stride - 1)
    bx = (torch.arange(wo, device=dev, dtype=dt) * stride - 1)
    py = (by[None, :, None] + ty[:, None, None]).expand(k, ho, wo).reshape(
        k, p) + off[:, :, :, 0]
    px = (bx[None, None, :] + tx[:, None, None]).expand(k, ho, wo).reshape(
        k, p) + off[:, :, :, 1]
    y0, x0 = torch.floor(py), torch.floor(px)
    xg = x.reshape(b, groups, cg, h * w)
    cols = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy, xx = y0 + dy, x0 + dx
            wgt = ((py - y0 if dy else 1.0 - (py - y0)) *
                   (px - x0 if dx else 1.0 - (px - x0)))
            inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
            # a non-finite offset (a diverged model) reads pixel 0, where
            # casting it would index out of the map
            q = (yy.nan_to_num(0.0).clamp(0, h - 1) * w
                 + xx.nan_to_num(0.0).clamp(0, w - 1)).long()
            v = torch.gather(xg, 3, q.reshape(b, groups, 1, k * p)
                             .expand(b, groups, cg, k * p))
            cols = cols + v.reshape(b, groups, cg, k, p) * (
                wgt * inside).reshape(b, groups, 1, k, p)
    # (B, G, Cg, K, P) against weight (O, G, Cg, K)
    wg = weight.reshape(weight.shape[0], groups, cg, k)
    out = torch.einsum("bgckp,ogck->bop", cols, wg)
    return out.reshape(b, weight.shape[0], ho, wo)


def gn_relu(x, weight, bias, groups: int = 32, eps: float = 1e-5,
            act: bool = True):
    _note("gn", x=tuple(x.shape))
    y = F.group_norm(x, groups, weight, bias, eps)
    return torch.relu(y) if act else y


# ------------------------------------------------------- SP mask assembly

def _quadrant_logits(basis, cofs, boxes):
    """One image: basis (h, w, nb), cofs (N, 4*nb), boxes (N, 4) in mask
    coordinates -> (logits (h, w, N), in_box (h, w, N) bool).

    Pixel (r, c) lies in box n iff c >= x1, r >= y1, c < x2 and r < y2; it
    takes the right coefficients when c >= x1 + (x2 - x1 + 0.1) / 2 and the
    lower ones when r >= y1 + (y2 - y1 + 0.1) / 2; the planes are ordered
    top-left, top-right, bottom-left, bottom-right."""
    h, w, nb = basis.shape
    n = cofs.shape[0]
    dev, dt = basis.device, basis.dtype
    cc = torch.arange(w, device=dev, dtype=dt)[None, :, None]
    rr = torch.arange(h, device=dev, dtype=dt)[:, None, None]
    x1, y1, x2, y2 = boxes.unbind(-1)
    in_box = (cc >= x1) & (cc < x2) & (rr >= y1) & (rr < y2)
    right = (cc >= x1 + (x2 - x1 + 0.1) / 2).to(dt)[0]    # (w, N)
    lower = (rr >= y1 + (y2 - y1 + 0.1) / 2).to(dt)       # (h, 1, N)
    # the coefficients of each column's half (a select), then one product
    # per half: (w, h, nb) x (w, nb, N)
    c = cofs.reshape(n, 4, nb)
    r = right[:, :, None]
    c_top = (1 - r) * c[:, 0][None] + r * c[:, 1][None]     # (w, N, nb)
    c_bot = (1 - r) * c[:, 2][None] + r * c[:, 3][None]
    cols = basis.permute(1, 0, 2)
    top = torch.matmul(cols, c_top.transpose(1, 2)).permute(1, 0, 2)
    bot = torch.matmul(cols, c_bot.transpose(1, 2)).permute(1, 0, 2)
    return top * (1 - lower) + bot * lower, in_box


def assemble_masks(basis, cofs, boxes):
    """(B, h, w, nb), (B, N, 4*nb), (B, N, 4) -> (B, N, h, w) sigmoid
    probabilities, 0 outside each box."""
    _note("assemble", basis=tuple(basis.shape), cofs=tuple(cofs.shape))
    out = []
    for i in range(basis.shape[0]):
        logits, in_box = _quadrant_logits(basis[i], cofs[i], boxes[i])
        out.append((torch.sigmoid(logits) * in_box).permute(2, 0, 1))
    return torch.stack(out)


def mask_bce(basis, cofs, boxes, gt_masks, gt_idx, valid):
    """Per positive, the BCE of its assembled mask logits against its gt
    mask, summed over the pixels in its box: basis (B, nb, h, w), cofs
    (B, K, 4*nb), boxes (B, K, 4) in mask coordinates (no gradient),
    gt_masks (B, G, h, w), gt_idx (B, K), valid (B, K) -> (B, K), 0 where
    not valid. Differentiable in basis and cofs."""
    _note("mask_bce", basis=tuple(basis.shape), cofs=tuple(cofs.shape),
          gt=tuple(gt_masks.shape))
    rows = []
    for i in range(basis.shape[0]):
        logits, in_box = _quadrant_logits(basis[i].permute(1, 2, 0), cofs[i],
                                          boxes[i].detach())
        gt = gt_masks[i][gt_idx[i].long()].permute(1, 2, 0).to(logits.dtype)
        bce = F.binary_cross_entropy_with_logits(logits, gt,
                                                 reduction="none")
        rows.append((bce * in_box).sum((0, 1)))
    pre = torch.stack(rows)
    return torch.where(valid, pre, torch.zeros_like(pre))


# ------------------------------------------------------------ fast NMS

def top(x, k: int):
    """Descending top-k on the last axis, ties to the lower index."""
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]


def fast_nms(boxes, scores_cn, cofs, iou_thr, top_k, score_thr, max_out):
    """YOLACT's matrix NMS: per class its top ``top_k`` scores; a box goes
    when a higher-scored box of its class overlaps it by more than
    ``iou_thr`` or its score is at most ``score_thr``; then the top
    ``max_out`` over all classes. boxes (N, 4), scores_cn (C, N), cofs
    (N, D)."""
    c, n = scores_cn.shape
    k = min(top_k, n)
    s, idx = top(scores_cn, k)
    b = boxes[idx.reshape(-1)].reshape(c, k, 4)
    iou_max = torch.triu(jaccard(b, b), diagonal=1).max(dim=1).values
    keep = (iou_max <= iou_thr) & (s > score_thr)
    masked = torch.where(keep, s, torch.full_like(s, NEG)).reshape(-1)
    out_s, flat = top(masked, max_out)
    picked = idx.reshape(-1)[flat]
    valid = out_s > NEG / 2
    vf = valid[:, None].to(boxes.dtype)
    return dict(boxes=boxes[picked] * vf,
                scores=torch.where(valid, out_s, torch.zeros_like(out_s)),
                labels=torch.where(valid, flat // k,
                                   torch.full_like(flat, -1)),
                cofs=cofs[picked] * vf, valid=valid)
