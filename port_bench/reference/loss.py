"""SipMask's training loss in plain PyTorch: FCOS targets with centre
sampling, the focal loss, the -log IoU box loss weighted by centerness,
the centerness BCE, the SP mask loss over each image's top ``max_pos``
positives (ranked by sigmoid(class score) x IoU(gt, box), renormalised
over the selection), and SipMask++'s rescoring MSE.

Boxes follow mmdetection v1's +1 pixel convention; ``head`` is the
``model.head`` object of a configuration file, ``max_pos`` its
``train.max_pos``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import ops

INF = 1e8


def flatten(levels):
    """NCHW levels -> (B, sum h*w, C), each level row-major."""
    return torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1,
                                                    x.shape[1])
                      for x in levels], 1)


def fcos_targets(gt_boxes, gt_labels, pts, strides, ranges, radius):
    """labels (B, P) (0 = background), ltrb targets (B, P, 4) and the
    assigned gt row (B, P): among the gts whose centre region (radius x
    stride, inside the box) holds the point and whose largest distance is
    in the level's range, the one of least area, the first on ties."""
    valid = gt_labels > 0
    areas = ((gt_boxes[..., 2] - gt_boxes[..., 0] + 1) *
             (gt_boxes[..., 3] - gt_boxes[..., 1] + 1))
    areas = torch.where(valid, areas, torch.full_like(areas, INF))
    xs, ys = pts[None, :, None, 0], pts[None, :, None, 1]
    x1, y1, x2, y2 = (gt_boxes[:, None, :, i] for i in range(4))
    ltrb = torch.stack([xs - x1, ys - y1, x2 - xs, y2 - ys], -1)
    cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
    r = strides[None, :, None] * radius
    centre = torch.stack([xs - torch.maximum(cx - r, x1),
                          ys - torch.maximum(cy - r, y1),
                          torch.minimum(cx + r, x2) - xs,
                          torch.minimum(cy + r, y2) - ys], -1)
    far = ltrb.amax(-1)
    ok = ((centre.amin(-1) > 0) & (far >= ranges[None, :, None, 0])
          & (far <= ranges[None, :, None, 1]))
    cand = torch.where(ok, areas[:, None, :], torch.full_like(far, INF))
    least = cand.amin(-1)
    g = cand.shape[-1]
    idx = torch.arange(g, device=cand.device).expand_as(cand)
    gt_inds = torch.where(cand == least[..., None], idx,
                          torch.full_like(idx, g)).amin(-1)
    labels = torch.gather(gt_labels.long(), 1, gt_inds)
    labels = torch.where(least >= INF, torch.zeros_like(labels), labels)
    ltrb = torch.gather(ltrb, 2, gt_inds[:, :, None, None].expand(
        -1, -1, 1, 4))[:, :, 0]
    return labels, ltrb, gt_inds


def centerness(ltrb):
    lr, tb = ltrb[..., 0::2], ltrb[..., 1::2]
    ratio = (lr.amin(-1) / lr.amax(-1).clamp(min=1e-12)) * (
        tb.amin(-1) / tb.amax(-1).clamp(min=1e-12))
    return torch.sqrt(ratio.clamp(min=0.0))


def focal_loss(logits, labels, gamma, alpha):
    t = F.one_hot((labels - 1).clamp(min=0), logits.shape[-1]).to(
        logits.dtype) * (labels > 0)[..., None]
    p = torch.sigmoid(logits)
    pt = (1 - p) * t + p * (1 - t)
    w = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    return (F.binary_cross_entropy_with_logits(logits, t, reduction="none")
            * w).sum()


def _take(x, idx):
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def losses(out, batch, head, max_pos, rescore=None):
    """The dict of scalar losses of one batch (loss_cls, loss_bbox,
    loss_centerness, loss_mask, and loss_iou with rescoring)."""
    sizes = [tuple(x.shape[2:]) for x in out["cls_scores"]]
    dev = out["feat_masks"].device
    pts, strides, ranges = ops.points(sizes, head["strides"],
                                      head["regress_ranges"], dev)
    cls = flatten(out["cls_scores"])
    box = flatten(out["bbox_preds"])
    ctr = flatten(out["centernesses"])[..., 0]
    cof = flatten(out["cof_preds"])
    basis = out["feat_masks"]
    b, p, _ = cls.shape
    gt_boxes = batch["gt_bboxes"].float()
    labels, ltrb, gt_inds = fcos_targets(
        gt_boxes, batch["gt_labels"].long(), pts, strides, ranges,
        head["center_sample_radius"])
    pos = labels > 0
    posf = pos.float()
    num_pos = posf.sum()
    ctr_t = centerness(ltrb.clamp(min=0.0))
    w_ctr = ctr_t * posf

    loss_cls = focal_loss(cls, labels, head["focal_gamma"],
                          head["focal_alpha"]) / (num_pos + b)
    pp = pts[None].expand(b, p, 2)
    s = strides[None, :, None]
    ious = ops.bbox_overlaps_aligned(
        ops.distance2bbox(pp, box / s),
        ops.distance2bbox(pp, ltrb / s)).clamp(min=1e-6)
    loss_bbox = (-torch.log(ious) * w_ctr).sum() / w_ctr.sum().clamp(
        min=1e-6)
    loss_ctr = (F.binary_cross_entropy_with_logits(ctr, ctr_t,
                                                   reduction="none")
                * posf).sum() / num_pos.clamp(min=1)

    # the mask loss over each image's top max_pos positives
    det = ops.distance2bbox(pp, box.detach()) / 2.0
    area = (det[..., 2] - det[..., 0]) * (det[..., 3] - det[..., 1])
    ok = pos & (area > 1.0)
    lbl = (labels - 1).clamp(min=0)
    score = torch.sigmoid(
        torch.gather(cls.detach(), 2, lbl[..., None])[..., 0])
    iou = ops.bbox_overlaps_aligned(_take(gt_boxes, gt_inds) / 2.0, det,
                                    eps=1e-9)
    w_raw = score * iou
    rank = torch.where(ok, w_raw, torch.full_like(w_raw, -1.0))
    k = min(max_pos, p)
    top_w, top_i = ops.top(rank, k)
    sel = top_w > -0.5
    n_sel = sel.sum(1).float().clamp(min=1.0)
    cof_s, box_s = _take(cof, top_i), _take(det, top_i)
    gti_s = torch.gather(gt_inds, 1, top_i)
    w_s = torch.where(sel, torch.gather(w_raw, 1, top_i),
                      torch.zeros_like(top_w))
    w_n = w_s / (w_s.sum(1, keepdim=True) + 1e-4) * n_sel[:, None]
    pre = ops.mask_bce(basis, cof_s, box_s, batch["gt_masks"], gti_s, sel)
    one = torch.ones_like(top_w)
    bw = torch.where(sel, box_s[..., 2] - box_s[..., 0], one)
    bh = torch.where(sel, box_s[..., 3] - box_s[..., 1], one)
    pre = pre / bw / bh / n_sel[:, None]
    loss_mask = torch.where(sel, pre * w_n, torch.zeros_like(pre)).sum() / b
    res = dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
               loss_centerness=loss_ctr, loss_mask=loss_mask)
    if rescore is not None:
        res["loss_iou"] = rescoring_loss(
            basis, batch["gt_masks"], cof_s, box_s, gti_s, sel,
            torch.gather(lbl, 1, top_i), rescore)
    return res


def rescoring_loss(basis, gt_masks, cof_s, box_s, gti_s, sel, lbl_s, rescore):
    """SipMask++'s rescoring MSE: each selected positive's assembled mask
    (no gradient), thresholded at 0.4, against its whole gt mask gives an
    IoU target (+0.1 in the union); positives with 0.1 < IoU <= 1 and a gt
    of 100 pixels or more count; 10 x sum of squared errors / their
    number."""
    b, k = gti_s.shape
    with torch.no_grad():
        pred = ops.assemble_masks(basis.detach().permute(0, 2, 3, 1),
                                  cof_s.detach(), box_s)      # (B, K, h, w)
        rows = torch.arange(b, device=gti_s.device)[:, None]
        gt = gt_masks[rows, gti_s.long()].float()
        mp = (pred > 0.4).float()
        inter = (mp * gt).sum((2, 3))
        gt_area = gt.sum((2, 3))
        iou_t = inter / (mp.sum((2, 3)) + gt_area - inter + 0.1)
        w = ((iou_t > 0.1) & (iou_t <= 1.0) & (gt_area >= 100) & sel).float()
    scores = rescore(pred.reshape(b * k, 1, *pred.shape[2:]))
    pred_iou = torch.gather(scores, 1, lbl_s.reshape(b * k, 1))[:, 0]
    mse = ((pred_iou - iou_t.reshape(-1)) ** 2 * w.reshape(-1)).sum()
    return mse * 10.0 / w.sum().clamp(min=0.1)
