"""SipMask training loss, the port of ``sipmask_tpu/models/loss.py``.

``compute_losses`` covers the mmdet image path: focal classification loss
(avg factor num_pos + num_imgs), centerness-weighted -log IoU box loss on
stride-normalised decoded boxes (GIoU with ``iou_loss_mode="giou"``),
centerness BCE, and the SP mask loss over a static top-``max_pos`` selection
of each image's positives, ranked by the no-grad weighting sigmoid(cls
score) x IoU(gt/2, det box), SipMask++'s rescoring MSE (``loss_iou``) and
SipMask-VIS's match loss (``loss_match``, with ``match_acc`` as a metric).
The VIS fork decodes the box loss's boxes without the stride division.
Under a process group (``sipmask_tpu_torch.parallel``) every normaliser is
the global batch's: num_pos, the image count, the centerness weights' sum,
the rescoring weights' sum and the match loss's counts are summed over the
ranks without gradient, so each rank's losses are its share of the global
batch's and their sum over the ranks is what one process computes on the
global batch (the JAX package's global-batch SPMD).
``benchmark_loss_extras`` gives the SipMask-benchmark fork's deltas: the
cls normaliser max(num_pos, 1), fcos_core's ltrb-GIoU on relu'd
stride-normalised distances, det boxes from the relu'd regression, no
+1e-4 in the weighting normaliser, an NMS-0.9 dedup of the selected
positives ranked by their gt-label score, and the loss_mask > 1 -> x0.5
cap.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core import losses as L
from ..core.boxes import bbox_overlaps, center_size, distance2bbox
from ..core.points import all_points
from ..core.targets import centerness_target, fcos_targets
from ..ops import mask_loss
from ..ops.crop_split import assemble_masks
from ..ops.nms import NEG, hard_nms
from ..parallel import global_sum, process_shard_args
from .track import track_match_loss


def _flat(levels):
    """NCHW levels -> (B, sum h*w, C), each level flattened in (h, w) order
    as the JAX package's NHWC reshape does, so point indices line up."""
    return torch.cat([x.permute(0, 2, 3, 1).reshape(x.shape[0], -1,
                                                    x.shape[1])
                      for x in levels], 1)


def flatten_outputs(outputs):
    """Head output dict -> level-major flat (cls (B, P, C), box (B, P, 4),
    ctr (B, P), cof (B, P, 4*nb))."""
    return (_flat(outputs["cls_scores"]), _flat(outputs["bbox_preds"]),
            _flat(outputs["centernesses"])[..., 0],
            _flat(outputs["cof_preds"]))


def _take(x, idx):
    """x (B, P, ...) gathered along P by idx (B, K)."""
    return torch.gather(x, 1, idx.reshape(idx.shape + (1,) * (x.dim() - 2))
                        .expand(idx.shape + x.shape[2:]))


def compute_losses(outputs, batch, cfg, max_pos: int = 256,
                   rescore_fn: Optional[Callable] = None):
    """Args:
      outputs: the head's output dict (NCHW, ``SipMaskHead.forward``).
      batch: dict of tensors on the outputs' device: gt_bboxes (B, G, 4) in
        input coordinates, gt_labels (B, G) (0 = padding), gt_masks
        (B, G, H/2, W/2) {0, 1} at the basis resolution; with
        SipMask-VIS's ``track_feats_ref`` in outputs also gt_pids (B, G),
        ref_bboxes_jit (B, G, 4) and ref_labels (B, G) of the reference
        frame (``track.track_match_loss``).
      cfg: a ``HeadConfig`` (``sipmask_tpu_torch.config``).
      rescore_fn: ``SipMask.rescore``, needed iff ``cfg.rescoring``.
    Returns: dict of scalar losses (loss_cls, loss_bbox, loss_centerness,
    loss_mask, loss_iou when rescoring, loss_match and the metric match_acc
    when tracking with a reference frame).
    """
    if cfg.rescoring and rescore_fn is None:
        raise ValueError("a rescoring head needs rescore_fn")
    dev = outputs["feat_masks"].device
    featmap_sizes = [tuple(x.shape[2:]) for x in outputs["cls_scores"]]
    points, strides, ranges = all_points(featmap_sizes, cfg.strides,
                                         cfg.regress_ranges, device=dev)
    cls_logits, bbox_preds, ctr_logits, cof_preds = (
        t.float() for t in flatten_outputs(outputs))
    feat_masks = outputs["feat_masks"].float()            # (B, nb, Hm, Wm)
    b, p, nc = cls_logits.shape
    gt_bboxes = batch["gt_bboxes"].float()
    gt_labels = batch["gt_labels"].long()

    tgt = fcos_targets(gt_bboxes, gt_labels, points, ranges, strides,
                       cfg.center_sampling, cfg.center_sample_radius)
    labels, bbox_targets, gt_inds = (tgt["labels"], tgt["bbox_targets"],
                                     tgt["gt_inds"])
    pos = labels > 0
    num_pos = pos.sum()
    extras = cfg.benchmark_loss_extras
    ctr_targets = centerness_target(bbox_targets.clamp(min=0.0))
    posf = pos.float()
    w_ctr = ctr_targets * posf
    # the global batch's normalisers (this batch's without a process group)
    num_pos, w_ctr_sum = global_sum(num_pos, w_ctr.sum())
    num_imgs = b * process_shard_args()[1]

    # classification, avg factor num_pos + num_imgs (the benchmark fork:
    # max(num_pos, 1))
    loss_cls = L.sigmoid_focal_loss(
        cls_logits, labels, nc, cfg.focal_gamma, cfg.focal_alpha,
        avg_factor=num_pos.clamp(min=1) if extras else num_pos + num_imgs
    ) * cfg.loss_cls_weight

    # box and centerness on stride-normalised decoded boxes; the VIS fork
    # decodes them unnormalised (with the +1 IoU convention the per-level
    # magnitudes differ, so each fork is followed)
    pts = points[None].expand(b, p, 2)
    strd = strides[None, :, None]
    avg_ctr = w_ctr_sum.clamp(min=1e-6)
    if extras:
        # fcos_core's GIoU on relu'd stride-normalised ltrb distances
        loss_bbox = L.giou_loss_ltrb(
            torch.relu(bbox_preds) / strd, bbox_targets / strd,
            weight=w_ctr, avg_factor=avg_ctr)
    else:
        div = 1.0 if cfg.track else strd
        iou_fn = L.giou_loss if cfg.iou_loss_mode == "giou" else L.iou_loss
        loss_bbox = iou_fn(
            distance2bbox(pts, bbox_preds / div),
            distance2bbox(pts, bbox_targets / div), weight=w_ctr,
            avg_factor=avg_ctr)
    loss_bbox = loss_bbox * cfg.loss_bbox_weight
    loss_centerness = L.bce_with_logits(
        ctr_logits, ctr_targets, weight=posf,
        avg_factor=num_pos.clamp(min=1)) * cfg.loss_centerness_weight

    # mask loss: per image, the top max_pos positives by the no-grad
    # weighting; boxes in mask (stride-2) coordinates, from the relu'd
    # regression in the benchmark fork
    det_dist = bbox_preds.detach()
    bbox_dt = distance2bbox(pts, det_dist.relu() if extras else det_dist
                            ) / 2.0                           # (B, P, 4)
    area = ((bbox_dt[..., 2] - bbox_dt[..., 0]) *
            (bbox_dt[..., 3] - bbox_dt[..., 1]))
    valid = pos & (area > 1.0)
    lbl = (labels - 1).clamp(min=0)
    cls_score = torch.sigmoid(torch.gather(cls_logits.detach(), 2,
                                           lbl[..., None])[..., 0])
    gt_sel = _take(gt_bboxes, gt_inds)                        # (B, P, 4)
    ious = bbox_overlaps(gt_sel / 2.0, bbox_dt, is_aligned=True, eps=1e-9)
    w_raw = cls_score * ious
    score = torch.where(valid, w_raw, torch.full_like(w_raw, -1.0))
    k = min(max_pos, p)
    # a stable descending sort keeps lax.top_k's lower-index-first ties
    topw, topi = torch.sort(score, stable=True, dim=1, descending=True)
    topw, topi = topw[:, :k], topi[:, :k]
    sel_valid = topw > -0.5
    n_sel = sel_valid.sum(1).float().clamp(min=1.0)
    cof_sel = _take(cof_preds, topi)                          # (B, K, 4*nb)
    box_sel = _take(bbox_dt, topi)                            # (B, K, 4)
    gtidx_sel = torch.gather(gt_inds, 1, topi)
    w_sel = torch.where(sel_valid, torch.gather(w_raw, 1, topi),
                        torch.zeros_like(topw))
    # weighting renormalised over the selected set (mmdet's +1e-4; the
    # benchmark fork adds nothing)
    w_norm = w_sel / (w_sel.sum(1, keepdim=True)
                      + (0.0 if extras else 1e-4)).clamp(min=1e-20) \
        * n_sel[:, None]
    if extras:
        # the benchmark fork's NMS-0.9 dedup of the selected positives
        # (+1 IoU), ranked by the sigmoid of their gt label's logit; the
        # weighting above keeps the count before it, the per-pixel divisor
        # below takes the count after it
        nms_scores = torch.where(sel_valid, torch.gather(cls_score, 1, topi),
                                 torch.full_like(topw, NEG))
        kidx, _, kvalid = hard_nms(box_sel, nms_scores, 0.9, k)
        kept = torch.zeros((b, k + 1), dtype=torch.bool, device=dev)
        kept.scatter_(1, torch.where(kvalid, kidx, k), True)
        final_valid = sel_valid & kept[:, :k]
    else:
        final_valid = sel_valid
    n_final = final_valid.sum(1).float().clamp(min=1.0)

    pre = mask_loss.mask_bce_loss(feat_masks, cof_sel, box_sel,
                                  batch["gt_masks"], gtidx_sel, final_valid)
    csz = center_size(box_sel)
    ones = torch.ones_like(topw)
    bw = torch.where(final_valid, csz[..., 2], ones)
    bh = torch.where(final_valid, csz[..., 3], ones)
    pre = pre / bw / bh / n_final[:, None]
    loss_mask = torch.where(final_valid, pre * w_norm,
                            torch.zeros_like(pre)).sum() / num_imgs
    if extras:   # the benchmark fork caps a runaway mask loss (the global
        # batch's: a rank's share is halved where the sum of the shares is
        # over 1)
        whole, = global_sum(loss_mask)
        loss_mask = torch.where(whole > 1.0, loss_mask * 0.5, loss_mask)
    out = dict(loss_cls=loss_cls, loss_bbox=loss_bbox,
               loss_centerness=loss_centerness, loss_mask=loss_mask)
    if cfg.rescoring:
        out["loss_iou"] = _rescoring_loss(
            feat_masks, batch["gt_masks"], cof_sel, box_sel, gtidx_sel,
            sel_valid, torch.gather(lbl, 1, topi), rescore_fn)
    if cfg.track and "track_feats_ref" in outputs:
        out["loss_match"], match_acc = track_match_loss(
            outputs, batch, box_sel, sel_valid, gtidx_sel)
        out["match_acc"] = match_acc.detach()   # a metric, not a loss
    return out


def _rescoring_loss(feat_masks, gt_masks, cof_sel, box_sel, gtidx_sel,
                    sel_valid, labels_sel, rescore_fn):
    """SipMask++ rescoring MSE (the reference's sipmask_head.py:466-486).

    The predicted masks are assembled with no gradient (kernel K6 on the
    card); each IoU target compares the thresholded, box-cropped predicted
    mask with the *uncropped* selected gt mask; weights keep
    0.1 < iou <= 1 with gt area >= 100; total = 10 * sum(w * MSE) /
    max(sum(w), 0.1).
    """
    b, k = gtidx_sel.shape
    with torch.no_grad():
        pred = assemble_masks(feat_masks.detach().permute(0, 2, 3, 1),
                              cof_sel.detach(), box_sel)   # (B, H, W, K)
        pred = pred.permute(0, 3, 1, 2).contiguous()       # (B, K, H, W)
        rows = torch.arange(b, device=gtidx_sel.device)[:, None]
        gt_m = gt_masks[rows, gtidx_sel.long()].float()     # (B, K, H, W)
        mp = (pred > 0.4).float()
        inter = (mp * gt_m).sum((2, 3))
        gt_area = gt_m.sum((2, 3))
        iou_t = inter / (mp.sum((2, 3)) + gt_area - inter + 0.1)
        w = ((iou_t > 0.1) & (iou_t <= 1.0) & (gt_area >= 100)
             & sel_valid).float()
    scores = rescore_fn(pred.reshape(b * k, 1, *pred.shape[2:]))  # (BK, C)
    pred_iou = torch.gather(scores, 1, labels_sel.reshape(b * k, 1))[:, 0]
    # a bf16 pred_iou (the bf16 graph) minus the f32 targets is f32, as in
    # JAX
    mse = ((pred_iou - iou_t.reshape(b * k)) ** 2 * w.reshape(b * k)).sum()
    # the reference divides by the count exactly (the global batch's);
    # max(., 0.1) only guards the empty case
    w_sum, = global_sum(w.sum())
    return mse * 10.0 / w_sum.clamp(min=0.1)
