"""Inference decode: scores -> per-level top-k -> NMS -> SP mask assembly
(-> SipMask++ rescoring). The port of ``sipmask_tpu/models/decode.py:
decode_batch``: the exact multiclass NMS, hard or soft (``test.nms_type``),
and the ``fast_nms`` branch (``ssd_flag`` / ``use_fast_nms``).

The per-image loop picks each image's detections; the masks of the whole
batch are then assembled in one call (kernel K6 on the card).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..core.boxes import distance2bbox
from ..core.points import all_points
from ..ops.crop_split import assemble_masks
from ..ops.nms import fast_nms, multiclass_nms_idx
from .loss import flatten_outputs


def decode_batch(outputs, img_shapes, scale_factors, cfg,
                 rescore_fn: Optional[Callable] = None):
    """Args:
      outputs: SipMaskHead output dict (NCHW levels).
      img_shapes: (B, 2) (h, w) of the resized image before padding; boxes
        are clamped to it.
      scale_factors: (B, 4) (sx, sy, sx, sy), resized over original.
      cfg: a ``ModelConfig`` (``sipmask_tpu_torch.config``).
      rescore_fn: SipMask++'s ``SipMask.rescore``, needed iff
        ``head.rescoring``; it adds ``mask_scores``.

    Returns dict of per-image padded results: boxes (B, D, 4) in
    original-image coordinates, scores (B, D), labels (B, D) 0-based,
    masks (B, D, Hm, Wm) sigmoid probabilities on the stride-2 grid, cropped
    to the boxes, valid (B, D) [+ mask_scores (B, D) when rescoring].
    """
    t, h = cfg.test, cfg.head
    use_fast = t.use_fast_nms or h.ssd_flag
    if h.rescoring and rescore_fn is None:
        raise ValueError("a rescoring head needs rescore_fn")
    featmap_sizes = [tuple(x.shape[2:]) for x in outputs["cls_scores"]]
    dev = outputs["feat_masks"].device
    points = all_points(featmap_sizes, h.strides, device=dev)[0]
    level_sizes = [hh * ww for hh, ww in featmap_sizes]

    cls_logits, bbox_preds, ctr_logits, cof_preds = flatten_outputs(outputs)
    scores_all = torch.sigmoid(cls_logits.float())
    ctr_all = torch.sigmoid(ctr_logits.float())
    basis_all = outputs["feat_masks"].float().permute(0, 2, 3, 1)
    img_shapes = img_shapes.float().to(dev)
    scale_factors = scale_factors.float().to(dev)

    results, det_cofs, crop_boxes = [], [], []
    for i in range(scores_all.shape[0]):
        scores, ctr = scores_all[i], ctr_all[i]
        # per-level top nms_pre by max_c(score * centerness); the stable
        # sort keeps lax.top_k's lower-index-first order among ties
        sel = []
        start = 0
        for n in level_sizes:
            rank = (scores[start:start + n] * ctr[start:start + n, None]
                    ).max(1).values
            order = torch.sort(rank, descending=True, stable=True).indices
            sel.append(order[:min(t.nms_pre, n)] + start)
            start += n
        sel = torch.cat(sel)
        boxes = distance2bbox(points[sel], bbox_preds[i, sel].float())
        hh, ww = img_shapes[i, 0], img_shapes[i, 1]
        zero = torch.zeros((), device=dev)
        boxes = torch.stack([boxes[:, 0].clamp(zero, ww - 1),
                             boxes[:, 1].clamp(zero, hh - 1),
                             boxes[:, 2].clamp(zero, ww - 1),
                             boxes[:, 3].clamp(zero, hh - 1)], -1)
        sf = scale_factors[i]
        boxes = boxes / sf[None, :]
        cofs = cof_preds[i, sel].float()
        if use_fast:
            eff = scores[sel] * ctr[sel, None]
            res = fast_nms(boxes, eff.t(), cofs, iou_thr=t.nms_iou_thr,
                           top_k=t.fast_nms_top_k, score_thr=t.score_thr,
                           max_out=t.max_per_img)
            det_cofs.append(res["cofs"])
        else:
            res = multiclass_nms_idx(boxes, scores[sel], t.score_thr,
                                     t.nms_iou_thr, t.max_per_img,
                                     score_factors=ctr[sel],
                                     nms_type=t.nms_type,
                                     soft_method=t.soft_nms_method,
                                     soft_sigma=t.soft_nms_sigma,
                                     soft_min_score=t.soft_nms_min_score)
            det_cofs.append(cofs[res["idxs"]] * res["valid"][:, None])
        crop_boxes.append(res["boxes"] * sf[None, :] / 2.0)
        results.append({k: res[k] for k in ("boxes", "scores", "labels",
                                            "valid")})
    out = {k: torch.stack([r[k] for r in results]) for k in results[0]}
    masks = assemble_masks(basis_all, torch.stack(det_cofs),
                           torch.stack(crop_boxes))        # (B, Hm, Wm, D)
    out["masks"] = masks.permute(0, 3, 1, 2).contiguous()  # (B, D, Hm, Wm)

    if h.rescoring:
        b, d, mh, mw = out["masks"].shape
        pred_iou = rescore_fn(out["masks"].reshape(b * d, 1, mh, mw))
        lbl = out["labels"].reshape(b * d).clamp(min=0)
        pred_iou = torch.gather(pred_iou, 1, lbl[:, None])[:, 0]
        # bf16 IoU predictions (the bf16 graph) times the f32 scores: f32,
        # as JAX promotes them
        out["mask_scores"] = (pred_iou.reshape(b, d) * out["scores"] *
                              out["valid"])
    return out
