"""Inference decode: scores -> per-level top-k -> exact hard NMS -> SP mask
assembly. The port of ``sipmask_tpu/models/decode.py:decode_batch`` for the
hard-NMS path without rescoring (``fast_nms`` and soft-NMS are not ported
yet)."""

from __future__ import annotations

import torch

from ..core.boxes import distance2bbox
from ..core.points import all_points
from ..ops.crop_split import assemble_masks
from ..ops.nms import multiclass_nms_idx
from .loss import flatten_outputs


def decode_batch(outputs, img_shapes, scale_factors, cfg):
    """Args:
      outputs: SipMaskHead output dict (NCHW levels).
      img_shapes: (B, 2) (h, w) of the resized image before padding; boxes
        are clamped to it.
      scale_factors: (B, 4) (sx, sy, sx, sy), resized over original.
      cfg: the JAX package's ``ModelConfig``.

    Returns dict of per-image padded results: boxes (B, D, 4) in
    original-image coordinates, scores (B, D), labels (B, D) 0-based,
    masks (B, D, Hm, Wm) sigmoid probabilities on the stride-2 grid, cropped
    to the boxes, valid (B, D).
    """
    t, h = cfg.test, cfg.head
    if t.use_fast_nms or h.ssd_flag or t.nms_type != "nms":
        raise NotImplementedError("only the hard multiclass NMS path is "
                                  "ported")
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

    results = []
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
        res = multiclass_nms_idx(boxes, scores[sel], t.score_thr,
                                 t.nms_iou_thr, t.max_per_img,
                                 score_factors=ctr[sel])
        det_cofs = cof_preds[i, sel].float()[res["idxs"]] * \
            res["valid"][:, None]
        crop_boxes = res["boxes"] * sf[None, :] / 2.0
        masks = assemble_masks(basis_all[i], det_cofs, crop_boxes)
        results.append(dict(boxes=res["boxes"], scores=res["scores"],
                            labels=res["labels"], valid=res["valid"],
                            masks=masks.permute(2, 0, 1)))
    return {k: torch.stack([r[k] for r in results]) for k in results[0]}
