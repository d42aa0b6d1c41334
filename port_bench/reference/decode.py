"""SipMask's inference decode in plain PyTorch, the fast-NMS branch of the
real-time and SipMask++ models: per level the top ``nms_pre`` points by
max over classes of score x centerness, boxes clamped to the image and
scaled back to the original, YOLACT's fast NMS, SP mask assembly on the
stride-2 grid, and SipMask++'s mask scores (predicted mask IoU x score).

``test`` is the ``model.test`` object of a configuration file.
"""

from __future__ import annotations

import torch

from . import ops
from .loss import flatten


def decode(out, img_shapes, scale_factors, head, test, rescore=None):
    """Head outputs of a batch -> dict of (B, D, ...) tensors: boxes in
    original coordinates, scores, labels (0-based, -1 empty), masks
    (B, D, h, w) probabilities, valid, and mask_scores with rescoring."""
    sizes = [tuple(x.shape[2:]) for x in out["cls_scores"]]
    dev = out["feat_masks"].device
    pts = ops.points(sizes, head["strides"], head["regress_ranges"], dev)[0]
    scores_all = torch.sigmoid(flatten(out["cls_scores"]))
    ctr_all = torch.sigmoid(flatten(out["centernesses"])[..., 0])
    box_all = flatten(out["bbox_preds"])
    cof_all = flatten(out["cof_preds"])
    basis = out["feat_masks"].permute(0, 2, 3, 1)
    res, cofs, crops = [], [], []
    for i in range(scores_all.shape[0]):
        sc, ct = scores_all[i], ctr_all[i]
        sel, start = [], 0
        for h, w in sizes:
            n = h * w
            rank = (sc[start:start + n] * ct[start:start + n, None]).amax(1)
            sel.append(ops.top(rank, min(test["nms_pre"], n))[1] + start)
            start += n
        sel = torch.cat(sel)
        boxes = ops.distance2bbox(pts[sel], box_all[i, sel])
        hh, ww = img_shapes[i, 0].float(), img_shapes[i, 1].float()
        zero = torch.zeros((), device=dev)
        boxes = torch.stack([boxes[:, 0].clamp(zero, ww - 1),
                             boxes[:, 1].clamp(zero, hh - 1),
                             boxes[:, 2].clamp(zero, ww - 1),
                             boxes[:, 3].clamp(zero, hh - 1)], -1)
        sf = scale_factors[i].float()
        boxes = boxes / sf[None]
        r = ops.fast_nms(boxes, (sc[sel] * ct[sel, None]).t(), cof_all[i, sel],
                         test["nms_iou_thr"], test["fast_nms_top_k"],
                         test["score_thr"], test["max_per_img"])
        cofs.append(r["cofs"])
        crops.append(r["boxes"] * sf[None] / 2.0)
        res.append(r)
    dec = {k: torch.stack([r[k] for r in res])
           for k in ("boxes", "scores", "labels", "valid")}
    dec["masks"] = ops.assemble_masks(basis, torch.stack(cofs),
                                      torch.stack(crops))
    if rescore is not None:
        b, d, mh, mw = dec["masks"].shape
        iou = rescore(dec["masks"].reshape(b * d, 1, mh, mw))
        lbl = dec["labels"].reshape(-1).clamp(min=0)
        iou = torch.gather(iou, 1, lbl[:, None])[:, 0].reshape(b, d)
        dec["mask_scores"] = iou * dec["scores"] * dec["valid"]
    return dec
