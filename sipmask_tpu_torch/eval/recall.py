"""Proposal recall (AR@N), the port of ``sipmask_tpu/eval/recall.py``: the
reference's ``fast_eval_recall`` protocol (SipMask-mmdetection's
mmdet/datasets/coco.py:239-258 and core/evaluation/recall.py
``eval_recalls``), in numpy:

- per image, the IoUs of the gts and the top-N score-sorted proposals
  (the +1 pixel-area convention of core/evaluation/bbox_overlaps.py);
- greedy one-to-one matching: take the (gt, proposal) pair of the globally
  best IoU, record it for that gt, retire both, repeat;
- AR@N at threshold t: the share of all gts whose matched IoU is >= t.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bbox_overlaps_plus1(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU for xyxy boxes with the +1 area convention the
    reference's recall path uses (core/evaluation/bbox_overlaps.py)."""
    if a.size == 0 or b.size == 0:
        return np.zeros((a.shape[0], b.shape[0]), np.float32)
    ax1, ay1, ax2, ay2 = (a[:, k, None] for k in range(4))
    bx1, by1, bx2, by2 = (b[None, :, k] for k in range(4))
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1) + 1, 0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1) + 1, 0)
    inter = iw * ih
    area_a = (ax2 - ax1 + 1) * (ay2 - ay1 + 1)
    area_b = (bx2 - bx1 + 1) * (by2 - by1 + 1)
    return (inter / np.maximum(area_a + area_b - inter, 1e-9)).astype(
        np.float32)


def _matched_gt_ious(ious: np.ndarray) -> np.ndarray:
    """Greedy global-max one-to-one matching; returns one IoU per gt
    (possibly -1 once a gt's remaining proposals are all retired)."""
    ious = ious.copy()
    n_gt = ious.shape[0]
    out = np.empty((n_gt,), np.float32)
    for j in range(n_gt):
        if ious.shape[1] == 0:
            out[j:] = 0.0
            return out
        best_prop = ious.argmax(axis=1)
        best_per_gt = ious[np.arange(n_gt), best_prop]
        g = best_per_gt.argmax()
        out[j] = best_per_gt[g]
        ious[g, :] = -1
        ious[:, best_prop[g]] = -1
    return out


def eval_recalls(gts, proposals, proposal_nums=(100, 300, 1000),
                 iou_thrs=(0.5,), verbose: bool = True) -> np.ndarray:
    """gts: per-image (n, 4) xyxy arrays; proposals: per-image (k, 4|5)
    arrays ((k, 5) rows are score-sorted first). Returns recalls of shape
    (len(proposal_nums), len(iou_thrs))."""
    proposal_nums = np.atleast_1d(np.asarray(proposal_nums, np.int64))
    iou_thrs = np.atleast_1d(np.asarray(iou_thrs, np.float64))
    assert len(gts) == len(proposals)

    sorted_props = []
    for p in proposals:
        p = np.asarray(p, np.float32).reshape(-1, p.shape[-1] if p.ndim == 2
                                              else 5)
        if p.shape[1] == 5:
            p = p[np.argsort(-p[:, 4])]
        sorted_props.append(p[: int(proposal_nums.max()), :4])

    total_gt = int(sum(np.asarray(g).shape[0] for g in gts))
    recalls = np.zeros((proposal_nums.size, iou_thrs.size), np.float64)
    if total_gt == 0:
        return recalls
    for k, num in enumerate(proposal_nums):
        matched = []
        for g, p in zip(gts, sorted_props):
            g = np.asarray(g, np.float32).reshape(-1, 4)
            if g.shape[0] == 0:
                continue
            matched.append(_matched_gt_ious(
                bbox_overlaps_plus1(g, p[: int(num)])))
        matched = (np.concatenate(matched) if matched
                   else np.zeros((0,), np.float32))
        for t, thr in enumerate(iou_thrs):
            recalls[k, t] = float((matched >= thr).sum()) / total_gt
    if verbose:
        for k, num in enumerate(proposal_nums):
            row = " ".join(f"{recalls[k, t]:.4f}"
                           for t in range(iou_thrs.size))
            print(f"AR@{int(num)}\t{row}")
    return recalls


def fast_eval_recall(results, dataset, proposal_nums=(100, 300, 1000),
                     iou_thrs=None, verbose: bool = True) -> np.ndarray:
    """Proposal AR from flat COCO-format det results against a CocoDataset.

    ``results``: list of dicts with image_id, bbox (xywh), score — the
    output of apis/test.run_inference. Grouped per image, converted to
    (k, 5) xyxy+score proposals (x2 = x1 + w - 1, the reference's
    fast_eval_recall conversion, datasets/coco.py:251-252), and evaluated
    with eval_recalls over every image of the dataset.

    ``iou_thrs`` defaults to 0.5:0.95:0.05, the reference's proposal_fast
    protocol (datasets/coco.py evaluate: iou_thrs=np.arange(0.5, 0.96,
    0.05)); the reported AR@N is the mean over these thresholds.
    """
    if iou_thrs is None:
        iou_thrs = np.arange(0.5, 0.96, 0.05)
    by_img = {}
    for r in results:
        x, y, w, h = r["bbox"]
        by_img.setdefault(r["image_id"], []).append(
            [x, y, x + w - 1, y + h - 1,
             float(r.get("det_score", r.get("score", 0.0)))])
    gts, props = [], []
    for i in range(len(dataset)):
        img_id = dataset.image_id(i)
        # recall gts keep degenerate boxes — the reference filters only
        # ignore/iscrowd here (coco.py:243-252), unlike the training-target
        # validity filter in get_ann
        gts.append(dataset.recall_gts(i) if hasattr(dataset, "recall_gts")
                   else dataset.get_ann(i, with_masks=False)[0])
        p = np.asarray(by_img.get(img_id, np.zeros((0, 5))), np.float32)
        props.append(p.reshape(-1, 5))
    return eval_recalls(gts, props, proposal_nums, iou_thrs, verbose=verbose)
