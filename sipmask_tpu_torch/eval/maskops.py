"""Mask operations of the COCO evaluation, the port of the numpy paths of
``sipmask_tpu/native/__init__.py`` (the JAX package's C++ library is not
ported): RLE encode and area, the mask IoU matrix and the raw intersection
matrix of the YouTube-VIS evaluation (dense, on decoded masks) and
COCOeval's greedy matching."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .rle import decode_mask, encode_mask, rle_area

__all__ = ["encode_mask", "rle_area", "mask_iou", "iou_matrix",
           "inter_matrix", "greedy_match"]


def mask_iou(dt_masks: List[np.ndarray], gt_masks: List[np.ndarray],
             iscrowd: np.ndarray) -> np.ndarray:
    """Dense mask IoU over packed bits (crowd gt -> inter / area_dt)."""
    if not dt_masks or not gt_masks:
        return np.zeros((len(dt_masks), len(gt_masks)))
    dp = np.stack([np.packbits(m.reshape(-1)) for m in dt_masks])
    gp = np.stack([np.packbits(m.reshape(-1)) for m in gt_masks])
    da = np.asarray([int(m.sum()) for m in dt_masks], np.float64)
    ga = np.asarray([int(m.sum()) for m in gt_masks], np.float64)
    pop = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                        axis=1).sum(1)
    inter = np.zeros((len(dt_masks), len(gt_masks)))
    for j in range(len(gt_masks)):
        inter[:, j] = pop[np.bitwise_and(dp, gp[j])].sum(1)
    union = np.where(iscrowd[None, :], da[:, None],
                     da[:, None] + ga[None, :] - inter)
    return inter / np.maximum(union, 1e-12)


def iou_matrix(dt_rles: Sequence[dict], gt_rles: Sequence[dict],
               iscrowd=None) -> np.ndarray:
    """(n_dt, n_gt) IoU of RLE masks (pycocotools rleIou; crowd gt ->
    inter / area_dt)."""
    n_dt, n_gt = len(dt_rles), len(gt_rles)
    if n_dt == 0 or n_gt == 0:
        return np.zeros((n_dt, n_gt))
    crowd = (np.zeros(n_gt, bool) if iscrowd is None
             else np.asarray(iscrowd, bool))
    return mask_iou([decode_mask(r) for r in dt_rles],
                    [decode_mask(r) for r in gt_rles], crowd)


def inter_matrix(dt_rles: Sequence[dict], gt_rles: Sequence[dict]
                 ) -> np.ndarray:
    """Raw intersection areas (n_dt, n_gt) of RLE masks, float64. An empty
    or absent mask is the single zero-run RLE ({'size': [h, w], 'counts':
    encode_counts([h * w])})."""
    n_dt, n_gt = len(dt_rles), len(gt_rles)
    out = np.zeros((n_dt, n_gt))
    if n_dt == 0 or n_gt == 0:
        return out
    dts = [decode_mask(r) for r in dt_rles]
    gts = [decode_mask(r) for r in gt_rles]
    for i, d in enumerate(dts):
        for j, g in enumerate(gts):
            out[i, j] = float(np.bitwise_and(d, g).sum())
    return out


def greedy_match(ious: np.ndarray, thrs: np.ndarray, gt_ig: np.ndarray,
                 iscrowd: np.ndarray):
    """COCOeval's greedy matching over IoU thresholds (pycocotools
    evaluateImg's inner loop). ious (n_dt, n_gt) with the gt columns sorted
    ignore-last. Returns (dtm int32 (T, D), 1-based gt index or 0;
    dt_ig uint8 (T, D))."""
    n_dt, n_gt = ious.shape
    dtm = np.zeros((len(thrs), n_dt), np.int32)
    dt_ig = np.zeros((len(thrs), n_dt), np.uint8)
    if n_dt == 0 or n_gt == 0:
        return dtm, dt_ig
    for ti, t in enumerate(thrs):
        gtm = np.zeros(n_gt, np.int32)
        for di in range(n_dt):
            best = min(t, 1 - 1e-10)
            m = -1
            for gi in range(n_gt):
                if gtm[gi] > 0 and not iscrowd[gi]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[gi]:
                    break
                if ious[di, gi] < best:
                    continue
                best = ious[di, gi]
                m = gi
            if m >= 0:
                dtm[ti, di] = m + 1
                dt_ig[ti, di] = gt_ig[m]
                gtm[m] = di + 1
    return dtm, dt_ig
