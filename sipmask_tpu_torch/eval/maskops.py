"""Mask operations of the COCO and YouTube-VIS evaluations, the port of
``sipmask_tpu/native/__init__.py``: RLE encode and area, the mask IoU
matrix (crowd included), the raw intersection matrix and COCOeval's greedy
matching, all through the port's C++ codec (``sipmask_tpu_torch.native``)
in run space, with no dense decode.

The ``*_plain`` functions (and ``eval/rle.py``'s codec) are the plain numpy
versions: the same numbers on decoded masks, which the tests and
``chip_smoke.py`` hold the codec against. Nothing on the main path calls
them.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .. import native
from .rle import decode_mask

__all__ = ["encode_mask", "encode_masks", "encode_masks_t", "rle_area",
           "iou_matrix", "inter_matrix", "greedy_match", "mask_iou",
           "iou_matrix_plain", "inter_matrix_plain", "greedy_match_plain"]

encode_mask = native.encode_mask
encode_masks = native.encode_masks
encode_masks_t = native.encode_masks_t
rle_area = native.rle_area
iou_matrix = native.iou_matrix
inter_matrix = native.inter_matrix
greedy_match = native.greedy_match


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


def iou_matrix_plain(dt_rles: Sequence[dict], gt_rles: Sequence[dict],
                     iscrowd=None) -> np.ndarray:
    """``iou_matrix`` on decoded masks."""
    n_dt, n_gt = len(dt_rles), len(gt_rles)
    if n_dt == 0 or n_gt == 0:
        return np.zeros((n_dt, n_gt))
    crowd = (np.zeros(n_gt, bool) if iscrowd is None
             else np.asarray(iscrowd, bool))
    return mask_iou([decode_mask(r) for r in dt_rles],
                    [decode_mask(r) for r in gt_rles], crowd)


def inter_matrix_plain(dt_rles: Sequence[dict], gt_rles: Sequence[dict]
                       ) -> np.ndarray:
    """``inter_matrix`` on decoded masks. An empty or absent mask is the
    single zero-run RLE ({'size': [h, w], 'counts': encode_counts([h *
    w])})."""
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


def greedy_match_plain(ious: np.ndarray, thrs: np.ndarray,
                       gt_ig: np.ndarray, iscrowd: np.ndarray):
    """``greedy_match`` in Python loops."""
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
