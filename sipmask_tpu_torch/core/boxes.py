"""Box geometry, the port of ``sipmask_tpu/core/boxes.py`` (the parts the
serving and training paths use). Boxes are xyxy."""

from __future__ import annotations

import torch


def bbox_overlaps(bboxes1, bboxes2, is_aligned: bool = False,
                  eps: float = 0.0):
    """IoU with mmdet-v1's +1 pixel convention.

    Pairwise: bboxes1 (..., M, 4), bboxes2 (..., N, 4) -> (..., M, N).
    Aligned: both (..., M, 4) -> (..., M). ``eps`` is added to the
    denominator (padded or degenerate boxes).
    """
    if is_aligned:
        lt = torch.maximum(bboxes1[..., :2], bboxes2[..., :2])
        rb = torch.minimum(bboxes1[..., 2:], bboxes2[..., 2:])
    else:
        lt = torch.maximum(bboxes1[..., :, None, :2],
                           bboxes2[..., None, :, :2])
        rb = torch.minimum(bboxes1[..., :, None, 2:],
                           bboxes2[..., None, :, 2:])
    wh = (rb - lt + 1).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    area1 = ((bboxes1[..., 2] - bboxes1[..., 0] + 1) *
             (bboxes1[..., 3] - bboxes1[..., 1] + 1))
    area2 = ((bboxes2[..., 2] - bboxes2[..., 0] + 1) *
             (bboxes2[..., 3] - bboxes2[..., 1] + 1))
    if is_aligned:
        denom = area1 + area2 - overlap
    else:
        denom = area1[..., :, None] + area2[..., None, :] - overlap
    return overlap / (denom + eps)


def jaccard_nop1(box_a, box_b):
    """IoU without the +1 convention (YOLACT's), used by ``fast_nms``:
    box_a (..., A, 4), box_b (..., B, 4) -> (..., A, B); 0 where the union
    is not positive."""
    max_xy = torch.minimum(box_a[..., :, None, 2:], box_b[..., None, :, 2:])
    min_xy = torch.maximum(box_a[..., :, None, :2], box_b[..., None, :, :2])
    wh = (max_xy - min_xy).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = ((box_a[..., 2] - box_a[..., 0]) *
              (box_a[..., 3] - box_a[..., 1]))[..., :, None]
    area_b = ((box_b[..., 2] - box_b[..., 0]) *
              (box_b[..., 3] - box_b[..., 1]))[..., None, :]
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def distance2bbox(points, distance):
    """(l, t, r, b) distances at ``points`` (..., 2) [x, y] -> xyxy."""
    return torch.stack([points[..., 0] - distance[..., 0],
                        points[..., 1] - distance[..., 1],
                        points[..., 0] + distance[..., 2],
                        points[..., 1] + distance[..., 3]], -1)


def center_size(boxes):
    """xyxy -> (cx, cy, w, h)."""
    return torch.cat([(boxes[..., 2:] + boxes[..., :2]) / 2,
                      boxes[..., 2:] - boxes[..., :2]], -1)
