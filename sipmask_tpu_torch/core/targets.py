"""FCOS target assignment, the port of ``sipmask_tpu/core/targets.py``.

Dense over a (points x gts) grid with gts padded to a static count (label 0
is padding), batched over images. Where the JAX package picks each point's
gt with one-hot reductions (a TPU gather is slow), the port takes the first
minimum's index and gathers.
"""

from __future__ import annotations

import torch

INF = 1e8


def fcos_targets(gt_bboxes, gt_labels, points, regress_ranges, strides,
                 center_sampling: bool = True,
                 center_sample_radius: float = 1.5):
    """Assign FCOS targets.

    Args:
      gt_bboxes: (B, G, 4) xyxy, padded rows arbitrary.
      gt_labels: (B, G) int in [1..C], 0 for padded rows.
      points: (P, 2) all-level points [x, y]; regress_ranges (P, 2);
        strides (P,).
    Returns dict of labels (B, P) int64 (0 = background), bbox_targets
    (B, P, 4) (l, t, r, b) in input pixels, gt_inds (B, P) int64 (the
    assigned gt row; 0 where the point is background).
    """
    valid = gt_labels > 0                                   # (B, G)
    areas = ((gt_bboxes[..., 2] - gt_bboxes[..., 0] + 1) *
             (gt_bboxes[..., 3] - gt_bboxes[..., 1] + 1))
    areas = torch.where(valid, areas, torch.full_like(areas, INF))
    xs = points[None, :, None, 0]                           # (1, P, 1)
    ys = points[None, :, None, 1]
    gx1, gy1 = gt_bboxes[:, None, :, 0], gt_bboxes[:, None, :, 1]
    gx2, gy2 = gt_bboxes[:, None, :, 2], gt_bboxes[:, None, :, 3]
    bbox_targets = torch.stack([xs - gx1, ys - gy1, gx2 - xs, gy2 - ys],
                               -1)                          # (B, P, G, 4)
    if center_sampling:
        cx, cy = (gx1 + gx2) / 2, (gy1 + gy2) / 2
        r = strides[None, :, None] * center_sample_radius
        cb = torch.stack([xs - torch.maximum(cx - r, gx1),
                          ys - torch.maximum(cy - r, gy1),
                          torch.minimum(cx + r, gx2) - xs,
                          torch.minimum(cy + r, gy2) - ys], -1)
        inside_gt = cb.amin(-1) > 0
    else:
        inside_gt = bbox_targets.amin(-1) > 0
    max_dist = bbox_targets.amax(-1)
    inside_range = ((max_dist >= regress_ranges[None, :, None, 0]) &
                    (max_dist <= regress_ranges[None, :, None, 1]))
    areas = torch.where(inside_gt & inside_range, areas[:, None, :],
                        torch.full_like(max_dist, INF))     # (B, P, G)
    min_area = areas.amin(-1)
    # the first gt of least area, as argmin's tie rule
    g = areas.shape[-1]
    idx = torch.arange(g, device=areas.device).expand_as(areas)
    gt_inds = torch.where(areas == min_area[..., None], idx,
                          torch.full_like(idx, g)).amin(-1)  # (B, P)
    labels = torch.gather(gt_labels.long(), 1, gt_inds)
    labels = torch.where(min_area >= INF, torch.zeros_like(labels), labels)
    bbox_targets = torch.gather(
        bbox_targets, 2, gt_inds[:, :, None, None].expand(-1, -1, 1, 4)
    )[:, :, 0]
    return dict(labels=labels, bbox_targets=bbox_targets, gt_inds=gt_inds)


def centerness_target(bbox_targets, eps: float = 1e-12):
    """sqrt((min(l,r)/max(l,r)) * (min(t,b)/max(t,b))); ``eps`` guards
    background rows."""
    lr = bbox_targets[..., 0::2]
    tb = bbox_targets[..., 1::2]
    ratio = (lr.amin(-1) / lr.amax(-1).clamp(min=eps)) * (
        tb.amin(-1) / tb.amax(-1).clamp(min=eps))
    return torch.sqrt(ratio.clamp(min=0.0))
