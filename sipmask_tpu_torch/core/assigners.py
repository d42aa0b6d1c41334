"""Box assigners and samplers, the port of ``sipmask_tpu/core/assigners.py``
(mmdet's MaxIoUAssigner and RandomSampler). SipMask assigns its targets with
the FCOS point rules (``core/targets.py``); these serve the reference's
declared ``train_cfg`` and anchor-based heads. Static shapes: fixed-size
index tensors, -1 where padded, with validity masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .boxes import bbox_overlaps


class AssignResult(NamedTuple):
    # per box: -1 ignore, 0 negative (background), > 0 the 1-based gt index
    gt_inds: torch.Tensor       # (N,) int32
    max_overlaps: torch.Tensor  # (N,) float
    labels: torch.Tensor        # (N,) int32, the gt's label, 0 where none


def max_iou_assign(boxes, gt_boxes, gt_labels, gt_valid,
                   pos_iou_thr: float = 0.5, neg_iou_thr: float = 0.4,
                   min_pos_iou: float = 0.0,
                   match_low_quality: bool = True) -> AssignResult:
    """MaxIoUAssigner on xyxy boxes (N, 4) and gts (G, 4), ``gt_valid``
    (G,) masking padded gts (which read IoU -1):

    1. every box is ignored (-1);
    2. a box whose best IoU is in [0, neg_iou_thr) is negative (0);
    3. a box whose best IoU is >= pos_iou_thr takes that gt (the first of
       equal maxima);
    4. low-quality matches: in gt order, each valid gt whose best IoU is
       > 0 and >= min_pos_iou claims its best box (the first of equal
       maxima), a later gt overriding an earlier one.
    """
    n = boxes.shape[0]
    ious = bbox_overlaps(boxes, gt_boxes)
    ious = torch.where(gt_valid[None, :], ious, torch.full_like(ious, -1.0))
    # torch's max returns the first maximum's index, as jnp.argmax does
    max_ov, arg = ious.max(1)
    gt_inds = torch.full((n,), -1, dtype=torch.int32, device=boxes.device)
    gt_inds = torch.where((max_ov >= 0) & (max_ov < neg_iou_thr),
                          torch.zeros_like(gt_inds), gt_inds)
    gt_inds = torch.where(max_ov >= pos_iou_thr, (arg + 1).int(), gt_inds)
    if match_low_quality and gt_boxes.shape[0]:
        gt_best, gt_arg = ious.max(0)                     # (G,)
        claim = gt_valid & (gt_best >= min_pos_iou) & (gt_best > 0)
        g = torch.arange(1, gt_boxes.shape[0] + 1, dtype=torch.int32,
                         device=boxes.device)
        # the last claiming gt wins each box: scatter the claims in gt
        # order with amax, so a later (larger) index overrides an earlier
        claims = torch.zeros(n, dtype=torch.int32, device=boxes.device)
        claims.scatter_reduce_(0, gt_arg[claim], g[claim], "amax")
        gt_inds = torch.where(claims > 0, claims, gt_inds)
    labels = torch.where(
        gt_inds > 0, gt_labels[(gt_inds.long() - 1).clamp(min=0)].int(),
        torch.zeros_like(gt_inds))
    return AssignResult(gt_inds, max_ov, labels)


class SampleResult(NamedTuple):
    pos_inds: torch.Tensor   # (num_pos_cap,) int32, -1 padded
    neg_inds: torch.Tensor   # (num_neg_cap,) int32, -1 padded
    pos_valid: torch.Tensor  # (num_pos_cap,) bool
    neg_valid: torch.Tensor  # (num_neg_cap,) bool


def sample_by_priority(assign: AssignResult, pos_prio, neg_prio,
                       num: int = 256,
                       pos_fraction: float = 0.5) -> SampleResult:
    """RandomSampler's picks given each box's random priorities (N,) in
    [0, 1), one set for the positives and one for the negatives: up to
    ``num * pos_fraction`` positives and the rest of ``num`` negatives,
    each the boxes of the lowest priorities among the eligible."""
    pos_cap = int(num * pos_fraction)

    def pick(mask, prio, cap):
        # ineligible boxes sink below every eligible one; a stable sort, as
        # jnp.argsort is
        order = torch.argsort(prio + (~mask) * 10.0, stable=True)[:cap]
        valid = mask[order]
        return torch.where(valid, order, -1).int(), valid

    pos_inds, pos_valid = pick(assign.gt_inds > 0, pos_prio, pos_cap)
    neg_inds, neg_valid = pick(assign.gt_inds == 0, neg_prio, num - pos_cap)
    return SampleResult(pos_inds, neg_inds, pos_valid, neg_valid)


def random_sample(assign: AssignResult, generator: torch.Generator,
                  num: int = 256, pos_fraction: float = 0.5) -> SampleResult:
    """RandomSampler: uniform picks of up to ``num * pos_fraction``
    positives, the rest negatives, with static output sizes; the
    priorities drawn from ``generator`` (on the boxes' device)."""
    n = assign.gt_inds.shape[0]
    dev = assign.gt_inds.device
    pos_prio = torch.rand(n, generator=generator, device=dev)
    neg_prio = torch.rand(n, generator=generator, device=dev)
    return sample_by_priority(assign, pos_prio, neg_prio, num, pos_fraction)
