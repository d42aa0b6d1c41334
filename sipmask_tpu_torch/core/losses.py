"""Loss functions, the port of ``sipmask_tpu/core/losses.py`` (the ones the
image training path uses). All take mmdet's ``weight`` / ``avg_factor``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .boxes import bbox_overlaps


def sigmoid_bce(logits, targets):
    """Stable elementwise BCE with logits:
    max(x, 0) - x*t + log(1 + exp(-|x|))."""
    return (logits.clamp(min=0) - logits * targets +
            torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(logits, labels, num_classes: int, gamma: float = 2.0,
                       alpha: float = 0.25, avg_factor=None):
    """mmdet's py_sigmoid_focal_loss with integer labels (0 = background,
    1..C foreground), summed, / avg_factor. logits (..., C)."""
    t = F.one_hot((labels.long() - 1).clamp(min=0), num_classes).to(
        logits.dtype)
    t = t * (labels > 0)[..., None].to(logits.dtype)
    p = torch.sigmoid(logits)
    pt = (1 - p) * t + p * (1 - t)
    focal_weight = (alpha * t + (1 - alpha) * (1 - t)) * pt ** gamma
    loss = (sigmoid_bce(logits, t) * focal_weight).sum()
    return loss / avg_factor if avg_factor is not None else loss


def iou_loss(pred, target, weight=None, avg_factor=None, eps: float = 1e-6):
    """-log(IoU) with the +1 convention (mmdet IoULoss)."""
    ious = bbox_overlaps(pred, target, is_aligned=True).clamp(min=eps)
    return _reduce(-torch.log(ious), weight, avg_factor)


def giou_loss(pred, target, weight=None, avg_factor=None, eps: float = 1e-7):
    """GIoU loss with the +1 convention."""
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:], target[..., 2:])
    wh = (rb - lt + 1).clamp(min=0)
    overlap = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0] + 1) * (pred[..., 3] - pred[..., 1] + 1)
    ag = ((target[..., 2] - target[..., 0] + 1) *
          (target[..., 3] - target[..., 1] + 1))
    union = ap + ag - overlap + eps
    ious = overlap / union
    enc_wh = (torch.maximum(pred[..., 2:], target[..., 2:]) -
              torch.minimum(pred[..., :2], target[..., :2]) + 1).clamp(min=0)
    enclose = enc_wh[..., 0] * enc_wh[..., 1] + eps
    return _reduce(1 - (ious - (enclose - union) / enclose), weight,
                   avg_factor)


def giou_loss_ltrb(pred, target, weight=None, avg_factor=None):
    """fcos_core's IOULoss(loss_type='giou') on (l, t, r, b) distances
    (the SipMask-benchmark fork): areas (l+r)*(t+b) with no +1, the IoU
    smoothed as (inter + 1) / (union + 1), the enclosing box + 1e-7."""
    pl, pt, pr, pb = pred.unbind(-1)
    tl, tt, tr, tb = target.unbind(-1)
    target_area = (tl + tr) * (tt + tb)
    pred_area = (pl + pr) * (pt + pb)
    w_inter = torch.minimum(pl, tl) + torch.minimum(pr, tr)
    g_w = torch.maximum(pl, tl) + torch.maximum(pr, tr)
    h_inter = torch.minimum(pb, tb) + torch.minimum(pt, tt)
    g_h = torch.maximum(pb, tb) + torch.maximum(pt, tt)
    ac_union = g_w * g_h + 1e-7
    inter = w_inter * h_inter
    union = target_area + pred_area - inter
    ious = (inter + 1.0) / (union + 1.0)
    gious = ious - (ac_union - union) / ac_union
    return _reduce(1 - gious, weight, avg_factor)


def bce_with_logits(logits, targets, weight=None, avg_factor=None):
    return _reduce(sigmoid_bce(logits, targets), weight, avg_factor)


def _reduce(loss, weight, avg_factor):
    if weight is not None:
        loss = loss * weight
    loss = loss.sum()
    return loss / avg_factor if avg_factor is not None else loss
