"""Spatial-Preservation mask assembly, the port of
``sipmask_tpu/ops/crop_split.py``: ``assemble_masks`` for inference and
``mask_bce_loss_indexed``, the training mask loss of one image (the plain
version of kernels K3a/K3b, ``ops/mask_loss.py``).

CropSplit rules of the reference CUDA kernel: pixel (ph, pw) lies in box n
iff pw >= x1, ph >= y1, pw < x2 and ph < y2 (float compares); its quadrant
is right of the half-split when pw >= x1 + (x2 - x1 + 0.1)/2 and below it
when ph >= y1 + (y2 - y1 + 0.1)/2; coefficient planes are ordered
[top-left, top-right, bottom-left, bottom-right]; outside the box the mask
is 0. Plain PyTorch: the JAX decode uses its XLA path here too.
"""

from __future__ import annotations

import torch


def _quadrant_bounds(boxes, h: int, w: int):
    """(in_box, right, bottom), each (h, w, N) bool."""
    pw = torch.arange(w, dtype=boxes.dtype, device=boxes.device)[None, :, None]
    ph = torch.arange(h, dtype=boxes.dtype, device=boxes.device)[:, None, None]
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    in_box = (pw >= x1) & (pw < x2) & (ph >= y1) & (ph < y2)
    right = pw >= (x1 + (x2 - x1 + 0.1) / 2)
    bottom = ph >= (y1 + (y2 - y1 + 0.1) / 2)
    return in_box, right, bottom


def _colmix_logits(basis, cofs, boxes):
    """Each pixel's quadrant logit: the coefficients are mixed per column
    (0/1 weights, so exactly a select) before the two basis matmuls.

    Returns (sel (h, w, N) f32 logits, in_box (h, w, N) bool).
    """
    h, w, nb = basis.shape
    n = cofs.shape[0]
    in_box, right, bottom = _quadrant_bounds(boxes.float(), h, w)
    r = right[0].to(cofs.dtype)                   # (w, N): same on every row
    c = cofs.reshape(n, 4, nb)
    ctop = (1 - r)[:, :, None] * c[:, 0][None] + r[:, :, None] * c[:, 1][None]
    cbot = (1 - r)[:, :, None] * c[:, 2][None] + r[:, :, None] * c[:, 3][None]
    bt = basis.permute(1, 0, 2)                   # (w, h, nb)
    mtop = torch.matmul(bt, ctop.transpose(1, 2)).permute(1, 0, 2)  # (h,w,N)
    mbot = torch.matmul(bt, cbot.transpose(1, 2)).permute(1, 0, 2)
    bm = bottom.float()                           # (h, 1, N): same per column
    return mtop * (1 - bm) + mbot * bm, in_box


def assemble_masks(basis, cofs, boxes):
    """SP mask assembly.

    Args:
      basis: (h, w, nb) basis masks on the stride-2 grid.
      cofs: (N, 4*nb) per-detection quadrant coefficients [00|01|10|11].
      boxes: (N, 4) xyxy in mask (stride-2) coordinates.
    Returns:
      (h, w, N) sigmoid probabilities, 0 outside the boxes.
    """
    sel, in_box = _colmix_logits(basis, cofs, boxes)
    return torch.sigmoid(sel) * in_box.to(sel.dtype)


def mask_bce_loss_indexed(basis, cofs, boxes, gt_masks_g, gt_idx):
    """Per-detection pixel-summed BCE of the SP-assembled mask against its
    gt mask, inside the box (the training mask loss of one image).

    The BCE splits into a gt-independent part and the linear term
    ``-sum_p sel*gt``; the latter is one contraction against the G distinct
    gt masks followed by a pick of each detection's gt, so the gathered
    (h, w, K) gt tensor is never built. Differentiable in basis and cofs.

    Args:
      basis: (h, w, nb); cofs: (K, 4*nb); boxes: (K, 4) in mask coords;
      gt_masks_g: (G, h, w) binary; gt_idx: (K,) int index into G.
    Returns:
      (K,) pixel-summed BCE per detection.
    """
    sel, in_box = _colmix_logits(basis, cofs, boxes)
    inb = in_box.to(sel.dtype)
    pos = ((sel.clamp(min=0) + torch.log1p(torch.exp(-sel.abs()))) * inb
           ).sum((0, 1))                                        # (K,)
    t = torch.einsum("hwk,ghw->kg", sel * inb,
                     gt_masks_g.to(sel.dtype))                  # (K, G)
    return pos - torch.gather(t, 1, gt_idx.long()[:, None])[:, 0]
