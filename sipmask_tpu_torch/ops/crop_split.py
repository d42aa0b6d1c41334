"""Spatial-Preservation mask assembly, the port of
``sipmask_tpu/ops/crop_split.py``: ``assemble_masks`` for inference and
``mask_bce_loss_indexed``, the training mask loss of one image (the plain
version of kernels K3a/K3b, ``ops/mask_loss.py``).

CropSplit rules of the reference CUDA kernel: pixel (ph, pw) lies in box n
iff pw >= x1, ph >= y1, pw < x2 and ph < y2 (float compares); its quadrant
is right of the half-split when pw >= x1 + (x2 - x1 + 0.1)/2 and below it
when ph >= y1 + (y2 - y1 + 0.1)/2; coefficient planes are ordered
[top-left, top-right, bottom-left, bottom-right]; outside the box the mask
is 0 (``mask_assembly.py`` holds the CropSplit arithmetic).
"""

from __future__ import annotations

import torch

from . import custom, mask_assembly
from .mask_assembly import _colmix_logits


def assemble_masks(basis, cofs, boxes):
    """SP mask assembly: kernel K6 on CUDA tensors, its plain colmix version
    on CPU tensors (``mask_assembly.assemble_masks``).

    Args:
      basis: (h, w, nb) basis masks on the stride-2 grid, or (B, h, w, nb).
      cofs: (N, 4*nb) per-detection quadrant coefficients [00|01|10|11], or
        (B, N, 4*nb).
      boxes: (N, 4) xyxy in mask (stride-2) coordinates, or (B, N, 4).
    Returns:
      (h, w, N) sigmoid probabilities, 0 outside the boxes, or (B, h, w, N).
    """
    if basis.dim() == 3:
        return assemble_masks(basis[None], cofs[None], boxes[None])[0]
    if custom.routed():   # torch.export: K6 as a custom op
        return torch.ops.sipmask.assemble_masks(basis, cofs, boxes)
    return mask_assembly.assemble_masks(basis, cofs, boxes)


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
