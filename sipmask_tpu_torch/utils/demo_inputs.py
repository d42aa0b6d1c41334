"""Deterministic synthetic batches, the port of
``sipmask_tpu/utils/demo_inputs.py``.

numpy only, drawing in the same order as the JAX package's ``demo_batch``, so
the same seed gives the same arrays in both packages. ``batch_to_tensors``
moves such a batch onto a device in the port's layout. ``train_batch`` and
``bump_weights`` give the full-width runs on the card (``chip_smoke.py``,
``tools/measure.py``) their batch and a randomly initialised model that
detects.
"""

from __future__ import annotations

import numpy as np
import torch


def demo_batch(batch_size=2, height=64, width=64, max_gts=8, num_gts=None,
               num_classes=80, seed=0):
    """A training batch of numpy arrays:
      images (B, H, W, 3) float32,
      gt_bboxes (B, G, 4) xyxy in input coordinates,
      gt_labels (B, G) int32 in [1..C], 0 for padding,
      gt_masks (B, G, H//2, W//2) uint8 at the stride-2 basis resolution,
      img_shapes (B, 2) float32, scale_factors (B, 4) float32.
    """
    rng = np.random.RandomState(seed)
    images = rng.randn(batch_size, height, width, 3).astype(np.float32) * 10
    g = max_gts
    n = num_gts if num_gts is not None else max(1, g // 2)
    cx = rng.uniform(0.2, 0.8, (batch_size, g)) * width
    cy = rng.uniform(0.2, 0.8, (batch_size, g)) * height
    bw = rng.uniform(0.15, 0.6, (batch_size, g)) * width
    bh = rng.uniform(0.15, 0.6, (batch_size, g)) * height
    boxes = np.stack([
        np.clip(cx - bw / 2, 0, width - 1),
        np.clip(cy - bh / 2, 0, height - 1),
        np.clip(cx + bw / 2, 0, width - 1),
        np.clip(cy + bh / 2, 0, height - 1)], -1).astype(np.float32)
    labels = rng.randint(1, num_classes + 1,
                         (batch_size, g)).astype(np.int32)
    labels[:, n:] = 0

    mh, mw = height // 2, width // 2
    masks = np.zeros((batch_size, g, mh, mw), np.uint8)
    for b in range(batch_size):
        for i in range(n):
            x1, y1, x2, y2 = (boxes[b, i] / 2).astype(int)
            masks[b, i, y1:y2 + 1, x1:x2 + 1] = \
                (rng.rand(y2 + 1 - y1, x2 + 1 - x1) > 0.3)
    img_shapes = np.tile([[height, width]], (batch_size, 1)).astype(np.float32)
    scale_factors = np.ones((batch_size, 4), np.float32)
    return dict(images=images, gt_bboxes=boxes, gt_labels=labels,
                gt_masks=masks, img_shapes=img_shapes,
                scale_factors=scale_factors)


def batch_to_tensors(batch, device="cpu"):
    """A ``demo_batch``-style dict of numpy arrays -> tensors on ``device``,
    images NHWC -> NCHW (contiguous)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
           for k, v in batch.items()}
    out["images"] = out["images"].permute(0, 3, 1, 2).contiguous()
    return out


def train_batch(batch_size, height, width, max_gts, seed, device):
    """``batch_size`` ``demo_batch`` images of height x width with 8-16 gts
    each (image i drawn from seed + i, the counts from ``seed``), padded to
    ``max_gts``, as tensors on ``device``."""
    rng = np.random.RandomState(seed)
    parts = [demo_batch(1, height, width, max_gts,
                        num_gts=int(rng.randint(8, 17)), seed=seed + i)
             for i in range(batch_size)]
    return batch_to_tensors({k: np.concatenate([p[k] for p in parts])
                             for k in parts[0]}, device)


def bump_weights(model, gen):
    """Random non-zero conv_offset weights (a zero-init deformable conv is
    a plain 3x3 conv) and cls/reg bias bumps (at the focal prior every score
    is ~0.01, under score_thr, and no detection reaches NMS), so that boxes
    are not degenerate and the mask loss is non-zero."""
    head = model.bbox_head
    with torch.no_grad():
        w = head.feat_align.conv_offset.weight
        w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * 0.5)
        head.fcos_cls.bias.fill_(-2.5)
        head.fcos_reg.bias.fill_(2.0)
