"""Deterministic synthetic batches, the port of
``sipmask_tpu/utils/demo_inputs.py``.

numpy only, drawing in the same order as the JAX package's ``demo_batch``, so
the same seed gives the same arrays in both packages. ``batch_to_tensors``
moves such a batch onto a device in the port's layout. ``train_batch``,
``train_batch_for``, ``vis_pair_batch``, ``bump_weights`` and
``calibrate_frozen_bn`` give the full-width runs on the card
(``chip_smoke.py``, ``tools/measure.py``) their batch and a randomly
initialised model that detects.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


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
    """A ``demo_batch``-style dict of numpy arrays (or a loader's batch)
    -> tensors on ``device``, images NHWC -> NCHW (contiguous, made on the
    device; a VIS batch's ref_images too). To a GPU each array is copied
    from pinned memory without blocking the host. A loader batch's
    host-only keys (image ids, original shapes) stay behind."""
    device = torch.device(device)
    out = {}
    for k, v in batch.items():
        if k in ("image_ids", "ori_shapes"):
            continue
        t = torch.from_numpy(np.ascontiguousarray(v))
        if device.type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=True)
    for k in ("images", "ref_images"):
        if k in out:
            out[k] = out[k].permute(0, 3, 1, 2).contiguous()
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


def vis_pair_batch(batch_size, height, width, max_gts, num_classes, seed,
                   device):
    """A SipMask-VIS training batch of frame pairs as tensors on ``device``:
    ``train_batch``'s current frames (8-16 gts each, labels below
    ``num_classes``) and a reference frame of each: other images, the gts
    in a shuffled order with their boxes moved up to 8 px, one of them
    absent (its ``gt_pids`` 0), the rest matched by ``gt_pids`` (1-based
    rows of the reference gts)."""
    rng = np.random.RandomState(seed)
    parts = []
    for i in range(batch_size):
        n = int(rng.randint(8, 17))
        cur = demo_batch(1, height, width, max_gts, num_gts=n,
                         num_classes=num_classes, seed=seed + i)
        ref = demo_batch(1, height, width, max_gts, num_gts=n,
                         num_classes=num_classes, seed=seed + 1000 + i)
        order = rng.permutation(n)          # reference row r holds gt order[r]
        kept = order[:n - 1]                # the last one left the frame
        boxes = cur["gt_bboxes"][0, kept] + rng.uniform(-8, 8, (n - 1, 4))
        boxes = np.clip(boxes, 0, [width - 1, height - 1] * 2)
        ref_boxes = np.zeros((1, max_gts, 4), np.float32)
        ref_boxes[0, :n - 1] = boxes
        ref_labels = np.zeros((1, max_gts), np.int32)
        ref_labels[0, :n - 1] = cur["gt_labels"][0, kept]
        pids = np.zeros((1, max_gts), np.int32)
        pids[0, kept] = np.arange(1, n)
        parts.append(dict(cur, ref_images=ref["images"],
                          ref_bboxes_jit=ref_boxes, ref_labels=ref_labels,
                          gt_pids=pids))
    return batch_to_tensors({k: np.concatenate([p[k] for p in parts])
                             for k in parts[0]}, device)


def train_batch_for(cfg, seed, device):
    """``train_batch`` at a preset's training shapes: ``imgs_per_device``
    images at ``data.train_size`` (else ``fixed_size``; else the keep-ratio
    scale padded to ``size_divisor``, 800x1344 for the hi-acc presets), with
    ``data.max_gts`` gt slots."""
    d = cfg.data
    if d.train_size is not None or d.fixed_size is not None:
        h, w = d.train_size or d.fixed_size
    else:
        div = d.size_divisor
        h, w = (-(-min(d.img_scale) // div) * div,
                -(-max(d.img_scale) // div) * div)
    return train_batch(cfg.train.imgs_per_device, h, w, d.max_gts, seed,
                       device)


def bump_weights(model, gen, training: bool = False):
    """Random non-zero conv_offset weights (a zero-init deformable conv is
    a plain 3x3 conv) and cls/reg bias bumps (at the focal prior every score
    is ~0.01, under score_thr, and no detection reaches NMS), so that boxes
    are not degenerate and the mask loss is non-zero. ``training`` keeps
    the cls bias at -2.5 for every preset: the fast-NMS bump below is for
    serving, and in training it would score every negative point high
    (a focal loss of ~100 at R101's first step, and a diverging second).

    SipMask++ also gets: DCN conv_offset weights of std 0.25/sqrt(fan_in)
    and biases of std 0.5 (offsets of about half a pixel on unit-scale
    inputs, see :func:`calibrate_frozen_bn`; each DCN block's positions
    depend on the features the earlier ones sampled, so larger offset
    weights amplify rounding: at 1/sqrt(fan_in) f32 rounding grows to 3e-3
    of C5's scale through R101's eight layer3 DCN blocks, at 2/sqrt(fan_in)
    to 9e-2), a cls bias of -1 (the fast-NMS threshold
    applies to score x centerness, about 0.13 there), and rescoring-head
    weights of std 0.1 and bias 0.2 (at its 0.001 init every predicted mask
    IoU is ~0 and mask_scores would all be 0)."""
    head = model.bbox_head
    fast = (model.cfg.test.use_fast_nms or model.cfg.head.ssd_flag) and \
        not training
    with torch.no_grad():
        w = head.feat_align.conv_offset.weight
        w.copy_(torch.randn(w.shape, generator=gen).to(w.device) * 0.5)
        head.fcos_cls.bias.fill_(-1.0 if fast else -2.5)
        head.fcos_reg.bias.fill_(2.0)
        for name, m in model.backbone.named_modules():
            if name.endswith("conv2") and hasattr(m, "conv_offset"):
                off = m.conv_offset
                fan_in = off.weight[0].numel()
                off.weight.copy_(torch.randn(off.weight.shape, generator=gen)
                                 .to(w.device) * (0.25 / fan_in ** 0.5))
                off.bias.copy_(torch.randn(off.bias.shape, generator=gen)
                               .to(w.device) * 0.5)
        if model.cfg.head.rescoring:
            ms = head.mask_scoring
            ms.weight.copy_(torch.randn(ms.weight.shape, generator=gen)
                            .to(w.device) * 0.1)
            ms.bias.fill_(0.2)


@torch.no_grad()
def calibrate_frozen_bn(backbone, images):
    """Set every frozen BatchNorm of ``backbone`` to the batch statistics of
    its conv's output on ``images`` (weight 1, bias 0), block by block, as a
    pretrained backbone's BN would standardise them. With random weights
    and identity BN the activations of a deep ResNet grow ~3x per block
    (~5e6 at R101's C5), which saturates every score of a norm-free head.
    Each channel's variance gets the layer's mean variance added, so that a
    channel with almost no spread is not scaled up by orders of magnitude:
    without that floor, f32 rounding grows ~1000x through R101. The
    statistics come from the f32 parameters in the images' dtype, whatever
    the model's compute dtype: a bf16 model gets the f32 model's BN.
    """
    from ..models.layers import FrozenBatchNorm2d

    def fit(bn: FrozenBatchNorm2d, raw):
        bn.weight.fill_(1.0)
        bn.bias.zero_()
        bn.running_mean.copy_(raw.mean((0, 2, 3)))
        var = raw.var((0, 2, 3), unbiased=False)
        bn.running_var.copy_(var + var.mean())
        return raw

    def conv(x, m):
        return F.conv2d(x, m.weight, None, m.stride, m.padding, 1, m.groups)

    bb = backbone
    x = torch.relu(bb.bn1(fit(bb.bn1, conv(images, bb.conv1))))
    x = F.max_pool2d(x, 3, 2, 1)
    for stage in range(4):
        for blk in getattr(bb, f"layer{stage + 1}"):
            out = torch.relu(blk.bn1(fit(blk.bn1, conv(x, blk.conv1))))
            raw2 = (blk.conv2(out, out.dtype)
                    if hasattr(blk.conv2, "conv_offset")
                    else conv(out, blk.conv2))
            out = torch.relu(blk.bn2(fit(blk.bn2, raw2)))
            out = blk.bn3(fit(blk.bn3, conv(out, blk.conv3)))
            if blk.downsample is not None:
                ds = blk.downsample
                x = ds[1](fit(ds[1], conv(x, ds[0])))
            x = torch.relu(out + x)


def moving_shapes_video(n_frames, h, w, seed):
    """An in-memory video of BGR uint8 frames: dark noise and four shapes
    (two ellipses, two boxes) moving linearly; the first ellipse and the
    first box start half a frame apart on one row and swap places."""
    rng = np.random.RandomState(seed)
    size = np.array([w, h], np.float64)
    start = rng.uniform(0.15, 0.85, (4, 2)) * size
    vel = rng.uniform(-0.06, 0.06, (4, 2)) * size
    start[0] = (0.25 * w, 0.5 * h)
    start[1] = (0.75 * w, 0.5 * h)
    vel[0] = (0.5 * w / (n_frames - 1), 0.0)
    vel[1] = -vel[0]
    axes = rng.uniform(0.05, 0.12, (4, 2)) * size
    colors = rng.randint(90, 255, (4, 3))
    yy, xx = np.mgrid[:h, :w]
    frames = []
    for f in range(n_frames):
        img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        for k in range(4):
            (cx, cy), (a, b) = start[k] + vel[k] * f, axes[k]
            if k % 2 == 0:   # ellipses
                m = ((xx - cx) / a) ** 2 + ((yy - cy) / b) ** 2 <= 1
            else:
                m = (np.abs(xx - cx) <= a) & (np.abs(yy - cy) <= b)
            img[m] = colors[k]
        frames.append(img)
    return frames


class MemoryVideo:
    """One video held in memory, with ``YTVOSDataset``'s test interface
    (``run_video_inference`` takes it)."""

    def __init__(self, frames):
        self.frames = frames

    def iter_videos(self):
        yield 1, 0, len(self.frames)

    def load_frame(self, vid_idx, frame_id):
        return self.frames[frame_id]
