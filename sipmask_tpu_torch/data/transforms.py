"""Host-side image and annotation transforms, the port of
``sipmask_tpu/data/transforms.py`` in numpy, with ``imgops`` in place of
cv2 (the same numbers):

- keep-ratio resize to (long, short) like mmdet's Resize (bilinear for
  images, nearest for masks), or the fixed-size stretch of the real-time
  presets;
- horizontal flip; caffe-BGR normalization (mean subtraction, std 1);
- padding to a static bucket (landscape / portrait) instead of a dynamic
  pad to 32;
- gt masks at the stride-2 basis resolution: nearest-resized, flipped,
  padded, then the reference's in-loss 0.5x bilinear + > 0.5, for all of an
  image's gts at once.

The SSD augmentations of the real-time recipes (photometric distortion,
expand, min-IoU crop) are not ported: a config with ``ssd_augs`` raises.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .imgops import (downsample2x_mask, resize_bilinear_f32,
                     resize_bilinear_u8, resize_nearest)


def imrescale_factor(h: int, w: int, scale: Tuple[int, int]) -> float:
    """mmcv.imrescale's scalar factor, scale = (long, short): boxes (and
    decoded boxes) scale by this one float, not by per-axis ratios."""
    long_side, short_side = max(scale), min(scale)
    return min(long_side / max(h, w), short_side / min(h, w))


def imrescale_size(h: int, w: int, scale: Tuple[int, int]) -> Tuple[int, int]:
    """mmdet's keep-ratio target size, scale = (long, short)."""
    f = imrescale_factor(h, w, scale)
    return int(h * f + 0.5), int(w * f + 0.5)


def resize_image(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize as cv2 does it: fixed point on uint8, float on
    float images."""
    if img.dtype == np.uint8:
        return resize_bilinear_u8(img, out_h, out_w)
    return resize_bilinear_f32(img, out_h, out_w)


def sample_ms_scale(scales, mode: str, rng) -> Tuple[int, int]:
    """One train scale per image, the reference's Resize.random_sample /
    random_scale. 'range': draw the long edge, then the short edge, by
    randint between the two scales' endpoints. 'value': pick one scale."""
    if len(scales) == 1:
        return scales[0]
    if mode == "range":
        if len(scales) != 2:
            raise ValueError("range mode needs exactly 2 scales")
        longs = [max(s) for s in scales]
        shorts = [min(s) for s in scales]
        long_e = rng.randint(min(longs), max(longs) + 1)
        short_e = rng.randint(min(shorts), max(shorts) + 1)
        return (int(long_e), int(short_e))
    if mode == "value":
        return scales[rng.randint(len(scales))]
    raise ValueError(f"unknown ms_mode {mode!r}")


@dataclasses.dataclass
class Sample:
    """One transformed example in static-shape layout."""
    image: np.ndarray        # (H, W, 3) float32
    gt_bboxes: np.ndarray    # (G, 4)
    gt_labels: np.ndarray    # (G,)
    gt_masks: np.ndarray     # (G, H/2, W/2) uint8
    img_shape: np.ndarray    # (2,) resized pre-pad (h, w)
    ori_shape: Tuple[int, int]
    scale_factor: np.ndarray  # (4,) sx, sy, sx, sy
    landscape: bool = True
    image_id: int = -1


def bucket_shape(cfg, landscape: bool, train: bool = True) -> Tuple[int, int]:
    """The static (H, W) an image pads to: the largest train scale rounded
    up to ``size_divisor``, transposed for portrait images; the fixed size
    (``train_size`` when training) for the real-time presets."""
    if cfg.fixed_size is not None:
        return (cfg.train_size or cfg.fixed_size) if train else cfg.fixed_size
    scales = cfg.ms_scales or (cfg.img_scale,)
    long_s = max(max(sc) for sc in scales)
    short_s = max(min(sc) for sc in scales)
    d = cfg.size_divisor
    pad = lambda v: (v + d - 1) // d * d   # noqa: E731
    return ((pad(short_s), pad(long_s)) if landscape
            else (pad(long_s), pad(short_s)))


def _normalized_canvas(img, mean, std, pad_h, pad_w):
    """uint8 or float (h, w, 3) -> (pad_h, pad_w, 3) float32, normalized
    and zero-padded."""
    out_h, out_w = img.shape[:2]
    img = img.astype(np.float32)
    img -= mean
    img /= std
    canvas = np.zeros((pad_h, pad_w, 3), np.float32)
    canvas[:out_h, :out_w] = img[:pad_h, :pad_w]
    return canvas


class TrainTransform:
    def __init__(self, cfg, seed: int = 0):
        """cfg: a ``DataConfig`` (``sipmask_tpu_torch.config``)."""
        if cfg.ssd_augs:
            raise NotImplementedError(
                "the SSD augmentations (photometric_distortion, expand, "
                "min_iou_random_crop) of the real-time and SipMask++ recipes "
                "are not ported")
        self.cfg = cfg
        self.rng = np.random.RandomState(seed)
        self.mean = np.asarray(cfg.mean, np.float32)
        self.std = np.asarray(cfg.std, np.float32)

    def __call__(self, img, boxes, labels, masks, image_id=-1) -> Sample:
        """img: (H, W, 3) uint8 BGR; boxes (N, 4) f32; labels (N,) int;
        masks (N, H, W) uint8."""
        cfg, rng = self.cfg, self.rng
        ori_shape = img.shape[:2]
        boxes = boxes.astype(np.float32).copy()
        labels = labels.copy()

        h, w = img.shape[:2]
        if cfg.fixed_size is not None:
            out_h, out_w = cfg.train_size or cfg.fixed_size
            landscape = True
            sx, sy = out_w / w, out_h / h     # imresize per-axis factors
        else:
            scale = cfg.img_scale
            if cfg.ms_scales:  # multi-scale train: sample one per image
                scale = sample_ms_scale(cfg.ms_scales, cfg.ms_mode, rng)
            out_h, out_w = imrescale_size(h, w, scale)
            landscape = out_w >= out_h
            sx = sy = imrescale_factor(h, w, scale)  # imrescale scalar
        img = resize_image(img, out_h, out_w)
        boxes = boxes * np.array([sx, sy, sx, sy], np.float32)
        # Resize clips boxes into the resized image
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, out_w - 1)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, out_h - 1)

        flip = rng.rand() < cfg.flip_ratio
        if flip:
            img = img[:, ::-1]
            flipped = boxes.copy()
            flipped[:, 0] = out_w - boxes[:, 2] - 1
            flipped[:, 2] = out_w - boxes[:, 0] - 1
            boxes = flipped
        pad_h, pad_w = bucket_shape(cfg, landscape)
        canvas = _normalized_canvas(img, self.mean, self.std, pad_h, pad_w)

        g = cfg.max_gts
        n = min(len(boxes), g)
        gm = np.zeros((g, pad_h // 2, pad_w // 2), np.uint8)
        if masks is not None and len(masks) and n:
            # nearest-resize to the network input, THEN flip (the
            # reference's Resize before RandomFlip), zero-pad to the bucket,
            # then the in-loss 0.5x bilinear + > 0.5
            m = resize_nearest(masks[:n], out_h, out_w, axes=(1, 2))
            if flip:
                m = m[:, :, ::-1]
            mp = np.zeros((n, pad_h, pad_w), m.dtype)
            mp[:, :out_h, :out_w] = m[:, :pad_h, :pad_w]
            gm[:n] = downsample2x_mask(mp)

        gb = np.zeros((g, 4), np.float32)
        gl = np.zeros((g,), np.int32)
        gb[:n] = boxes[:n]
        gl[:n] = labels[:n]
        return Sample(
            image=canvas, gt_bboxes=gb, gt_labels=gl, gt_masks=gm,
            img_shape=np.array([out_h, out_w], np.float32),
            ori_shape=ori_shape,
            scale_factor=np.array([sx, sy, sx, sy], np.float32),
            landscape=landscape, image_id=image_id)


class TestTransform:
    """Keep-ratio resize (no flip), normalize, pad to the bucket."""

    __test__ = False  # not a pytest test class despite the name

    def __init__(self, cfg):
        """cfg: a ``DataConfig`` (``sipmask_tpu_torch.config``)."""
        self.cfg = cfg
        self.mean = np.asarray(cfg.mean, np.float32)
        self.std = np.asarray(cfg.std, np.float32)

    def __call__(self, img, image_id=-1) -> Sample:
        """img: (H, W, 3) BGR uint8 (every reference test pipeline loads
        uint8, so the resize runs on uint8 and normalization follows)."""
        cfg = self.cfg
        ori_shape = img.shape[:2]
        h, w = ori_shape
        if cfg.fixed_size is not None:
            out_h, out_w = cfg.fixed_size
            landscape = True
            sx, sy = out_w / w, out_h / h     # imresize per-axis factors
        else:
            # test time always uses the canonical img_scale
            out_h, out_w = imrescale_size(h, w, cfg.img_scale)
            landscape = out_w >= out_h
            sx = sy = imrescale_factor(h, w, cfg.img_scale)
        img = resize_image(img, out_h, out_w)
        pad_h, pad_w = bucket_shape(cfg, landscape, train=False)
        return Sample(
            image=_normalized_canvas(img, self.mean, self.std, pad_h, pad_w),
            gt_bboxes=np.zeros((0, 4), np.float32),
            gt_labels=np.zeros((0,), np.int32),
            gt_masks=np.zeros((0, 1, 1), np.uint8),
            img_shape=np.array([out_h, out_w], np.float32),
            ori_shape=ori_shape,
            scale_factor=np.array([sx, sy, sx, sy], np.float32),
            landscape=landscape, image_id=image_id)
