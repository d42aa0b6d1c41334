"""Single-image inference API, the port of
``sipmask_tpu/apis/inference.py`` (init_detector / inference_detector).

Preprocessing uses numpy and torch only: caffe BGR mean subtraction and
zero padding to a multiple of ``size_divisor``, as the reference's test
pipeline does. Images must already be at the configured test scale (a
keep-ratio scale factor of 1, or exactly ``data.fixed_size``, 544x544 for
the real-time and SipMask++ presets); a resize that matches cv2's is not
ported yet. The mask paste runs on the device with ``F.interpolate``.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SipMaskConfig, get_config
from ..models.decode import decode_batch
from ..models.detector import build_model
from ..utils.convert import init_weights


class Detector:
    """A model on ``device`` plus its config; ``infer`` runs a padded batch
    through the model and the decode."""

    def __init__(self, cfg: SipMaskConfig, model, device):
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)

    @torch.no_grad()
    def infer(self, images, img_shapes, scale_factors):
        """images (B, 3, H, W) normalized and padded, on the device;
        img_shapes (B, 2) (h, w) before padding; scale_factors (B, 4).
        Returns ``decode_batch``'s dict of device tensors (with
        ``mask_scores`` when the model rescores, SipMask++)."""
        out = self.model(images)
        rescore = (self.model.rescore if self.cfg.model.head.rescoring
                   else None)
        return decode_batch(out, img_shapes, scale_factors, self.cfg.model,
                            rescore_fn=rescore)


def init_detector(config: Union[str, SipMaskConfig], device="cuda",
                  seed: int = 0) -> Detector:
    """Build the model, give it the reference's random init from ``seed``
    and move it to ``device`` in eval mode. Other weights load with
    ``det.model.load_state_dict``, e.g. from ``convert.params_from_jax``."""
    cfg = get_config(config) if isinstance(config, str) else config
    model = build_model(cfg.model)
    init_weights(model, torch.Generator().manual_seed(seed))
    return Detector(cfg, model.to(device).eval(), device)


def preprocess(img: np.ndarray, cfg: SipMaskConfig):
    """(H, W, 3) BGR uint8 -> (padded (Hp, Wp, 3) f32, img_shape (2,),
    scale_factor (4,)). Raises unless the image is already at the test
    scale."""
    d = cfg.data
    h, w = img.shape[:2]
    if d.fixed_size is not None:
        out_h, out_w = d.fixed_size
        sx, sy = out_w / w, out_h / h
    else:  # mmcv.imrescale's scalar factor and size, scale = (long, short)
        f = min(max(d.img_scale) / max(h, w), min(d.img_scale) / min(h, w))
        out_h, out_w = int(h * f + 0.5), int(w * f + 0.5)
        sx = sy = f
    if (out_h, out_w) != (h, w):
        raise NotImplementedError(
            f"image {h}x{w} needs a resize to {out_h}x{out_w}: resizing is "
            "not ported yet; pass images at the test scale")
    norm = (img.astype(np.float32) - np.asarray(d.mean, np.float32)) / \
        np.asarray(d.std, np.float32)
    div = d.size_divisor
    ph, pw = -(-h // div) * div, -(-w // div) * div
    padded = np.zeros((ph, pw, 3), np.float32)
    padded[:h, :w] = norm
    return (padded, np.array([h, w], np.float32),
            np.array([sx, sy, sx, sy], np.float32))


def paste_masks(masks, scale_factor, ori_shape, thr: float):
    """Stride-2 masks (D, Hm, Wm) -> (D, oh, ow) bool at the original image
    size: bilinear by 2/scale (half-pixel centres, as cv2.resize), crop,
    threshold."""
    oh, ow = ori_shape
    d, mh, mw = masks.shape
    if d == 0:
        return torch.zeros((0, oh, ow), dtype=torch.bool,
                           device=masks.device)
    size = (int(round(mh * 2.0 / float(scale_factor[1]))),
            int(round(mw * 2.0 / float(scale_factor[0]))))
    up = F.interpolate(masks[:, None], size=size, mode="bilinear",
                       align_corners=False)[:, 0]
    full = torch.zeros((d, oh, ow), dtype=torch.bool, device=masks.device)
    hh, ww = min(oh, size[0]), min(ow, size[1])
    full[:, :hh, :ww] = up[:, :hh, :ww] > thr
    return full


def inference_detector(det: Detector, img: np.ndarray):
    """img (H, W, 3) BGR uint8 -> dict of numpy arrays: boxes (N, 4) in
    original coordinates, scores (N,), labels (N,) 0-based, masks
    (N, H, W) bool, and mask_scores (N,) when the model rescores."""
    image, img_shape, scale_factor = preprocess(img, det.cfg)
    images = torch.from_numpy(image).permute(2, 0, 1)[None].to(det.device)
    out = det.infer(images, torch.from_numpy(img_shape)[None],
                    torch.from_numpy(scale_factor)[None])
    valid = out["valid"][0]
    masks = paste_masks(out["masks"][0][valid], scale_factor, img.shape[:2],
                        det.cfg.model.test.mask_thr)
    res = dict(boxes=out["boxes"][0][valid].cpu().numpy(),
               scores=out["scores"][0][valid].cpu().numpy(),
               labels=out["labels"][0][valid].cpu().numpy(),
               masks=masks.cpu().numpy())
    if "mask_scores" in out:   # SipMask++ rescoring: the segm ranking scores
        res["mask_scores"] = out["mask_scores"][0][valid].cpu().numpy()
    return res
