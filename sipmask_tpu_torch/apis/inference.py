"""Single-image inference API, the port of
``sipmask_tpu/apis/inference.py``: ``init_detector``,
``inference_detector``, its async variant and ``show_result``.

Preprocessing is the port's ``TestTransform`` (numpy): the keep-ratio (or
fixed-size) resize with cv2's uint8 bilinear, caffe BGR mean subtraction
and zero padding to the static bucket, as the JAX ``Detector`` does. The
mask paste runs on the device with cv2's bilinear map at fx = 2 / scale
factor (``imgops.bilinear_f32_map``), as the JAX package's ``cv2.resize``
does on the host.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from ..config import SipMaskConfig, get_config
from ..data import draw, image_io
from ..data.imgops import bilinear_f32_map, scaled_size
from ..data.transforms import TestTransform
from ..models.decode import decode_batch
from ..models.detector import build_model
from ..utils.convert import init_weights
from ..utils.trace import span


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
        with span("sipmask.infer.forward"):
            out = self.model(images)
        with span("sipmask.infer.decode"):
            rescore = (self.model.rescore if self.cfg.model.head.rescoring
                       else None)
            return decode_batch(out, img_shapes, scale_factors,
                                self.cfg.model, rescore_fn=rescore)


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
    """(H, W, 3) BGR uint8 -> (padded (Hp, Wp, 3) f32 at the bucket shape,
    img_shape (2,), scale_factor (4,)): the port's ``TestTransform``."""
    s = TestTransform(cfg.data)(img)
    return s.image, s.img_shape, s.scale_factor


def paste_masks(masks, scale_factor, ori_shape, thr: float):
    """Stride-2 masks (D, Hm, Wm) -> (D, oh, ow) bool at the original image
    size, on the masks' device: ``cv2.resize(m, None, fx, fy)`` with
    fx = 2 / scale_factor[0] and fy = 2 / scale_factor[1] (float32, as the
    JAX package computes them), its bilinear map and its output size
    ``round(w * fx)``, then a crop to the image and the threshold."""
    oh, ow = ori_shape
    d, mh, mw = masks.shape
    full = torch.zeros((d, oh, ow), dtype=torch.bool, device=masks.device)
    if d == 0:
        return full
    sf = np.asarray(scale_factor, np.float32)
    fx, fy = np.float32(2) / sf[0], np.float32(2) / sf[1]
    out_h, out_w = scaled_size(mh, mw, fx, fy)
    (y0, y1, wy), (x0, x1, wx) = bilinear_f32_map(mh, mw, out_h, out_w,
                                                  fx, fy)
    hh, ww = min(oh, out_h), min(ow, out_w)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(masks.device)
    horiz = (masks[:, :, dev(x0[:ww])] * dev(np.float32(1) - wx[:ww])
             + masks[:, :, dev(x1[:ww])] * dev(wx[:ww]))
    up = (horiz[:, dev(y0[:hh])] * dev(np.float32(1) - wy[:hh])[:, None]
          + horiz[:, dev(y1[:hh])] * dev(wy[:hh])[:, None])
    full[:, :hh, :ww] = up > thr
    return full


def _dispatch(det: Detector, img: np.ndarray):
    """Preprocess ``img`` and run ``det.infer`` on it: (device outputs,
    the scale factor). CUDA runs the work asynchronously, so this returns
    once the forward and the decode are enqueued."""
    image, img_shape, scale_factor = preprocess(img, det.cfg)
    images = torch.from_numpy(image).permute(2, 0, 1)[None].to(det.device)
    out = det.infer(images, torch.from_numpy(img_shape)[None],
                    torch.from_numpy(scale_factor)[None])
    return out, scale_factor


def _postprocess(det: Detector, out, scale_factor, ori_shape):
    """Paste the valid detections' masks and copy the results to the
    host (the first read of ``out``, where a CUDA request waits)."""
    valid = out["valid"][0]
    masks = paste_masks(out["masks"][0][valid], scale_factor, ori_shape,
                        det.cfg.model.test.mask_thr)
    res = dict(boxes=out["boxes"][0][valid].cpu().numpy(),
               scores=out["scores"][0][valid].cpu().numpy(),
               labels=out["labels"][0][valid].cpu().numpy(),
               masks=masks.cpu().numpy())
    if "mask_scores" in out:   # SipMask++ rescoring: the segm ranking scores
        res["mask_scores"] = out["mask_scores"][0][valid].cpu().numpy()
    return res


def inference_detector(det: Detector, img: np.ndarray):
    """img (H, W, 3) BGR uint8 -> dict of numpy arrays: boxes (N, 4) in
    original coordinates, scores (N,), labels (N,) 0-based, masks
    (N, H, W) bool, and mask_scores (N,) when the model rescores."""
    out, scale_factor = _dispatch(det, img)
    return _postprocess(det, out, scale_factor, img.shape[:2])


async def async_inference_detector(det: Detector, img: np.ndarray):
    """The async variant of :func:`inference_detector` (the reference's
    ``async_inference_detector``): the request's forward and decode are
    enqueued on the calling thread, and the paste and the copy to the host,
    which wait for the device, run in a worker thread
    (``asyncio.to_thread``), so that concurrent requests overlap one's
    device work with another's host work. Gives what
    :func:`inference_detector` gives."""
    import asyncio

    out, scale_factor = _dispatch(det, img)
    return await asyncio.to_thread(_postprocess, det, out, scale_factor,
                                   img.shape[:2])


def show_result(img: np.ndarray, result, class_names, score_thr: float = 0.3,
                out_file=None) -> np.ndarray:
    """A copy of ``img`` with the detections above ``score_thr`` drawn as
    the JAX package's ``show_result`` draws them with cv2 (``data/draw.py``
    gives cv2's pixels): per detection, in order, its box (thickness 2) in
    its class's colour (``RandomState(42)``), its mask blended half and
    half with that colour (truncated), its label "name score" in
    FONT_HERSHEY_SIMPLEX at 0.5 just above the box. With ``out_file``
    the image is written there as JPEG at quality 95, ``cv2.imwrite``'s
    bytes."""
    img = img.copy()
    colors = np.random.RandomState(42).randint(0, 255, (80, 3))
    for i in range(len(result["boxes"])):
        if result["scores"][i] < score_thr:
            continue
        x1, y1, x2, y2 = result["boxes"][i].astype(int)
        c = tuple(int(v) for v in colors[int(result["labels"][i]) % 80])
        draw.rectangle(img, (x1, y1), (x2, y2), c)
        if len(result["masks"]):
            m = result["masks"][i]
            img[m] = img[m] * 0.5 + np.asarray(c) * 0.5
        name = class_names[int(result["labels"][i])]
        draw.put_text(img, f"{name} {result['scores'][i]:.2f}", (x1, y1 - 3),
                      c)
    if out_file:
        image_io.imwrite_jpeg(out_file, img)
    return img
