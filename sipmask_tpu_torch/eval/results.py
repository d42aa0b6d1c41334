"""Post-processing of decoded detections into COCO results, the port of
``sipmask_tpu/eval/results.py``: each image's stride-2 masks pasted on the
device by ``apis/inference.paste_masks`` (cv2's bilinear map at fx = 2 /
scale factor, cropped to the original image and thresholded) and
transposed there (COCO's runs are column-major), the batch's pasted masks
copied to the host at once, and each image's detections RLE-encoded in one
call of the C++ codec (``encode_masks_t``).

``postprocess_batch_plain`` is the plain host version: the whole stride-2
grid's probabilities resized in numpy (``imgops.resize_bilinear_f32``, the
same map) and encoded by the numpy codec.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..apis.inference import paste_masks
from ..data.imgops import resize_bilinear_f32
from . import rle
from .maskops import encode_masks_t


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _results(dets, i, valid, img_id, label2cat):
    """COCO result dicts of image i's valid detections, without masks."""
    has_ms = "mask_scores" in dets
    out = []
    for d in np.nonzero(valid)[0]:
        x1, y1, x2, y2 = dets["boxes"][i][d]
        score = dets["scores"][i][d]
        out.append(dict(
            image_id=img_id,
            category_id=int(label2cat[int(dets["labels"][i][d]) + 1]),
            bbox=[float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            score=float(dets["mask_scores"][i][d] if has_ms else score),
            det_score=float(score)))
    return out


def postprocess_batch(dets: Dict, image_ids, ori_shapes, label2cat,
                      mask_thr: float = 0.4, n_valid: Optional[int] = None,
                      timings: Optional[dict] = None) -> List[dict]:
    """Args:
      dets: ``decode_batch``'s output, tensors on the device (or numpy):
        boxes (B, D, 4) in original coordinates, scores, labels, valid,
        masks (B, D, Hm, Wm) sigmoid probabilities on the stride-2 input
        grid [+ mask_scores], and scale_factors (B, 4).
      ori_shapes: (B, 2) original (h, w).
      label2cat: contiguous label (1-based) -> COCO category id.
      timings: a dict that collects the host ms of the batch's ``paste``
        (the device paste and the copy to the host), its ``encode`` and the
        MB copied (``copied_mb``).
    Returns a flat list of COCO result dicts (bbox xywh, score, det_score,
    segmentation RLE) for the first ``n_valid`` images.
    """
    t0 = time.perf_counter()
    n = dets["boxes"].shape[0] if n_valid is None else n_valid
    masks = torch.as_tensor(dets["masks"])
    host = {k: _host(v) for k, v in dets.items() if k != "masks"}
    sf = host.get("scale_factors", np.ones((n, 4), np.float32))
    results, pasted = [], []
    for i in range(n):
        valid = host["valid"][i].astype(bool)
        if not valid.any():
            continue
        results.append(_results(host, i, valid, int(image_ids[i]),
                                label2cat))
        oh, ow = int(ori_shapes[i][0]), int(ori_shapes[i][1])
        rows = torch.from_numpy(np.nonzero(valid)[0]).to(masks.device)
        pasted.append(paste_masks(masks[i][rows], sf[i], (oh, ow),
                                  mask_thr).transpose(1, 2))
    flat = (torch.cat([p.reshape(-1) for p in pasted]).cpu().numpy()
            if pasted else np.zeros(0, bool))
    t1 = time.perf_counter()
    start = 0
    for res, p in zip(results, pasted):
        size = p.numel()
        segs = encode_masks_t(flat[start:start + size].reshape(p.shape))
        start += size
        for r, seg in zip(res, segs):
            r["segmentation"] = seg
    if timings is not None:
        t2 = time.perf_counter()
        timings.setdefault("paste", []).append((t1 - t0) * 1e3)
        timings.setdefault("encode", []).append((t2 - t1) * 1e3)
        timings.setdefault("copied_mb", []).append(flat.nbytes / 2 ** 20)
    return [r for res in results for r in res]


def postprocess_batch_plain(dets: Dict[str, np.ndarray], image_ids,
                            ori_shapes, label2cat, mask_thr: float = 0.4,
                            n_valid: Optional[int] = None) -> List[dict]:
    """``postprocess_batch`` on the host, from numpy dets: each image's
    stride-2 masks resized by fx = 2 / scale factor in numpy, cropped,
    thresholded and encoded by the numpy codec."""
    results = []
    n = dets["boxes"].shape[0] if n_valid is None else n_valid
    for i in range(n):
        valid = np.asarray(dets["valid"][i]).astype(bool)
        if not valid.any():
            continue
        res = _results(dets, i, valid, int(image_ids[i]), label2cat)
        masks = np.asarray(dets["masks"][i])[valid]
        oh, ow = int(ori_shapes[i][0]), int(ori_shapes[i][1])
        # the stride-2 grid covers the padded input; the original image is
        # its top-left (input / scale) region: resize by 2 / scale, crop
        up = resize_bilinear_f32(masks, fx=2.0 / _sf(dets, i, 0),
                                 fy=2.0 / _sf(dets, i, 1), axes=(1, 2))
        full = np.zeros((len(res), oh, ow), np.uint8)
        hh, ww = min(oh, up.shape[1]), min(ow, up.shape[2])
        full[:, :hh, :ww] = up[:, :hh, :ww] > mask_thr
        for m, r in zip(full, res):
            r["segmentation"] = rle.encode_mask(m)
        results.extend(res)
    return results


def _sf(dets, i, axis):
    sf = dets.get("scale_factors")
    return 1.0 if sf is None else float(np.asarray(sf)[i][axis])
