"""Host post-processing of decoded detections into COCO results, the port
of ``sipmask_tpu/eval/results.py``: each image's stride-2 masks resized by
cv2's bilinear map at fx = 2 / scale factor (``imgops.resize_bilinear_f32``,
the map ``apis/inference.paste_masks`` applies on the device), cropped to
the original image, thresholded and RLE-encoded.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..data.imgops import resize_bilinear_f32
from .maskops import encode_mask


def postprocess_batch(dets: Dict[str, np.ndarray], image_ids, ori_shapes,
                      label2cat, mask_thr: float = 0.4,
                      n_valid: Optional[int] = None) -> List[dict]:
    """Args:
      dets: ``decode_batch``'s output as numpy: boxes (B, D, 4) in original
        coordinates, scores, labels, valid, masks (B, D, Hm, Wm) sigmoid
        probabilities on the stride-2 input grid [+ mask_scores], and
        scale_factors (B, 4).
      ori_shapes: (B, 2) original (h, w).
      label2cat: contiguous label (1-based) -> COCO category id.
    Returns a flat list of COCO result dicts (bbox xywh, score, det_score,
    segmentation RLE) for the first ``n_valid`` images.
    """
    results = []
    n = dets["boxes"].shape[0] if n_valid is None else n_valid
    has_ms = "mask_scores" in dets
    for i in range(n):
        valid = np.asarray(dets["valid"][i]).astype(bool)
        if not valid.any():
            continue
        boxes = np.asarray(dets["boxes"][i])[valid]
        scores = np.asarray(dets["scores"][i])[valid]
        labels = np.asarray(dets["labels"][i])[valid]
        masks = np.asarray(dets["masks"][i])[valid]
        mscores = (np.asarray(dets["mask_scores"][i])[valid]
                   if has_ms else None)
        oh, ow = int(ori_shapes[i][0]), int(ori_shapes[i][1])
        img_id = int(image_ids[i])
        for d in range(len(boxes)):
            x1, y1, x2, y2 = boxes[d]
            results.append(dict(
                image_id=img_id,
                category_id=int(label2cat[int(labels[d]) + 1]),
                bbox=[float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
                score=float(mscores[d] if has_ms else scores[d]),
                det_score=float(scores[d])))
        # the stride-2 grid covers the padded input; the original image is
        # its top-left (input / scale) region: resize by 2 / scale, crop
        up = resize_bilinear_f32(masks, fx=2.0 / _sf(dets, i, 0),
                                 fy=2.0 / _sf(dets, i, 1), axes=(1, 2))
        full = np.zeros((len(boxes), oh, ow), np.uint8)
        hh, ww = min(oh, up.shape[1]), min(ow, up.shape[2])
        full[:, :hh, :ww] = up[:, :hh, :ww] > mask_thr
        for m, r in zip(full, results[-len(boxes):]):
            r["segmentation"] = encode_mask(m)
    return results


def _sf(dets, i, axis):
    sf = dets.get("scale_factors")
    return 1.0 if sf is None else float(np.asarray(sf)[i][axis])
