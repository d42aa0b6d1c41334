"""Inference and evaluation driver, the port of ``sipmask_tpu/apis/test.py``
on one device: aspect-grouped test batches through ``Detector.infer``, the
masks pasted on the device (cv2's map at fx = 2 / scale factor), one copy
of the batch's thresholded masks to the host and each image's detections
RLE-encoded by the C++ codec (``eval/results.postprocess_batch``); then
the COCOeval protocol for bbox and segm and the proposal recall
(``proposal_fast``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..data.coco import CocoDataset
from ..data.loader import build_test_loader
from ..data.transforms import TestTransform
from ..eval.coco_eval import COCOEvaluator
from ..eval.recall import fast_eval_recall
from ..eval.results import postprocess_batch


def run_inference(det, dataset, batch_size: int = 4,
                  progress: bool = True, timings: Optional[dict] = None):
    """The flat COCO-format result list of ``dataset`` (a test-mode
    ``CocoDataset``) through ``det`` (an ``apis.inference.Detector``), in
    the loader's order (landscape images, then portrait). The last batch of
    each group is padded by repeating its final image; the repeats' results
    are dropped. ``timings``: a dict that collects each batch's paste and
    encode ms and the MB copied to the host (``postprocess_batch``)."""
    loader = build_test_loader(dataset, TestTransform(det.cfg.data),
                               batch_size=batch_size)
    results, n_done = [], 0
    for batch, n_valid in loader:
        images = torch.from_numpy(batch["images"]).to(det.device)
        dets = det.infer(images.permute(0, 3, 1, 2).contiguous(),
                         torch.from_numpy(batch["img_shapes"]),
                         torch.from_numpy(batch["scale_factors"]))
        dets["scale_factors"] = batch["scale_factors"]
        results.extend(postprocess_batch(
            dets, batch["image_ids"], batch["ori_shapes"],
            dataset.label2cat, mask_thr=det.cfg.model.test.mask_thr,
            n_valid=n_valid, timings=timings))
        n_done += n_valid
        if progress and n_done % 200 < batch_size:
            print(f"  inference {n_done}/{len(dataset)}", flush=True)
    return results


def evaluate_coco(results, ann_file: str, metrics=("bbox", "segm"),
                  dataset=None):
    """COCOeval on bbox and segm: bbox ranks by the detector's score, segm
    by ``score`` (the mask score when the model rescores). ``proposal_fast``
    is the reference's proposal recall (``eval/recall.fast_eval_recall``)
    on the detector's boxes and scores against ``dataset`` (by default a
    test-mode ``CocoDataset`` of ``ann_file``): AR@100, AR@300 and AR@1000,
    each the mean over IoU 0.5:0.95. Returns {metric: stats}."""
    stats = {}
    for it in metrics:
        if it == "proposal_fast":
            ds = dataset or CocoDataset(ann_file, "", test_mode=True)
            print("== proposal_fast ==")
            ar = fast_eval_recall(
                [{**r, "score": r.get("det_score", r["score"])}
                 for r in results], ds)
            stats[it] = {f"AR@{n}": float(ar[i].mean())
                         for i, n in enumerate((100, 300, 1000))}
            continue
        if it not in ("bbox", "segm"):
            raise ValueError(f"metric {it!r}: bbox, segm or proposal_fast")
        ev = COCOEvaluator(ann_file, iou_type=it)
        if it == "bbox":
            ev.update([{**r, "score": r.get("det_score", r["score"])}
                       for r in results])
        else:
            ev.update([r for r in results if "segmentation" in r])
        print(f"== {it} ==")
        stats[it] = ev.summarize()
    return stats


def results_to_json(results):
    """COCO results with their RLE counts as str, for ``json.dump``."""
    out = []
    for r in results:
        r = dict(r)
        if "segmentation" in r:
            seg = r["segmentation"]
            r["segmentation"] = {"size": seg["size"],
                                 "counts": seg["counts"].decode()}
        out.append(r)
    return out
