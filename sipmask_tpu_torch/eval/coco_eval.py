"""COCO detection/segmentation evaluation (COCOeval reimplementation), the
port of ``sipmask_tpu/eval/coco_eval.py``: greedy score-ordered matching
per (image, category) at IoU thresholds 0.5:0.05:0.95, crowd/ignore
handling, area ranges, maxDets 1/10/100, 101-point interpolated AP. IoUs
are computed once per (image, category) and reused across the four area
ranges, which only change the ignore flags. Segm IoUs are computed in
run space, gt polygons are rasterised and encoded, and the greedy matching
runs in C++, all through the codec (``maskops``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from ..data.coco import rasterize_polygons
from . import maskops

IOU_THRS = np.round(np.arange(0.5, 1.0, 0.05), 2)
REC_THRS = np.round(np.linspace(0.0, 1.0, 101), 2)
AREA_RNG = {
    "all": (0.0, 1e10),
    "small": (0.0, 32 ** 2),
    "medium": (32 ** 2, 96 ** 2),
    "large": (96 ** 2, 1e10),
}
MAX_DETS = 100
MAX_DETS_LIST = (1, 10, 100)  # AR@1/AR@10/AR@100 protocol columns


def bbox_iou_xywh(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray
                  ) -> np.ndarray:
    """pycocotools bbIou: xywh boxes, no +1; crowd gt -> inter/area_dt."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2) - np.maximum(dx1[:, None], gx1),
                 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2) - np.maximum(dy1[:, None], gy1),
                 0, None)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    union = np.where(iscrowd[None, :], da, da + ga - inter)
    return inter / np.maximum(union, 1e-12)


class COCOEvaluator:
    """Usage:
      ev = COCOEvaluator(ann_file, iou_type='segm')
      ev.update(results)   # list of dicts: image_id, category_id, score,
                           #   bbox xywh, segmentation RLE (for segm)
      stats = ev.summarize()
    """

    def __init__(self, ann_file: str, iou_type: str = "bbox",
                 ann_data: Optional[dict] = None):
        assert iou_type in ("bbox", "segm")
        self.iou_type = iou_type
        data = ann_data if ann_data is not None else json.load(open(ann_file))
        self.img_info = {im["id"]: im for im in data["images"]}
        self.cat_ids = [c["id"] for c in data["categories"]]
        self.gts = defaultdict(list)
        for a in data.get("annotations", []):
            a = dict(a)
            a["ignore"] = a.get("ignore", 0) or a.get("iscrowd", 0)
            self.gts[(a["image_id"], a["category_id"])].append(a)
        self.img_ids = sorted(self.img_info)
        self.dts = defaultdict(list)

    def update(self, results: List[dict]):
        for r in results:
            self.dts[(r["image_id"], r["category_id"])].append(r)

    # ------------------------------------------------------------------
    def _gt_rle(self, ann, h, w):
        seg = ann["segmentation"]
        if isinstance(seg, dict):
            return seg
        return maskops.encode_mask(rasterize_polygons(seg, h, w))

    def _prepare_img(self, img_id, cat_id):
        """Score-sort dts (maxDets cap), compute the IoU matrix once.

        Returns None when the (image, category) cell is empty, else a dict
        reused by every area range.
        """
        gts = self.gts.get((img_id, cat_id), [])
        dts = self.dts.get((img_id, cat_id), [])
        if not gts and not dts:
            return None
        scores = np.asarray([-d["score"] for d in dts])
        order_d = np.argsort(scores, kind="stable")[:MAX_DETS]
        dts = [dts[i] for i in order_d]
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)

        if self.iou_type == "bbox":
            ious = bbox_iou_xywh(
                np.asarray([d["bbox"] for d in dts], np.float64
                           ).reshape(-1, 4),
                np.asarray([g["bbox"] for g in gts], np.float64
                           ).reshape(-1, 4),
                iscrowd)
            dt_area = np.asarray([d["bbox"][2] * d["bbox"][3] for d in dts])
        else:
            info = self.img_info[img_id]
            h, w = info["height"], info["width"]
            drle = [d["segmentation"] for d in dts]
            grle = [self._gt_rle(g, h, w) for g in gts]
            ious = maskops.iou_matrix(drle, grle, iscrowd)
            dt_area = np.asarray([maskops.rle_area(r) for r in drle],
                                 np.float64)
        gt_area = np.asarray([g["area"] for g in gts], np.float64)
        gt_ignore0 = np.asarray([g["ignore"] for g in gts], bool)
        return dict(
            scores=np.asarray([d["score"] for d in dts]),
            ious=ious, iscrowd=iscrowd, dt_area=dt_area, gt_area=gt_area,
            gt_ignore0=gt_ignore0)

    @staticmethod
    def _evaluate_img(prep, area_rng):
        """Greedy matching for one (image, category, area-range) cell using
        the precomputed IoU matrix."""
        if prep is None:
            return None
        gt_ig = (prep["gt_ignore0"] | (prep["gt_area"] < area_rng[0])
                 | (prep["gt_area"] > area_rng[1]))
        order_g = np.argsort(gt_ig, kind="stable")
        gt_ig = gt_ig[order_g]
        iscrowd = prep["iscrowd"][order_g]
        ious = prep["ious"][:, order_g] if len(order_g) else prep["ious"]
        n_dt = len(prep["scores"])
        n_gt = len(gt_ig)

        dtm, dt_ig = maskops.greedy_match(
            np.asarray(ious, np.float64).reshape(n_dt, n_gt), IOU_THRS,
            gt_ig, iscrowd)
        dt_ig = dt_ig.astype(bool)
        out_of_rng = ((prep["dt_area"] < area_rng[0])
                      | (prep["dt_area"] > area_rng[1]))
        dt_ig = dt_ig | ((dtm == 0) & out_of_rng[None, :])
        return dict(
            scores=prep["scores"], dtm=dtm, dt_ig=dt_ig,
            n_gt=int((~gt_ig).sum()))

    def accumulate(self):
        k_n, t_n, r_n = len(self.cat_ids), len(IOU_THRS), len(REC_THRS)
        a_names = list(AREA_RNG)
        m_n = len(MAX_DETS_LIST)
        precision = -np.ones((t_n, r_n, k_n, len(a_names)))
        # recall follows the full pycocotools [T, K, A, M] protocol: each
        # maxDets column truncates PER IMAGE before the cross-image sort
        recall = -np.ones((t_n, k_n, len(a_names), m_n))
        for ki, cat in enumerate(self.cat_ids):
            preps = [self._prepare_img(i, cat) for i in self.img_ids]
            for ai, an in enumerate(a_names):
                evs = [self._evaluate_img(p, AREA_RNG[an]) for p in preps]
                evs = [e for e in evs if e is not None]
                if not evs:
                    continue
                n_gt = sum(e["n_gt"] for e in evs)
                if n_gt == 0:
                    continue
                for mi, md in enumerate(MAX_DETS_LIST):
                    scores = np.concatenate([e["scores"][:md] for e in evs])
                    order = np.argsort(-scores, kind="mergesort")
                    dtm = np.concatenate([e["dtm"][:, :md] for e in evs],
                                         1)[:, order]
                    dt_ig = np.concatenate([e["dt_ig"][:, :md] for e in evs],
                                           1)[:, order]
                    tps = (dtm > 0) & ~dt_ig
                    fps = (dtm == 0) & ~dt_ig
                    tp_c = np.cumsum(tps, 1).astype(np.float64)
                    fp_c = np.cumsum(fps, 1).astype(np.float64)
                    for ti in range(t_n):
                        tp, fp = tp_c[ti], fp_c[ti]
                        rc = tp / n_gt
                        recall[ti, ki, ai, mi] = rc[-1] if len(rc) else 0
                        if md != MAX_DETS:
                            continue  # precision uses maxDets=100 only
                        pr = tp / np.maximum(tp + fp, 1e-12)
                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(len(pr) - 1, 0, -1):
                            pr[i - 1] = max(pr[i - 1], pr[i])
                        inds = np.searchsorted(rc, REC_THRS, side="left")
                        q = np.zeros(r_n)
                        for rid, pid in enumerate(inds):
                            if pid < len(pr):
                                q[rid] = pr[pid]
                        precision[ti, :, ki, ai] = q
        self._precision, self._recall = precision, recall
        return precision, recall

    def summarize(self, verbose: bool = True) -> Dict[str, float]:
        if not hasattr(self, "_precision"):
            self.accumulate()
        p, r = self._precision, self._recall

        def ap(t=None, area="all"):
            ai = list(AREA_RNG).index(area)
            s = p[:, :, :, ai]
            if t is not None:
                s = s[[np.where(IOU_THRS == t)[0][0]]]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        def ar(area="all", max_dets=MAX_DETS):
            ai = list(AREA_RNG).index(area)
            mi = MAX_DETS_LIST.index(max_dets)
            s = r[:, :, ai, mi]
            s = s[s > -1]
            return float(s.mean()) if s.size else -1.0

        stats = {
            "AP": ap(), "AP50": ap(0.5), "AP75": ap(0.75),
            "APs": ap(area="small"), "APm": ap(area="medium"),
            "APl": ap(area="large"),
            "AR@1": ar(max_dets=1), "AR@10": ar(max_dets=10),
            "AR": ar(), "ARs": ar("small"), "ARm": ar("medium"),
            "ARl": ar("large"),
        }
        if verbose:
            for k, v in stats.items():
                print(f"  {self.iou_type} {k:5s} = {v:.4f}")
        return stats
