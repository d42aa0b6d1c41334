"""YouTube-VIS evaluation, the port of ``sipmask_tpu/eval/ytvos_eval.py``
(a YTVOSeval reimplementation): track-level mask AP, where the IoU of a
predicted and a gt track is spatio-temporal (the sum over frames of the
intersections over the sum of the unions; a frame where either track is
absent counts through the other's area; a crowd gt divides by the
prediction's area alone). Matching and AP follow COCOeval: greedy per
(video, category), IoU 0.5:0.05:0.95, 101-point AP, the four area ranges
on each gt track's mean area. Track IoUs are computed once per (video,
category) and reused across the area ranges.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import List, Optional

import numpy as np

from ..data.coco import rasterize_polygons
from . import maskops
from .coco_eval import IOU_THRS, MAX_DETS, REC_THRS
from .rle import encode_counts, encode_mask


def _seg_to_rle(seg, h, w):
    """One frame's segmentation (RLE dict, polygon list or None) -> RLE;
    None is the empty mask (a single zero-run)."""
    if seg is None:
        return {"size": [h, w], "counts": encode_counts([h * w])}
    if isinstance(seg, dict):
        return seg
    return encode_mask(rasterize_polygons(seg, h, w))


def track_iou_matrix(dt_tracks, gt_tracks, h, w, iscrowd) -> np.ndarray:
    """Spatio-temporal IoU of every (dt, gt) track pair. dt_tracks /
    gt_tracks: lists of per-frame segmentation lists (entries RLE,
    polygons or None; a missing tail frame counts as None). A crowd gt
    gives inter / area_dt."""
    n_dt, n_gt = len(dt_tracks), len(gt_tracks)
    if n_dt == 0 or n_gt == 0:
        return np.zeros((n_dt, n_gt))
    t = len(dt_tracks[0])
    inter = np.zeros((n_dt, n_gt))
    area_d = np.zeros(n_dt)
    area_g = np.zeros(n_gt)
    for f in range(t):
        drles = [_seg_to_rle(tr[f] if f < len(tr) else None, h, w)
                 for tr in dt_tracks]
        grles = [_seg_to_rle(tr[f] if f < len(tr) else None, h, w)
                 for tr in gt_tracks]
        inter += maskops.inter_matrix(drles, grles)
        area_d += [maskops.rle_area(r) for r in drles]
        area_g += [maskops.rle_area(r) for r in grles]
    union = np.where(np.asarray(iscrowd, bool)[None, :], area_d[:, None],
                     area_d[:, None] + area_g[None, :] - inter)
    return inter / np.maximum(union, 1e-9)


def track_iou(dt_segs, gt_segs, h, w, iscrowd=False) -> float:
    """The spatio-temporal IoU of one pair of tracks."""
    return float(track_iou_matrix([list(dt_segs)], [list(gt_segs)], h, w,
                                  [iscrowd])[0, 0])


class YTVOSEvaluator:
    """Track-level mask AP on a YouTube-VIS-format json with annotations:

      ev = YTVOSEvaluator(ann_file)
      ev.update(results)   # dicts: video_id, category_id, score,
                           #   segmentations (per frame RLE or None)
      stats = ev.summarize()   # AP, AP50, AP75, APs, APm, APl
    """

    AREA_RNG = {"all": (0.0, 1e10), "small": (0.0, 32 ** 2),
                "medium": (32 ** 2, 96 ** 2), "large": (96 ** 2, 1e10)}

    def __init__(self, ann_file: Optional[str] = None,
                 ann_data: Optional[dict] = None):
        if ann_data is None:
            with open(ann_file) as f:
                ann_data = json.load(f)
        self.videos = {v["id"]: v for v in ann_data["videos"]}
        self.cat_ids = [c["id"] for c in ann_data["categories"]]
        self.gts = defaultdict(list)
        for a in ann_data.get("annotations", []):
            a = dict(a)
            a["ignore"] = a.get("ignore", 0) or a.get("iscrowd", 0)
            areas = [x for x in a.get("areas", []) if x]
            a["avg_area"] = float(np.mean(areas)) if areas else 0.0
            self.gts[(a["video_id"], a["category_id"])].append(a)
        self.dts = defaultdict(list)

    def update(self, results: List[dict]):
        for r in results:
            self.dts[(r["video_id"], r["category_id"])].append(r)

    def _prepare_vid(self, vid, cat):
        """The cell's score-sorted dts and its track IoU matrix."""
        gts = self.gts.get((vid, cat), [])
        dts = self.dts.get((vid, cat), [])
        if not gts and not dts:
            return None
        v = self.videos[vid]
        dts = sorted(dts, key=lambda d: -d["score"])[:MAX_DETS]
        iscrowd = np.asarray([g.get("iscrowd", 0) for g in gts], bool)
        ious = track_iou_matrix([d["segmentations"] for d in dts],
                                [g["segmentations"] for g in gts],
                                v["height"], v["width"], iscrowd)
        return dict(
            scores=np.asarray([d["score"] for d in dts]),
            ious=ious, iscrowd=iscrowd,
            gt_ignore0=np.asarray([g["ignore"] for g in gts], bool),
            gt_area=np.asarray([g["avg_area"] for g in gts], np.float64))

    @staticmethod
    def _evaluate_vid(prep, area_rng):
        if prep is None:
            return None
        gt_ig = (prep["gt_ignore0"] | (prep["gt_area"] < area_rng[0])
                 | (prep["gt_area"] > area_rng[1]))
        order_g = np.argsort(gt_ig, kind="stable")
        gt_ig = gt_ig[order_g]
        iscrowd = prep["iscrowd"][order_g]
        ious = prep["ious"][:, order_g] if len(order_g) else prep["ious"]
        n_dt, n_gt = len(prep["scores"]), len(gt_ig)
        dtm, dt_ig = maskops.greedy_match(
            np.asarray(ious, np.float64).reshape(n_dt, n_gt), IOU_THRS,
            gt_ig, iscrowd)
        return dict(scores=prep["scores"], dtm=dtm,
                    dt_ig=dt_ig.astype(bool), n_gt=int((~gt_ig).sum()))

    def summarize(self, verbose: bool = True):
        t_n, r_n = len(IOU_THRS), len(REC_THRS)
        aps = {}
        prep_by_cat = {cat: [self._prepare_vid(v, cat) for v in self.videos]
                       for cat in self.cat_ids}
        for an, rng_ in self.AREA_RNG.items():
            precision = -np.ones((t_n, r_n, len(self.cat_ids)))
            for ki, cat in enumerate(self.cat_ids):
                evs = [self._evaluate_vid(p, rng_) for p in prep_by_cat[cat]]
                evs = [e for e in evs if e is not None]
                if not evs:
                    continue
                scores = np.concatenate([e["scores"] for e in evs])
                order = np.argsort(-scores, kind="mergesort")
                dtm = np.concatenate([e["dtm"] for e in evs], 1)[:, order]
                dt_ig = np.concatenate([e["dt_ig"] for e in evs], 1)[:, order]
                n_gt = sum(e["n_gt"] for e in evs)
                if n_gt == 0:
                    continue
                tp_c = np.cumsum((dtm > 0) & ~dt_ig, 1).astype(float)
                fp_c = np.cumsum((dtm == 0) & ~dt_ig, 1).astype(float)
                for ti in range(t_n):
                    rc = tp_c[ti] / n_gt
                    pr = (tp_c[ti] / np.maximum(tp_c[ti] + fp_c[ti], 1e-12)
                          ).tolist()
                    for i in range(len(pr) - 1, 0, -1):
                        pr[i - 1] = max(pr[i - 1], pr[i])
                    inds = np.searchsorted(rc, REC_THRS, side="left")
                    q = np.zeros(r_n)
                    for rid, pid in enumerate(inds):
                        if pid < len(pr):
                            q[rid] = pr[pid]
                    precision[ti, :, ki] = q
            s = precision[precision > -1]
            aps[an] = float(s.mean()) if s.size else -1.0
            if an == "all":
                s50 = precision[0][precision[0] > -1]
                aps["AP50"] = float(s50.mean()) if s50.size else -1.0
                i75 = int(np.where(IOU_THRS == 0.75)[0][0])
                s75 = precision[i75][precision[i75] > -1]
                aps["AP75"] = float(s75.mean()) if s75.size else -1.0
        stats = {"AP": aps["all"], "AP50": aps["AP50"], "AP75": aps["AP75"],
                 "APs": aps["small"], "APm": aps["medium"],
                 "APl": aps["large"]}
        if verbose:
            for k, v in stats.items():
                print(f"  ytvis {k:5s} = {v:.4f}")
        return stats
