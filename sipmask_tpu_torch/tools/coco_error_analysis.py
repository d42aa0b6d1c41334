"""Per-category AP and a localisation / background error split of COCO
results (the JAX package's ``tools/coco_error_analysis.py``), on the
port's ``eval/coco_eval.py``:

    python -m sipmask_tpu_torch.tools.coco_error_analysis results.json \\
        --ann ANN.json --types bbox segm

``results.json`` is what ``tools/test.py --out`` writes. Per type: each
category's AP@[.5:.95] and AP50, best first; the overall AP, AP50 and AP
at IoU 0.1 (the matching rerun with ``coco_eval.IOU_THRS`` set to [0.1],
as the JAX tool patches its evaluator); and the shares AP@0.1 - AP50
(localisation) and 1 - AP@0.1 (background and missed).
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description="COCO error analysis.")
    ap.add_argument("results", help="results json from tools/test.py --out")
    ap.add_argument("--ann", required=True)
    ap.add_argument("--types", nargs="+", default=["bbox", "segm"])
    args = ap.parse_args(argv)

    import numpy as np
    from ..eval import coco_eval as ce
    from ..utils.precision import no_tf32

    no_tf32()
    with open(args.results) as f:
        results = json.load(f)
    for r in results:
        seg = r.get("segmentation")
        if isinstance(seg, dict) and isinstance(seg["counts"], str):
            seg["counts"] = seg["counts"].encode()

    with open(args.ann) as f:
        data = json.load(f)
    cat_names = {c["id"]: c["name"] for c in data["categories"]}

    for iou_type in args.types:
        ev = ce.COCOEvaluator(args.ann, iou_type=iou_type, ann_data=data)
        if iou_type == "bbox":
            ev.update([{**r, "score": r.get("det_score", r["score"])}
                       for r in results])
        else:
            ev.update([r for r in results if "segmentation" in r])
        precision, _ = ev.accumulate()  # (T, R, K, A)
        print(f"\n== {iou_type} per-category AP ==")
        rows = []
        for ki, cat in enumerate(ev.cat_ids):
            s = precision[:, :, ki, 0]
            sv = s[s > -1]
            ap_all = float(sv.mean()) if sv.size else float("nan")
            s50 = precision[0, :, ki, 0]
            ap50 = float(s50[s50 > -1].mean()) if (s50 > -1).any() else \
                float("nan")
            rows.append((cat_names.get(cat, str(cat)), ap_all, ap50))
        rows.sort(key=lambda r: -(r[1] if r[1] == r[1] else -1))
        for name, ap_a, ap_5 in rows:
            print(f"  {name:>20s}  AP {ap_a:6.3f}  AP50 {ap_5:6.3f}")

        # error decomposition at loose IoU: rerun matching with IoU thr 0.1
        loose = ce.IOU_THRS.copy()
        try:
            ce.IOU_THRS = np.asarray([0.1])
            ev_loose = ce.COCOEvaluator(args.ann, iou_type=iou_type,
                                        ann_data=data)
            ev_loose.update([d for v in ev.dts.values() for d in v])
            p_l, _ = ev_loose.accumulate()
            s = p_l[:, :, :, 0]
            ap_loc = float(s[s > -1].mean()) if (s > -1).any() else 0.0
        finally:
            ce.IOU_THRS = loose
        s = precision[:, :, :, 0]
        ap = float(s[s > -1].mean()) if (s > -1).any() else 0.0
        s50 = precision[0, :, :, 0]
        ap50 = float(s50[s50 > -1].mean()) if (s50 > -1).any() else 0.0
        print(f"  overall: AP {ap:.3f}  AP50 {ap50:.3f}  "
              f"AP@0.1 {ap_loc:.3f}")
        print(f"  error shares: localization {max(ap_loc - ap50, 0):.3f}  "
              f"bg+missed {max(1.0 - ap_loc, 0):.3f}")


if __name__ == "__main__":
    main()
