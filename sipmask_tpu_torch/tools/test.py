"""Evaluate a SipMask preset with the port on one device (COCO bbox and
segm):

    python -m sipmask_tpu_torch.tools.test sipmask_r50_fpn_gn_1x \\
        WORK_DIR/epoch_1.pth --ann ANN.json --img-prefix IMAGES

The arguments of the JAX package's ``tools/test.py`` without the
distributed ones, and ``--device`` (``cuda`` by default). Without a
checkpoint the model keeps its random init.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description="Evaluate a SipMask preset.")
    ap.add_argument("config")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-prefix", required=True)
    ap.add_argument("--out", default=None, help="write the results json")
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--eval", nargs="+", default=["bbox", "segm"])
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..apis.inference import init_detector
    from ..apis.test import evaluate_coco, results_to_json, run_inference
    from ..config import apply_overrides, get_config
    from ..data.coco import CocoDataset
    from ..utils.checkpoint import load_weights

    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    det = init_detector(cfg, args.device)
    if args.checkpoint:
        load_weights(args.checkpoint, det.model)
    dataset = CocoDataset(args.ann, args.img_prefix, test_mode=True)
    results = run_inference(det, dataset, batch_size=args.batch_size)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results_to_json(results), f)
    return evaluate_coco(results, args.ann, metrics=args.eval)


if __name__ == "__main__":
    main()
