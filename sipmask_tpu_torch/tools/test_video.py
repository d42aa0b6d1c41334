"""Track the videos of a YouTube-VIS-format set with a SipMask-VIS preset
on one device, write the YTVIS results json, and with ``--eval`` score
them (the annotation file must carry gts):

    python -m sipmask_tpu_torch.tools.test_video sipmask_vis_r50 \\
        WORK_DIR/epoch_1.pth --ann ANN.json --img-prefix IMAGES --eval

The arguments of the JAX package's ``tools/test_video.py`` and
``--device`` (``cuda`` by default). Without a checkpoint the model keeps
its random init.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description="Track videos with a "
                                 "SipMask-VIS preset.")
    ap.add_argument("config", nargs="?", default="sipmask_vis_r50")
    ap.add_argument("checkpoint", nargs="?", default=None)
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-prefix", required=True)
    ap.add_argument("--out", default="results.json")
    ap.add_argument("--eval", action="store_true",
                    help="YouTube-VIS evaluation (needs gts in --ann)")
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..apis.inference import init_detector
    from ..apis.test_video import results_to_json, run_video_inference
    from ..config import apply_overrides, get_config
    from ..data.ytvos import YTVOSDataset
    from ..eval.ytvos_eval import YTVOSEvaluator
    from ..utils.checkpoint import load_weights
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    if not cfg.model.head.track:
        raise SystemExit(f"{args.config} is not a VIS preset")
    det = init_detector(cfg, args.device)
    if args.checkpoint:
        load_weights(args.checkpoint, det.model)
    dataset = YTVOSDataset(args.ann, args.img_prefix, test_mode=True)
    results = run_video_inference(det, dataset)
    with open(args.out, "w") as f:
        json.dump(results_to_json(results), f)
    print(f"wrote {args.out}: {len(results)} tracks")
    if not args.eval:
        return results, None
    ev = YTVOSEvaluator(args.ann)
    ev.update(results)
    return results, ev.summarize()


if __name__ == "__main__":
    main()
