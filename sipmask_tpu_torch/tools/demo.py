"""One image through a preset, the detections drawn (the JAX package's
``tools/demo.py``):

    python -m sipmask_tpu_torch.tools.demo sipmask_r50_fpn_ssd_6x IMAGE \\
        --checkpoint WORK_DIR/epoch_12.pth --out demo_out.jpg

The image is read as ``cv2.imread`` reads it (JPEG, PNG, PPM), the result
drawn by ``show_result`` and written as JPEG at quality 95. The JAX
tool's arguments and ``--device`` (``cuda`` by default). Without a
checkpoint the model keeps its random init.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description="Detect and draw one image.")
    ap.add_argument("config")
    ap.add_argument("image")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="demo_out.jpg")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from ..apis.inference import (inference_detector, init_detector,
                                  show_result)
    from ..config import apply_overrides, get_config
    from ..data import image_io
    from ..data.coco import COCO_CLASSES
    from ..utils.checkpoint import load_weights
    from ..utils.precision import no_tf32

    no_tf32()
    try:
        img = image_io.imread(args.image)
    except (OSError, ValueError) as e:
        raise SystemExit(f"could not read image: {args.image} ({e})")
    det = init_detector(apply_overrides(get_config(args.config),
                                        args.cfg_options), args.device)
    if args.checkpoint:
        load_weights(args.checkpoint, det.model)
    result = inference_detector(det, img)
    show_result(img, result, COCO_CLASSES, score_thr=args.score_thr,
                out_file=args.out)
    print(f"wrote {args.out} with {len(result['boxes'])} detections")
    return result


if __name__ == "__main__":
    main()
