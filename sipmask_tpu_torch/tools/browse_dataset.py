"""Look at what the training pipeline feeds the model (the JAX package's
``tools/browse_dataset.py``): each sample through the preset's
``TrainTransform`` (resize, flip, SSD augmentations, padding), the
normalisation undone, its gt boxes (thickness 2) and its masks (nearest-
resized from the stride-2 grid, blended half and half) drawn in a colour
of the label, written as JPEG at quality 95:

    python -m sipmask_tpu_torch.tools.browse_dataset sipmask_r50_fpn_gn_1x \\
        --ann ANN.json --img-prefix IMAGES --out-dir browse_out --num 10
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    ap = argparse.ArgumentParser(description="Draw training samples.")
    ap.add_argument("config")
    ap.add_argument("--ann", required=True)
    ap.add_argument("--img-prefix", required=True)
    ap.add_argument("--out-dir", default="browse_out")
    ap.add_argument("--num", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    args = ap.parse_args(argv)

    import numpy as np
    from ..config import apply_overrides, get_config
    from ..data import draw, image_io
    from ..data.coco import CocoDataset
    from ..data.imgops import resize_nearest
    from ..data.transforms import TrainTransform
    from ..utils.precision import no_tf32

    no_tf32()
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    dataset = CocoDataset(args.ann, args.img_prefix)
    transform = TrainTransform(cfg.data, seed=args.seed)
    os.makedirs(args.out_dir, exist_ok=True)
    mean = np.asarray(cfg.data.mean, np.float32)
    std = np.asarray(cfg.data.std, np.float32)
    colors = np.random.RandomState(3).randint(0, 255, (256, 3))
    paths = []
    for i in range(min(args.num, len(dataset))):
        boxes, labels, masks = dataset.get_ann(i)
        s = transform(dataset.load_image(i), boxes, labels, masks,
                      image_id=dataset.image_id(i))
        img = np.clip(s.image * std + mean, 0, 255).astype(np.uint8).copy()
        n = int((s.gt_labels > 0).sum())
        for j in range(n):
            x1, y1, x2, y2 = s.gt_bboxes[j].astype(int)
            c = tuple(int(v) for v in colors[int(s.gt_labels[j]) % 256])
            draw.rectangle(img, (x1, y1), (x2, y2), c)
            if s.gt_masks is not None and j < len(s.gt_masks):
                # gt masks are stored at the stride-2 basis resolution
                m = resize_nearest(s.gt_masks[j].astype(np.float32),
                                   img.shape[0], img.shape[1]) > 0.5
                img[m] = img[m] * 0.5 + np.asarray(c) * 0.5
        path = os.path.join(args.out_dir, f"sample_{i:04d}.jpg")
        image_io.imwrite_jpeg(path, img)
        print(f"{path}: {n} instances, shape {img.shape[:2]}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
