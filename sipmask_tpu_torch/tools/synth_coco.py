"""Write a synthetic COCO-format instance-segmentation set with PNG images:
filled polygons (annotated as polygons) and ellipses (annotated as
compressed RLE) on a noise background, with the 80 COCO categories and
their ids. numpy only; deterministic for a seed.

    python -m sipmask_tpu_torch.tools.synth_coco OUT_DIR \\
        --sizes 640x480 640x427 500x375 612x612 --repeat 2

writes ``OUT_DIR/ann.json`` and ``OUT_DIR/images/*.png`` (sizes are
width x height, each used ``--repeat`` times).
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.coco import COCO_CLASSES
from ..data.image_io import imwrite_png
from ..data.imgops import fill_polygons
from ..eval.rle import encode_mask

# the 80 category ids of COCO 2017 (1..90 with gaps)
COCO_IDS = (list(range(1, 12)) + list(range(13, 26)) + [27, 28]
            + list(range(31, 45)) + list(range(46, 66)) + [67, 70]
            + list(range(72, 83)) + list(range(84, 91)))
SMOKE_SIZES = ((640, 480), (640, 427), (500, 375), (612, 612))


def _shape(rng, h, w):
    """One instance: (mask, polygon or None). A polygon of 3-10 vertices
    around a centre, or an ellipse."""
    cx, cy = rng.uniform(0.1, 0.9) * w, rng.uniform(0.1, 0.9) * h
    rx, ry = rng.uniform(0.04, 0.25) * w, rng.uniform(0.04, 0.25) * h
    if rng.rand() < 0.7:
        n = rng.randint(3, 11)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        rad = rng.uniform(0.5, 1.0, n)
        pts = np.stack([cx + rx * rad * np.cos(ang),
                        cy + ry * rad * np.sin(ang)], 1)
        pts = np.clip(np.round(pts), 0, [w, h])
        mask = fill_polygons([pts.astype(np.int32)], h, w)
        return mask, pts.reshape(-1).tolist()
    yy, xx = np.mgrid[:h, :w]
    mask = ((((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2) <= 1)
    return mask.astype(np.uint8), None


def make_dataset(out_dir, sizes=SMOKE_SIZES, repeat=2, min_objs=8,
                 max_objs=16, seed=0):
    """Write the set; returns (ann_file, image_dir)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, "images")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i, (w, h) in enumerate([s for s in sizes for _ in range(repeat)]):
        img = rng.randint(0, 60, (h, w, 3)).astype(np.uint8)
        n_objs, placed = rng.randint(min_objs, max_objs + 1), 0
        while placed < n_objs:
            mask, poly = _shape(rng, h, w)
            ys, xs = np.nonzero(mask)
            if len(xs) < 20:
                continue
            placed += 1
            img[mask > 0] = rng.randint(80, 256, 3)
            x1, y1 = int(xs.min()), int(ys.min())
            if poly is None:
                rle = encode_mask(mask)
                seg = {"size": rle["size"], "counts": rle["counts"].decode()}
            else:
                seg = [poly]
            annotations.append(dict(
                id=len(annotations) + 1, image_id=i + 1,
                category_id=int(COCO_IDS[rng.randint(len(COCO_IDS))]),
                bbox=[x1, y1, int(xs.max()) - x1 + 1, int(ys.max()) - y1 + 1],
                area=int(mask.sum()), iscrowd=0, segmentation=seg))
        name = f"{i:04d}.png"
        imwrite_png(os.path.join(img_dir, name), img)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = os.path.join(out_dir, "ann.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=n) for c, n in
                                   zip(COCO_IDS, COCO_CLASSES)]), f)
    return ann_file, img_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--sizes", nargs="+", default=[f"{w}x{h}" for w, h in
                                                   SMOKE_SIZES],
                    help="image sizes, width x height")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--min-objs", type=int, default=8)
    ap.add_argument("--max-objs", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sizes = [tuple(int(v) for v in s.split("x")) for s in args.sizes]
    ann_file, img_dir = make_dataset(args.out_dir, sizes, args.repeat,
                                     args.min_objs, args.max_objs, args.seed)
    with open(ann_file) as f:
        n = len(json.load(f)["annotations"])
    print(f"wrote {ann_file} ({len(sizes) * args.repeat} images, {n} "
          f"annotations), images in {img_dir}")


if __name__ == "__main__":
    main()
