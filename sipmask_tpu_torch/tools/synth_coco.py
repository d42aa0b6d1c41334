"""Write a synthetic COCO-format instance-segmentation set with JPEG images
(quality 95, 4:2:0: the files ``cv2.imwrite`` writes for the same pixels).
numpy and the port's C++ JPEG codec; deterministic for a seed. Two kinds:

- the default: filled polygons (annotated as polygons) and ellipses
  (annotated as compressed RLE) on a noise background, with the 80 COCO
  categories and their ids:

    python -m sipmask_tpu_torch.tools.synth_coco OUT_DIR \\
        --sizes 640x480 640x427 500x375 612x612 --repeat 2

  writes ``OUT_DIR/ann.json`` and ``OUT_DIR/images/*.jpg`` (sizes are
  width x height, each used ``--repeat`` times);
- ``--shapes``: the JAX package's two-class set of its overfit protocol
  (``tools/synth_coco.py``: bright ellipses 'disc', id 1, and grey rotated
  boxes 'slab', id 2, on dark noise), from the same ``RandomState`` draws
  in the same order, so categories, centres, axes, colours and angles are
  its own. Slabs are filled and annotated as their corner polygon, as
  cv2 fills it; discs as the 73-point polygon of ``cv2.ellipse`` filled
  by the polygon fill (not cv2's convex fill: their masks are within a
  few boundary pixels of cv2's), annotated as RLE:

    python -m sipmask_tpu_torch.tools.synth_coco OUT_DIR --shapes \\
        --num-images 8 --size 256

  writes ``OUT_DIR/ann.json`` and ``OUT_DIR/imgs/*.jpg``, as the JAX tool
  does.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.coco import COCO_CLASSES
from ..data.image_io import imwrite_jpeg
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
        name = f"{i:04d}.jpg"
        imwrite_jpeg(os.path.join(img_dir, name), img)
        images.append(dict(id=i + 1, file_name=name, width=w, height=h))
    ann_file = os.path.join(out_dir, "ann.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=c, name=n) for c, n in
                                   zip(COCO_IDS, COCO_CLASSES)]), f)
    return ann_file, img_dir


def _box_points(cx, cy, w, h, angle):
    """``cv2.boxPoints(((cx, cy), (w, h), angle))`` in float32: the four
    corners of a rotated rectangle (angle in degrees)."""
    f = np.float32
    rad = float(f(angle)) * np.pi / 180.0
    b, a = f(np.cos(rad)) * f(0.5), f(np.sin(rad)) * f(0.5)
    cx, cy, w, h = f(cx), f(cy), f(w), f(h)
    p0 = (cx - a * h - b * w, cy + b * h - a * w)
    p1 = (cx + a * h - b * w, cy - b * h - a * w)
    return np.array([p0, p1, (f(2) * cx - p0[0], f(2) * cy - p0[1]),
                     (f(2) * cx - p1[0], f(2) * cy - p1[1])], f)


def _ellipse_polygon(cx, cy, a, b):
    """The vertices ``cv2.ellipse`` fills for an axis-aligned ellipse with
    axes of 15 px or more: every 5 degrees, rounded to pixels."""
    t = np.deg2rad(np.arange(0, 361, 5))
    pts = np.stack([cx + a * np.round(np.cos(t), 7),
                    cy + b * np.round(np.sin(t), 7)], 1)
    return np.round(pts).astype(np.int32)


def make_shapes_dataset(out_dir, num_images=8, size=256, max_objs=3,
                        seed=0):
    """The JAX package's ``tools/synth_coco.make_dataset`` set; returns
    (ann_file, image_dir)."""
    rng = np.random.RandomState(seed)
    img_dir = os.path.join(out_dir, "imgs")
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(num_images):
        img = rng.randint(0, 60, (size, size, 3), np.uint8)
        for _ in range(rng.randint(2, max_objs + 1)):
            cat = int(rng.randint(1, 3))
            cx, cy = rng.randint(size // 5, 4 * size // 5, 2)
            a = rng.randint(size // 10, size // 4)
            b = rng.randint(size // 10, size // 4)
            if cat == 1:   # bright ellipse
                color = rng.randint(180, 255, 3)
                mask = fill_polygons([_ellipse_polygon(cx, cy, a, b)],
                                     size, size)
                poly = None
            else:          # grey rotated box
                color = rng.randint(90, 150, 3)
                ang = float(rng.uniform(0, 180))
                pts = np.clip(_box_points(cx, cy, 2 * a, 2 * b, ang), 0,
                              size - 1).astype(np.int32)
                mask, poly = fill_polygons([pts], size, size), pts
            img[mask > 0] = color
            ys, xs = np.nonzero(mask)
            if len(xs) < 20:
                continue
            if poly is None:
                rle = encode_mask(mask)
                seg = {"size": rle["size"], "counts": rle["counts"].decode()}
            else:
                seg = [poly.reshape(-1).astype(float).tolist()]
            x1, y1 = int(xs.min()), int(ys.min())
            annotations.append(dict(
                id=len(annotations) + 1, image_id=i + 1, category_id=cat,
                bbox=[x1, y1, int(xs.max()) - x1 + 1, int(ys.max()) - y1 + 1],
                area=int(mask.sum()), iscrowd=0, segmentation=seg))
        name = f"{i:04d}.jpg"
        imwrite_jpeg(os.path.join(img_dir, name), img)
        images.append(dict(id=i + 1, file_name=name, width=size,
                           height=size))
    ann_file = os.path.join(out_dir, "ann.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=annotations,
                       categories=[dict(id=1, name="disc"),
                                   dict(id=2, name="slab")]), f)
    return ann_file, img_dir


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--shapes", action="store_true",
                    help="the two-class disc / slab set of the overfit "
                         "protocol")
    ap.add_argument("--num-images", type=int, default=8,
                    help="--shapes: number of images")
    ap.add_argument("--size", type=int, default=256,
                    help="--shapes: image side")
    ap.add_argument("--sizes", nargs="+", default=[f"{w}x{h}" for w, h in
                                                   SMOKE_SIZES],
                    help="image sizes, width x height")
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--min-objs", type=int, default=8)
    ap.add_argument("--max-objs", type=int, default=None,
                    help="most objects an image (default: the mode's own, "
                         "16, or 3 with --shapes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    given = {} if args.max_objs is None else {"max_objs": args.max_objs}
    if args.shapes:
        ann_file, img_dir = make_shapes_dataset(
            args.out_dir, args.num_images, args.size, seed=args.seed, **given)
        n_img = args.num_images
    else:
        sizes = [tuple(int(v) for v in s.split("x")) for s in args.sizes]
        ann_file, img_dir = make_dataset(
            args.out_dir, sizes, args.repeat, args.min_objs, seed=args.seed,
            **given)
        n_img = len(sizes) * args.repeat
    with open(ann_file) as f:
        n = len(json.load(f)["annotations"])
    print(f"wrote {ann_file} ({n_img} images, {n} annotations), images in "
          f"{img_dir}")


if __name__ == "__main__":
    main()
