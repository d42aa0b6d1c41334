"""Write a small synthetic YouTube-VIS-format set with PNG frames: per
video, 1 to ``--max-objects`` shapes (bright ellipses 'disc', id 1; grey
rotated boxes 'slab', id 2) moving linearly over dark noise, with
per-frame polygon segmentations and track ids. numpy only; the JAX
package's ``tools/synth_ytvis.py`` with the same options and the same
``RandomState`` draws in the same order (so videos, objects, motions and
colours are its own), written as PNG. Each shape is annotated as the
polygon it is filled from (a disc as the 73-point polygon of
``cv2.ellipse``, a slab as its clipped corners), not as traced contours:

    python -m sipmask_tpu_torch.tools.synth_ytvis OUT_DIR \\
        --num-videos 4 --frames 4 --size 256

writes ``OUT_DIR/ann.json`` and ``OUT_DIR/imgs/vNNN/NNN.png``.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data.image_io import imwrite_png
from ..data.imgops import fill_polygons
from .synth_coco import _box_points, _ellipse_polygon


def make_dataset(out_dir, num_videos=6, frames=4, size=256, seed=0,
                 max_objects=2):
    """Write the set; returns (ann_file, image_dir)."""
    rng = np.random.RandomState(seed)
    img_root = os.path.join(out_dir, "imgs")
    videos, annotations = [], []
    for vi in range(num_videos):
        vdir = f"v{vi:03d}"
        os.makedirs(os.path.join(img_root, vdir), exist_ok=True)
        objs = []
        for _ in range(rng.randint(1, max_objects + 1)):
            objs.append(dict(
                cat=int(rng.randint(1, 3)),
                cx=float(rng.randint(size // 4, 3 * size // 4)),
                cy=float(rng.randint(size // 4, 3 * size // 4)),
                a=int(rng.randint(size // 8, size // 5)),
                b=int(rng.randint(size // 8, size // 5)),
                vx=float(rng.uniform(-8, 8)), vy=float(rng.uniform(-8, 8)),
                ang=float(rng.uniform(0, 180))))
        tracks = [dict(bboxes=[], segmentations=[], areas=[]) for _ in objs]
        file_names = []
        for fi in range(frames):
            img = rng.randint(0, 60, (size, size, 3), np.uint8)
            for o, tr in zip(objs, tracks):
                cx = int(np.clip(o["cx"] + o["vx"] * fi, o["a"],
                                 size - 1 - o["a"]))
                cy = int(np.clip(o["cy"] + o["vy"] * fi, o["b"],
                                 size - 1 - o["b"]))
                if o["cat"] == 1:
                    color = rng.randint(180, 255, 3)
                    pts = _ellipse_polygon(cx, cy, o["a"], o["b"])
                else:
                    color = rng.randint(90, 150, 3)
                    pts = np.clip(_box_points(cx, cy, 2.0 * o["a"],
                                              2.0 * o["b"], o["ang"]),
                                  0, size - 1).astype(np.int32)
                mask = fill_polygons([pts], size, size)
                img[mask > 0] = color
                ys, xs = np.nonzero(mask)
                if len(xs) < 20:
                    for k in ("bboxes", "segmentations", "areas"):
                        tr[k].append(None)
                    continue
                x1, y1 = int(xs.min()), int(ys.min())
                tr["bboxes"].append([x1, y1, int(xs.max()) - x1 + 1,
                                     int(ys.max()) - y1 + 1])
                tr["segmentations"].append(
                    [pts.reshape(-1).astype(float).tolist()])
                tr["areas"].append(int(mask.sum()))
            fn = f"{vdir}/{fi:03d}.png"
            imwrite_png(os.path.join(img_root, fn), img)
            file_names.append(fn)
        videos.append(dict(id=vi + 1, file_names=file_names, width=size,
                           height=size, length=frames))
        for o, tr in zip(objs, tracks):
            annotations.append(dict(id=len(annotations) + 1, video_id=vi + 1,
                                    category_id=o["cat"], iscrowd=0, **tr))
    ann_file = os.path.join(out_dir, "ann.json")
    with open(ann_file, "w") as f:
        json.dump(dict(videos=videos, annotations=annotations,
                       categories=[dict(id=1, name="disc"),
                                   dict(id=2, name="slab")]), f)
    return ann_file, img_root


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--num-videos", type=int, default=6)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-objects", type=int, default=2,
                    help="most objects a video (1: no crossing tracks)")
    args = ap.parse_args(argv)
    ann_file, img_root = make_dataset(args.out_dir, args.num_videos,
                                      args.frames, args.size, args.seed,
                                      args.max_objects)
    with open(ann_file) as f:
        n = len(json.load(f)["annotations"])
    print(f"wrote {ann_file} ({args.num_videos} videos x {args.frames} "
          f"frames, {n} tracks), images in {img_root}")
    return ann_file, img_root


if __name__ == "__main__":
    main()
