"""COCO instance-segmentation dataset without pycocotools, the port of
``sipmask_tpu/data/coco.py``: plain-JSON parsing, category-id ->
contiguous label mapping (1..80, background 0), mmdet's annotation filters
(skip iscrowd, area <= 0, w/h < 1; drop images without gt or smaller than
32px), and polygon rasterization with ``imgops.fill_polygons``
(cv2.fillPoly's pixels), also used for the eval's gt masks. Images are read
with ``image_io.imread``: JPEG (the C++ codec), PNG and PPM / PGM, as
``cv2.imread`` reads them.
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from ..eval.rle import decode_mask
from .image_io import imread
from .imgops import fill_polygons

COCO_CLASSES = (
    'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
    'truck', 'boat', 'traffic light', 'fire hydrant', 'stop sign',
    'parking meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep', 'cow',
    'elephant', 'bear', 'zebra', 'giraffe', 'backpack', 'umbrella',
    'handbag', 'tie', 'suitcase', 'frisbee', 'skis', 'snowboard',
    'sports ball', 'kite', 'baseball bat', 'baseball glove', 'skateboard',
    'surfboard', 'tennis racket', 'bottle', 'wine glass', 'cup', 'fork',
    'knife', 'spoon', 'bowl', 'banana', 'apple', 'sandwich', 'orange',
    'broccoli', 'carrot', 'hot dog', 'pizza', 'donut', 'cake', 'chair',
    'couch', 'potted plant', 'bed', 'dining table', 'toilet', 'tv',
    'laptop', 'mouse', 'remote', 'keyboard', 'cell phone', 'microwave',
    'oven', 'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
    'scissors', 'teddy bear', 'hair drier', 'toothbrush')


def rasterize_polygons(polygons: List[List[float]], h: int, w: int
                       ) -> np.ndarray:
    """Rasterize COCO polygon segmentation to a (h, w) uint8 mask."""
    pts = [np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    return fill_polygons(pts, h, w)


def decode_rle_counts(counts, h: int, w: int) -> np.ndarray:
    """Decode COCO RLE (uncompressed list or compressed LEB128 string) to a
    (h, w) uint8 mask (column-major runs, like pycocotools)."""
    return decode_mask({"size": [h, w], "counts": counts})


class CocoDataset:
    CLASSES = COCO_CLASSES

    def __init__(self, ann_file: str, img_prefix: str, test_mode: bool = False,
                 min_size: int = 32, filter_empty: bool = True):
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        with open(ann_file) as f:
            data = json.load(f)
        self.cat2label = {c["id"]: i + 1
                          for i, c in enumerate(data["categories"])}
        self.label2cat = {v: k for k, v in self.cat2label.items()}
        # instance-level class names from the json (checkpoint meta embeds
        # these, like the reference's CLASSES meta, tools/train.py:124-130)
        self.CLASSES = tuple(c.get("name", str(c["id"]))
                             for c in data["categories"])
        anns_by_img = {}
        for a in data.get("annotations", []):
            anns_by_img.setdefault(a["image_id"], []).append(a)

        self.images = []
        self.anns = []
        self.recall_anns = []
        for im in data["images"]:
            anns = anns_by_img.get(im["id"], [])
            valid = [a for a in anns
                     if not a.get("iscrowd", 0) and a.get("area", 1) > 0
                     and a["bbox"][2] >= 1 and a["bbox"][3] >= 1]
            if not test_mode:
                if filter_empty and not valid:
                    continue
                if min(im["width"], im["height"]) < min_size:
                    continue
            self.images.append(im)
            self.anns.append(valid)
            # proposal-recall gts keep degenerate boxes: the reference's
            # fast_eval_recall filters only ignore/iscrowd (coco.py:243-252),
            # not the area/size validity used for training targets
            self.recall_anns.append(
                [a for a in anns
                 if not a.get("iscrowd", 0) and not a.get("ignore", False)])

    def __len__(self):
        return len(self.images)

    def aspect_flag(self, idx) -> bool:
        """True = landscape (mmdet GroupSampler's aspect-ratio group)."""
        im = self.images[idx]
        return im["width"] >= im["height"]

    def image_id(self, idx) -> int:
        return self.images[idx]["id"]

    def load_image(self, idx) -> np.ndarray:
        path = os.path.join(self.img_prefix, self.images[idx]["file_name"])
        return imread(path)  # BGR, matching the caffe config

    def recall_gts(self, idx) -> np.ndarray:
        """(N, 4) xyxy gts for proposal-recall eval: every non-crowd,
        non-ignore annotation, including degenerate boxes (the reference's
        fast_eval_recall gt construction, datasets/coco.py:243-252)."""
        boxes = [[a["bbox"][0], a["bbox"][1],
                  a["bbox"][0] + a["bbox"][2] - 1,
                  a["bbox"][1] + a["bbox"][3] - 1]
                 for a in self.recall_anns[idx]]
        return (np.asarray(boxes, np.float32) if boxes
                else np.zeros((0, 4), np.float32))

    def get_ann(self, idx, with_masks: bool = True):
        """Returns (boxes xyxy (N,4) f32, labels (N,) int32,
        masks (N, H, W) uint8 or None)."""
        im = self.images[idx]
        h, w = im["height"], im["width"]
        boxes, labels, masks = [], [], []
        for a in self.anns[idx]:
            x, y, bw, bh = a["bbox"]
            boxes.append([x, y, x + bw - 1, y + bh - 1])
            labels.append(self.cat2label[a["category_id"]])
            if with_masks:
                seg = a.get("segmentation")
                if isinstance(seg, list):
                    masks.append(rasterize_polygons(seg, h, w))
                elif isinstance(seg, dict):
                    masks.append(decode_rle_counts(
                        seg["counts"], seg["size"][0], seg["size"][1]))
                else:
                    masks.append(np.zeros((h, w), np.uint8))
        boxes = (np.asarray(boxes, np.float32) if boxes
                 else np.zeros((0, 4), np.float32))
        labels = np.asarray(labels, np.int32)
        masks = (np.stack(masks) if masks else
                 np.zeros((0, h, w), np.uint8)) if with_masks else None
        return boxes, labels, masks
