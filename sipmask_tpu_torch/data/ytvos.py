"""YouTube-VIS dataset (video instance segmentation), the port of
``sipmask_tpu/data/ytvos.py``: plain-JSON parsing of the YTVIS format
(videos with per-frame file names; each annotation a track with per-frame
boxes, segmentations and areas).

- one sample per (video, frame); training keeps only frames with gts;
- ``sample_ref``: another valid frame of the same video, drawn from
  ``self.rng``;
- ``gt_pids``: for each gt of the current frame, 1 + its index among the
  reference frame's gts, 0 when the object is absent there;
- ``iter_videos`` / ``load_frame``: the frames of each video in order,
  read with ``image_io.imread`` (JPEG through the C++ codec, PNG and
  PPM / PGM, as ``cv2.imread`` reads them).
"""

from __future__ import annotations

import json
import os

import numpy as np

from .coco import decode_rle_counts, rasterize_polygons
from .image_io import imread

YTVOS_CLASSES = (
    'person', 'giant_panda', 'lizard', 'parrot', 'skateboard', 'sedan',
    'ape', 'dog', 'snake', 'monkey', 'hand', 'rabbit', 'duck', 'cat', 'cow',
    'fish', 'train', 'horse', 'turtle', 'bear', 'motorbike', 'giraffe',
    'leopard', 'fox', 'deer', 'owl', 'surfboard', 'airplane', 'truck',
    'zebra', 'tiger', 'elephant', 'snowboard', 'boat', 'shark', 'mouse',
    'frog', 'eagle', 'earless_seal', 'tennis_racket')


class YTVOSDataset:
    CLASSES = YTVOS_CLASSES

    def __init__(self, ann_file: str, img_prefix: str,
                 test_mode: bool = False, seed: int = 0):
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.rng = np.random.RandomState(seed)
        with open(ann_file) as f:
            data = json.load(f)
        self.videos = data["videos"]
        self.cat2label = {c["id"]: i + 1
                          for i, c in enumerate(data["categories"])}
        self.label2cat = {v: k for k, v in self.cat2label.items()}
        self.tracks_by_vid = {}
        for a in data.get("annotations", []):
            self.tracks_by_vid.setdefault(a["video_id"], []).append(a)

        self.img_ids = []   # (video index, frame index)
        for vi, v in enumerate(self.videos):
            for fi in range(len(v["file_names"])):
                if test_mode or len(self._frame_anns(vi, fi)[0]):
                    self.img_ids.append((vi, fi))
        self._valid_set = set(self.img_ids)

    def __len__(self):
        return len(self.img_ids)

    def aspect_flag(self, idx) -> bool:
        v = self.videos[self.img_ids[idx][0]]
        return v["width"] >= v["height"]

    def _frame_anns(self, vid_idx, frame_id):
        """(boxes xyxy, labels, segmentations, track ids) of one frame's
        non-crowd gts."""
        v = self.videos[vid_idx]
        boxes, labels, segs, obj_ids = [], [], [], []
        for t in self.tracks_by_vid.get(v["id"], []):
            bb = t["bboxes"][frame_id]
            if bb is None or t.get("iscrowd", 0):
                continue
            x, y, w, h = bb
            boxes.append([x, y, x + w - 1, y + h - 1])
            labels.append(self.cat2label[t["category_id"]])
            segs.append(t["segmentations"][frame_id])
            obj_ids.append(t["id"])
        return boxes, labels, segs, obj_ids

    def _masks(self, segs, h, w):
        out = []
        for s in segs:
            if s is None:
                out.append(np.zeros((h, w), np.uint8))
            elif isinstance(s, list):
                out.append(rasterize_polygons(s, h, w))
            else:
                out.append(decode_rle_counts(s["counts"], s["size"][0],
                                             s["size"][1]))
        return np.stack(out) if out else np.zeros((0, h, w), np.uint8)

    def load_frame(self, vid_idx, frame_id):
        v = self.videos[vid_idx]
        return imread(os.path.join(self.img_prefix,
                                   v["file_names"][frame_id]))

    def sample_ref(self, vid_idx, frame_id) -> int:
        valid = [f for (v, f) in self._valid_set
                 if v == vid_idx and f != frame_id]
        if not valid:
            raise ValueError(f"video {vid_idx} has a single valid frame")
        return int(self.rng.choice(valid))

    def get_train_pair(self, idx):
        """dict: img, ref_img, boxes / labels / masks of the current frame,
        ref_boxes / ref_labels, gt_pids."""
        vid_idx, frame_id = self.img_ids[idx]
        v = self.videos[vid_idx]
        h, w = v["height"], v["width"]
        ref_frame = self.sample_ref(vid_idx, frame_id)
        boxes, labels, segs, obj_ids = self._frame_anns(vid_idx, frame_id)
        rboxes, rlabels, _, robj_ids = self._frame_anns(vid_idx, ref_frame)
        gt_pids = [robj_ids.index(o) + 1 if o in robj_ids else 0
                   for o in obj_ids]
        return dict(
            img=self.load_frame(vid_idx, frame_id),
            ref_img=self.load_frame(vid_idx, ref_frame),
            boxes=np.asarray(boxes, np.float32).reshape(-1, 4),
            labels=np.asarray(labels, np.int32),
            masks=self._masks(segs, h, w),
            ref_boxes=np.asarray(rboxes, np.float32).reshape(-1, 4),
            ref_labels=np.asarray(rlabels, np.int32),
            gt_pids=np.asarray(gt_pids, np.int32))

    def iter_videos(self):
        """Yields (video_id, video index, number of frames)."""
        for vi, v in enumerate(self.videos):
            yield v["id"], vi, len(v["file_names"])
