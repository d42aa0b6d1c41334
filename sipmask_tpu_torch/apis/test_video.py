"""Video inference driver of SipMask-VIS, the port of
``sipmask_tpu/apis/test_video.py`` on one device: each video streamed frame
by frame (batch 1, the reference's protocol) through the model and
``decode_batch``, the embeddings read at the detections' centres, the
fixed-capacity tracker stepped on the device, the tracked detections'
masks pasted and transposed on the device (cv2's map at fx = 2 / scale
factor), copied to the host at once and RLE-encoded in one call of the C++
codec; each object becomes one YTVIS result with its mean score, its
majority category and its per-frame RLEs (None where absent).
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from ..data.transforms import TestTransform
from ..eval.maskops import encode_masks_t
from ..models.decode import decode_batch
from ..models.track import extract_center_feats, tracker_init, tracker_step
from .inference import paste_masks


def _sync_ms(dev, t0):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3


@torch.no_grad()
def run_video_inference(det, dataset, progress: bool = True,
                        timings: Optional[dict] = None) -> List[dict]:
    """YTVIS results of ``dataset`` (a test-mode ``YTVOSDataset``, or any
    object with its ``iter_videos`` and ``load_frame``) through ``det`` (an
    ``apis.inference.Detector`` of a tracking preset): dicts of video_id,
    score, category_id (1-based label) and segmentations (per frame an RLE
    dict, or None). ``timings``: a dict that collects the host ms of each
    frame's sections (``model`` with the decode and the embeddings,
    ``track``, ``paste`` with the RLEs), each ended by a synchronise."""
    cfg, dev = det.cfg, det.device
    transform = TestTransform(cfg.data)
    max_tracks = cfg.model.track.max_tracks
    thr = cfg.model.test.mask_thr
    results = []
    for video_id, vid_idx, n_frames in dataset.iter_videos():
        state = tracker_init(max_tracks, device=dev)
        vid_objs = {}
        for fi in range(n_frames):
            s = transform(dataset.load_frame(vid_idx, fi))
            t0 = time.perf_counter()
            images = torch.from_numpy(s.image).permute(2, 0, 1)[None].to(dev)
            sf = torch.from_numpy(s.scale_factor)
            out = det.model(images)
            dets = decode_batch(out, torch.from_numpy(s.img_shape)[None],
                                sf[None], cfg.model)
            # embeddings at the detections' centres, input coordinates
            feats = extract_center_feats(
                out["track_feats"][0], dets["boxes"][0] * sf.to(dev)[None])
            if timings is not None:
                timings.setdefault("model", []).append(_sync_ms(dev, t0))
                t0 = time.perf_counter()
            state, obj_ids = tracker_step(
                state, dets["boxes"][0], dets["scores"][0],
                dets["labels"][0], dets["valid"][0], feats, fi == 0,
                match_coeff=cfg.model.track.match_coeff)
            # the frame's one read-back: ids, validity, scores, labels
            host = torch.stack([obj_ids.double(), dets["valid"][0].double(),
                                dets["scores"][0].double(),
                                dets["labels"][0].double()]).cpu().numpy()
            if timings is not None:
                timings.setdefault("track", []).append(_sync_ms(dev, t0))
                t0 = time.perf_counter()
            keep = [i for i in range(host.shape[1])
                    if host[0, i] >= 0 and host[1, i]]
            if keep:
                # transposed on the device: COCO's runs are column-major
                segs = encode_masks_t(paste_masks(
                    dets["masks"][0][torch.tensor(keep, device=dev)],
                    s.scale_factor, s.ori_shape, thr).transpose(1, 2)
                    .contiguous().cpu().numpy())
            for j, i in enumerate(keep):
                o = vid_objs.setdefault(int(host[0, i]), dict(
                    scores=[], cats=[], segms={}))
                o["scores"].append(float(np.float32(host[2, i])))
                o["cats"].append(int(host[3, i]))
                # detection order: a later detection of an object
                # overwrites an earlier one's mask
                o["segms"][fi] = segs[j]
            if timings is not None:
                timings.setdefault("paste", []).append(_sync_ms(dev, t0))
        for o in vid_objs.values():
            results.append(dict(
                video_id=video_id, score=float(np.mean(o["scores"])),
                category_id=int(np.bincount(o["cats"]).argmax()) + 1,
                segmentations=[o["segms"].get(fi) for fi in range(n_frames)]))
        overflow = int(state.overflow)
        if overflow:
            print(f"  WARNING video {video_id}: tracker capacity "
                  f"({max_tracks}) exceeded, {overflow} LRU eviction(s) — "
                  "raise model.track.max_tracks for crowded videos",
                  flush=True)
        if progress:
            print(f"  video {video_id}: {len(vid_objs)} tracks", flush=True)
    return results


def results_to_json(results):
    """YTVIS results with their RLE counts as str, for ``json.dump``."""
    return [dict(r, segmentations=[
        None if s is None else {"size": s["size"],
                                "counts": s["counts"].decode()}
        for s in r["segmentations"]]) for r in results]
