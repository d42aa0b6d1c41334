"""A video through a preset, drawn frame by frame (the JAX package's
``tools/video_demo.py``): image presets draw each frame's detections with
``show_result``; VIS presets (``model.head.track``) track them with the
streaming tracker and draw each tracked detection's box and "id score" in
its id's colour (``RandomState(7)``), as the JAX tool draws them:

    python -m sipmask_tpu_torch.tools.video_demo sipmask_vis_r50 \\
        'frames/%05d.jpg' --checkpoint WORK_DIR/epoch_12.pth \\
        --out 'out/%05d.jpg'

A video is an image sequence in the form ``cv2.VideoCapture`` also reads:
a ``printf`` pattern with one integer field (``%05d``, ``%d``), whose
numbering starts at the first of 0..4 that exists, or a directory of JPEG
and PNG files taken in name order. The output is what ``cv2.VideoWriter``
writes for a ``%0Nd`` name: one JPEG a frame at quality 95, numbered from
0. Containers (MP4, AVI) and camera indices are refused: the port reads
and writes no video codec. The JAX tool's arguments and ``--device``
(``cuda`` by default).
"""

from __future__ import annotations

import argparse
import os
import re

_FIELD = re.compile(r"%0?\d*d")
_IMAGES = (".jpg", ".jpeg", ".png")
SUPPORTED = ("an image sequence: a printf pattern with one integer field "
             "(e.g. frames/%05d.jpg) or a directory of .jpg/.png files; "
             "the output a pattern (e.g. out/%05d.jpg)")


def frame_paths(source: str):
    """The frame files of ``source`` in order (see the module note)."""
    if os.path.isdir(source):
        return [os.path.join(source, f) for f in sorted(os.listdir(source))
                if f.lower().endswith(_IMAGES)]
    if source.isdigit():
        raise SystemExit(f"camera {source}: cameras are not read; "
                         f"give {SUPPORTED}")
    if len(_FIELD.findall(source)) != 1:
        raise SystemExit(f"{source}: not a video this tool reads; give "
                         f"{SUPPORTED}")
    start = next((i for i in range(5) if os.path.exists(source % i)), None)
    if start is None:
        return []
    paths, i = [], start
    while os.path.exists(source % i):
        paths.append(source % i)
        i += 1
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description="Detect or track a video.")
    ap.add_argument("config")
    ap.add_argument("video", help="an image sequence: a %%0Nd pattern or a "
                    "directory of frames")
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--out", default="video_out/%05d.jpg",
                    help="a %%0Nd pattern of JPEG frames")
    ap.add_argument("--score-thr", type=float, default=0.3)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--cfg-options", nargs="+", default=None,
                    help="dotted config overrides (see tools/train.py)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    from ..apis.inference import (inference_detector, init_detector,
                                  preprocess, show_result)
    from ..config import apply_overrides, get_config
    from ..data import draw, image_io
    from ..data.coco import COCO_CLASSES
    from ..models.decode import decode_batch
    from ..models.track import (extract_center_feats, tracker_init,
                                tracker_step)
    from ..utils.checkpoint import load_weights
    from ..utils.precision import no_tf32

    no_tf32()
    if len(_FIELD.findall(args.out)) != 1 or \
            not args.out.lower().endswith((".jpg", ".jpeg")):
        raise SystemExit(f"--out {args.out}: video containers are not "
                         f"written; give {SUPPORTED}")
    paths = frame_paths(args.video)
    if not paths:
        raise SystemExit(f"could not open video source: {args.video}")
    cfg = apply_overrides(get_config(args.config), args.cfg_options)
    det = init_detector(cfg, args.device)
    if args.checkpoint:
        load_weights(args.checkpoint, det.model)
    is_vis = cfg.model.head.track
    class_names = COCO_CLASSES if not is_vis else tuple(
        f"c{i}" for i in range(cfg.model.head.num_classes))
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    state = tracker_init(cfg.model.track.max_tracks, device=det.device) \
        if is_vis else None
    id_colors = np.random.RandomState(7).randint(0, 255, (256, 3))
    frames = []      # per frame: the drawn detections (VIS: with ids)
    for fi, path in enumerate(paths):
        if args.max_frames and fi >= args.max_frames:
            break
        frame = image_io.imread(path)
        if not is_vis:
            result = inference_detector(det, frame)
            vis = show_result(frame, result, class_names,
                              score_thr=args.score_thr)
            frames.append(result)
        else:
            image, img_shape, scale_factor = preprocess(frame, cfg)
            sf = torch.from_numpy(scale_factor)
            with torch.no_grad():
                out = det.model(torch.from_numpy(image).permute(2, 0, 1)
                                [None].to(det.device))
                dets = decode_batch(out, torch.from_numpy(img_shape)[None],
                                    sf[None], cfg.model)
                feats = extract_center_feats(
                    out["track_feats"][0],
                    dets["boxes"][0] * sf.to(det.device)[None])
                state, obj_ids = tracker_step(
                    state, dets["boxes"][0], dets["scores"][0],
                    dets["labels"][0], dets["valid"][0], feats, fi == 0,
                    match_coeff=cfg.model.track.match_coeff)
            d = {k: v[0].cpu().numpy() for k, v in dets.items()}
            obj_ids = obj_ids.cpu().numpy()
            vis = frame.copy()
            drawn = []
            for i in range(len(obj_ids)):
                oid = int(obj_ids[i])
                if oid < 0 or not d["valid"][i] or \
                        d["scores"][i] < args.score_thr:
                    continue
                x1, y1, x2, y2 = d["boxes"][i].astype(int)
                c = tuple(int(v) for v in id_colors[oid % 256])
                draw.rectangle(vis, (x1, y1), (x2, y2), c)
                draw.put_text(vis, f"id{oid} {d['scores'][i]:.2f}",
                              (x1, y1 - 3), c)
                drawn.append((oid, d["boxes"][i], float(d["scores"][i])))
            frames.append(dict(ids=obj_ids, valid=d["valid"],
                               scores=d["scores"], drawn=drawn))
        image_io.imwrite_jpeg(args.out % fi, vis)
    print(f"wrote {args.out} ({len(frames)} frames)")
    return frames


if __name__ == "__main__":
    main()
