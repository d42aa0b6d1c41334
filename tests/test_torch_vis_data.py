"""SipMask-VIS's data and evaluation in the port (sipmask_tpu_torch) against
the JAX package: YTVOSDataset's frame pairs and gt_pids, VISPairTransform
under the same seed (images bit for bit, boxes, masks, gt_pids, with flips,
multi-scale draws and the reference-box jitter), build_vis_train_loader's
batches with one worker thread and with worker processes, the synthetic
YouTube-VIS tool, and YTVOSEvaluator's stats (a perfect track, missing
frames, crowds, and single-frame videos against COCO segm)."""

import json

import numpy as np
import pytest

from sipmask_tpu.config import DataConfig
from sipmask_tpu.data.loader import build_vis_train_loader as j_build
from sipmask_tpu.data.transforms import VISPairTransform as JTransform
from sipmask_tpu.data.ytvos import YTVOSDataset as JDataset
from sipmask_tpu.eval.ytvos_eval import YTVOSEvaluator as JEvaluator
from sipmask_tpu.eval.ytvos_eval import track_iou as j_track_iou
from sipmask_tpu_torch.data.loader import build_vis_train_loader
from sipmask_tpu_torch.data.transforms import VISPairTransform
from sipmask_tpu_torch.data.ytvos import YTVOSDataset
from sipmask_tpu_torch.eval.rle import encode_mask
from sipmask_tpu_torch.eval.ytvos_eval import YTVOSEvaluator, track_iou
from sipmask_tpu_torch.tools.synth_ytvis import make_dataset


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """5 videos of 4 frames at 96x96, 1-3 moving objects each, written by
    the port's tool as JPEG; the first track of each video is absent from
    its second frame (None entries: gt_pids 0 for its other frames), and
    the last video is portrait (its frames padded into 120x96 and written
    again), so the loaders group two aspects."""
    from sipmask_tpu_torch.data.image_io import imread, imwrite_jpeg
    out = tmp_path_factory.mktemp("vis")
    ann, imgs = make_dataset(str(out), num_videos=5, frames=4, size=96,
                             seed=2, max_objects=3)
    with open(ann) as f:
        data = json.load(f)
    v = data["videos"][-1]
    for fn in v["file_names"]:
        img = imread(f"{imgs}/{fn}")
        tall = np.zeros((120, 96, 3), np.uint8)
        tall[:96] = img
        imwrite_jpeg(f"{imgs}/{fn}", tall)
    v["height"] = 120
    first = {}
    for a in data["annotations"]:
        if first.setdefault(a["video_id"], a["id"]) == a["id"]:
            for k in ("bboxes", "segmentations", "areas"):
                a[k][1] = None
    with open(ann, "w") as f:
        json.dump(data, f)
    return ann, imgs


def _cfg(**kw):
    base = dict(img_scale=(160, 128), max_gts=6)
    base.update(kw)
    return DataConfig(**base)


def _assert_equal_dicts(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)


def test_dataset_pairs_and_gt_pids_match_jax(synth):
    """Every training sample's pair (its reference frame drawn from the
    dataset's rng, the same draws in both) and the test-mode iteration."""
    jds, ds = JDataset(*synth, seed=4), YTVOSDataset(*synth, seed=4)
    assert ds.img_ids == jds.img_ids and len(ds) > 12
    seen_zero = False
    for i in range(len(ds)):
        want, got = jds.get_train_pair(i), ds.get_train_pair(i)
        _assert_equal_dicts(got, want)
        assert ds.aspect_flag(i) == jds.aspect_flag(i)
        seen_zero |= bool((got["gt_pids"] == 0).any())
        assert set(got["gt_pids"]) <= set(range(len(got["ref_labels"]) + 1))
    assert seen_zero   # an object absent from its reference frame
    t, jt = YTVOSDataset(*synth, True), JDataset(*synth, True)
    assert list(t.iter_videos()) == list(jt.iter_videos())
    assert len(t) == sum(len(v["file_names"]) for v in t.videos)
    np.testing.assert_array_equal(t.load_frame(4, 3), jt.load_frame(4, 3))


@pytest.mark.parametrize("kw", [
    dict(flip_ratio=0.5),
    dict(flip_ratio=0.5, ms_scales=((160, 96), (200, 128))),
    dict(flip_ratio=0.5, ms_scales=((160, 96), (200, 128)),
         ms_mode="value"),
    dict(fixed_size=(96, 128), keep_ratio=False, flip_ratio=0.5),
], ids=["flip", "ms range", "ms value", "fixed"])
@pytest.mark.parametrize("jitter", [0.0, 0.1])
def test_pair_transform_matches_jax(synth, kw, jitter):
    """The same seed gives the same draws (flip, then scale, then the
    jitter), so the same arrays; jitter 0 draws nothing."""
    cfg = _cfg(**kw)
    jds, ds = JDataset(*synth, seed=1), YTVOSDataset(*synth, seed=1)
    jtf = JTransform(cfg, seed=3, jitter_amplitude=jitter)
    tf = VISPairTransform(cfg, seed=3, jitter_amplitude=jitter)
    for i in list(range(len(ds))) * 2:
        want, got = jtf(jds.get_train_pair(i)), tf(ds.get_train_pair(i))
        _assert_equal_dicts(got, want)
    assert tf.rng.randint(1 << 30) == jtf.rng.randint(1 << 30)


def test_vis_train_loader_batches_match_jax(synth):
    """One worker thread (the shared rngs draw in the same order): the first
    4 batches bit for bit, and the steps an epoch."""
    cfg = _cfg(flip_ratio=0.5)
    jl, jsteps = j_build(JDataset(*synth, seed=5), JTransform(cfg, 5), 3,
                         seed=5, num_workers=1)
    loader, steps = build_vis_train_loader(
        YTVOSDataset(*synth, seed=5), VISPairTransform(cfg, 5), 3, seed=5,
        num_workers=1)
    assert steps == jsteps
    try:
        for _ in range(4):
            want, got = next(jl), next(loader)
            _assert_equal_dicts(got, want)
        assert {"images", "ref_images", "gt_pids", "ref_bboxes_jit",
                "ref_labels", "img_shapes", "scale_factors"} <= set(got)
    finally:
        jl.close()
        loader.close()


def test_vis_train_loader_worker_processes_match_jax(synth):
    """num_worker_procs > 0: each sample's transform and reference-frame
    rngs seeded from (seed, step, index), so the batches are the JAX
    package's bit for bit whatever the scheduling."""
    cfg = _cfg(flip_ratio=0.5)
    jl, _ = j_build(JDataset(*synth), JTransform(cfg), 2, seed=6,
                    num_worker_procs=2)
    loader, _ = build_vis_train_loader(YTVOSDataset(*synth),
                                       VISPairTransform(cfg), 2, seed=6,
                                       num_worker_procs=2)
    try:
        for _ in range(2):
            _assert_equal_dicts(next(loader), next(jl))
    finally:
        jl.close()
        loader.close()


def test_synth_ytvis_follows_the_jax_tools_draws(synth, tmp_path):
    """The port's tool draws as the JAX tool does: the same videos, tracks,
    categories and motions (boxes within 2 px: the JAX tool traces cv2's
    ellipse, the port fills its polygon); every annotation's polygon
    rasterises to the mask it was drawn from."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "j_synth_ytvis", os.path.join(os.path.dirname(__file__), "..",
                                      "tools", "synth_ytvis.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    want = json.load(open(jtool.make_dataset(str(tmp_path / "j"), 4, 3, 96,
                                             7, 3)[0]))
    got = json.load(open(make_dataset(str(tmp_path / "p"), 4, 3, 96, 7,
                                      3)[0]))
    assert len(got["annotations"]) == len(want["annotations"])
    for g, w in zip(got["annotations"], want["annotations"]):
        assert (g["video_id"], g["category_id"]) == (w["video_id"],
                                                     w["category_id"])
        for bg, bw in zip(g["bboxes"], w["bboxes"]):
            assert (bg is None) == (bw is None)
            if bg is not None:
                np.testing.assert_allclose(bg, bw, atol=2)
    ds = YTVOSDataset(str(tmp_path / "p" / "ann.json"),
                      str(tmp_path / "p" / "imgs"))
    boxes, _, segs, _ = ds._frame_anns(0, 0)
    for m, a in zip(ds._masks(segs, 96, 96), got["annotations"]):
        assert int(m.sum()) == a["areas"][0]


def test_ytvos_dataset_reads_the_jax_tools_set_as_jax_does(tmp_path):
    """The JAX package's ``tools/synth_ytvis.py`` writes its frames with
    ``cv2.imwrite``; the port's ``YTVOSDataset`` reads every frame of that
    set as the JAX ``YTVOSDataset`` (``cv2.imread``) does, bit for bit."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "j_synth_ytvis", os.path.join(os.path.dirname(__file__), "..",
                                      "tools", "synth_ytvis.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    files = jtool.make_dataset(str(tmp_path / "j"), 3, 3, 72, 5, 2)
    jds, ds = JDataset(*files, True), YTVOSDataset(*files, True)
    n = 0
    for v, video in enumerate(ds.videos):
        for f in range(len(video["file_names"])):
            assert video["file_names"][f].endswith(".jpg")
            np.testing.assert_array_equal(ds.load_frame(v, f),
                                          jds.load_frame(v, f))
            n += 1
    assert n == 9


# ------------------------------------------------------------ evaluation

def _mask(h, w, y0, y1, x0, x1):
    m = np.zeros((h, w), np.uint8)
    m[y0:y1, x0:x1] = 1
    return m


def _ann(tracks, h=20, w=24, frames=3, cats=(1, 2)):
    return dict(videos=[dict(id=1, width=w, height=h,
                             file_names=[str(i) for i in range(frames)])],
                categories=[dict(id=c, name=str(c)) for c in cats],
                annotations=tracks)


def _gt(aid, cat, segs, crowd=0):
    return dict(id=aid, video_id=1, category_id=cat, iscrowd=crowd,
                segmentations=segs,
                areas=[None if s is None else _area(s) for s in segs])


def _area(rle):
    from sipmask_tpu_torch.eval.rle import rle_area
    return rle_area(rle)


def _stats(ann, results):
    ev, jev = YTVOSEvaluator(ann_data=ann), JEvaluator(ann_data=ann)
    ev.update(results)
    jev.update(results)
    return ev.summarize(verbose=False), jev.summarize(verbose=False)


def test_track_iou_matches_jax():
    a = encode_mask(_mask(20, 24, 2, 10, 3, 12))
    b = encode_mask(_mask(20, 24, 4, 12, 5, 16))
    poly = [[5.0, 4.0, 15.0, 4.0, 15.0, 11.0, 5.0, 11.0]]
    for dt, gt, crowd in (([a, None, b], [b, b, None], False),
                          ([a, a], [a, None], False),
                          ([a, b, None], [poly, poly, poly], False),
                          ([a, b, b], [b, None, a], True)):
        assert track_iou(dt, gt, 20, 24, crowd) == pytest.approx(
            j_track_iou(dt, gt, 20, 24, crowd), abs=1e-12)


def test_evaluator_matches_jax():
    """A perfect track (AP 1), a track missing a frame, a crowd gt, a false
    positive, two categories: the same stats as the JAX evaluator."""
    m = [encode_mask(_mask(20, 24, 2 + i, 10 + i, 3, 12)) for i in range(3)]
    n = [encode_mask(_mask(20, 24, 10, 18, 12 + i, 22)) for i in range(3)]
    crowd = [encode_mask(_mask(20, 24, 0, 20, 0, 6))] * 3
    perfect = _ann([_gt(1, 1, m)])
    stats, jstats = _stats(perfect, [dict(video_id=1, category_id=1,
                                          score=0.9, segmentations=m)])
    assert stats == jstats and stats["AP"] == pytest.approx(1.0)
    ann = _ann([_gt(1, 1, m), _gt(2, 2, [n[0], None, n[2]]),
                _gt(3, 2, crowd, crowd=1)])
    results = [dict(video_id=1, category_id=1, score=0.8,
                    segmentations=[m[0], None, m[2]]),
               dict(video_id=1, category_id=2, score=0.7,
                    segmentations=n),
               dict(video_id=1, category_id=2, score=0.6,
                    segmentations=[crowd[0], crowd[1], None]),
               dict(video_id=1, category_id=1, score=0.95,
                    segmentations=[None, n[1], None])]
    stats, jstats = _stats(ann, results)
    assert stats == jstats
    assert 0 < stats["AP"] < 1 and stats["AP50"] > stats["AP75"]


def test_single_frame_videos_match_coco_segm():
    """On one-frame videos the track IoU is the mask IoU: the port's
    YTVOSEvaluator gives the port's COCOEvaluator's segm stats (random
    boxes, scores, crowds, three categories), as tests/test_vis.py holds
    the JAX package's."""
    from sipmask_tpu_torch.eval.coco_eval import COCOEvaluator
    rng = np.random.RandomState(3)
    h = w = 64
    cats = [dict(id=c, name=str(c)) for c in (1, 2, 3)]
    videos, images, v_anns, c_anns, vis_res, coco_res = [], [], [], [], [], []
    for vid in range(1, 7):
        videos.append(dict(id=vid, width=w, height=h, file_names=["f"]))
        images.append(dict(id=vid, width=w, height=h, file_name="f"))
        for cat in (1, 2, 3):
            for kind in ("gt", "dt"):
                for _ in range(rng.randint(0, 3 if kind == "gt" else 4)):
                    y, x = rng.randint(0, h - 12, 2)
                    bh, bw = rng.randint(6, 24, 2)
                    rle = encode_mask(_mask(h, w, y, y + bh, x, x + bw))
                    if kind == "dt":
                        s = float(rng.rand())
                        vis_res.append(dict(video_id=vid, category_id=cat,
                                            score=s, segmentations=[rle]))
                        coco_res.append(dict(image_id=vid, category_id=cat,
                                             score=s, segmentation=rle,
                                             bbox=[0, 0, 1, 1]))
                        continue
                    crowd = int(rng.rand() < 0.2)
                    area = _area(rle)
                    aid = len(v_anns) + 1
                    v_anns.append(dict(id=aid, video_id=vid, category_id=cat,
                                       iscrowd=crowd, areas=[area],
                                       segmentations=[rle]))
                    c_anns.append(dict(id=aid, image_id=vid, category_id=cat,
                                       iscrowd=crowd, area=area,
                                       segmentation=rle,
                                       bbox=[int(x), int(y), int(bw),
                                             int(bh)]))
    ev = YTVOSEvaluator(ann_data=dict(videos=videos, categories=cats,
                                      annotations=v_anns))
    ev.update(vis_res)
    stats = ev.summarize(verbose=False)
    coco = COCOEvaluator(None, iou_type="segm", ann_data=dict(
        images=images, categories=cats, annotations=c_anns))
    coco.update(coco_res)
    cstats = coco.summarize(verbose=False)
    for k in ("AP", "AP50", "AP75", "APs", "APm", "APl"):
        np.testing.assert_allclose(stats[k], cstats[k], atol=1e-9,
                                   err_msg=k)
    jev = JEvaluator(ann_data=dict(videos=videos, categories=cats,
                                   annotations=v_anns))
    jev.update(vis_res)
    assert jev.summarize(verbose=False) == stats
