"""The port's COCO evaluation (sipmask_tpu_torch/eval) and its mask paste
against the JAX package's and cv2: the RLE codec, ``postprocess_batch``
at scale factors != 1, ``paste_masks`` and ``COCOEvaluator``'s stats."""

import json

import cv2
import numpy as np
import pytest
import torch

from sipmask_tpu_torch.eval import rle


def _masks(n, h, w, seed):
    """Blobby {0, 1} masks: thresholded smooth noise."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, h // 8 + 2, w // 8 + 2).astype(np.float32)
    up = np.stack([cv2.resize(m, (w, h)) for m in x])
    return (up > 0.55).astype(np.uint8)


def test_rle_codec_matches_jax():
    from sipmask_tpu.eval import rle as j_rle
    masks = np.concatenate([_masks(5, 37, 53, 0),
                            np.zeros((1, 37, 53), np.uint8),
                            np.ones((1, 37, 53), np.uint8)])
    for m in masks:
        got, want = rle.encode_mask(m), j_rle.encode_mask(m)
        assert got == want
        np.testing.assert_array_equal(rle.decode_mask(got), m)
        assert rle.rle_area(got) == j_rle.rle_area(want) == int(m.sum())


@pytest.mark.parametrize("sf", [800 / 480, 800 / 427, 1.0],
                         ids=["640x480", "640x427", "test_scale"])
def test_paste_masks_is_cv2_resize_by_fx(sf):
    """paste_masks (torch) against cv2.resize(m, None, fx=2/sf, fy=2/sf)
    then crop and > 0.4, as the JAX package pastes, on sharp random
    probabilities: a pixel may differ only where cv2's probability lies
    within 1e-6 of the threshold (cv2 may fuse its multiply-adds).
    Resampling by out/in size instead of 1/fx, as ``F.interpolate(size=)``
    does, moves the probabilities by up to ~0.3."""
    from sipmask_tpu_torch.apis.inference import paste_masks
    masks = np.random.RandomState(2).rand(4, 400, 672).astype(np.float32)
    scale = np.full(4, sf, np.float32)
    oh, ow = (480, 640) if sf == 800 / 480 else (
        (427, 640) if sf == 800 / 427 else (800, 1333))
    got = paste_masks(torch.from_numpy(masks), scale, (oh, ow), 0.4).numpy()
    fx = np.float32(2) / scale[0]
    prob = np.full(got.shape, -1.0, np.float32)
    for d, m in enumerate(masks):
        up = cv2.resize(m, None, fx=fx, fy=fx,
                        interpolation=cv2.INTER_LINEAR)
        hh, ww = min(oh, up.shape[0]), min(ow, up.shape[1])
        prob[d, :hh, :ww] = up[:hh, :ww]
    diff = got != (prob > 0.4)
    assert diff.mean() < 1e-5
    assert (np.abs(prob[diff] - 0.4) <= 1e-6).all()


@pytest.mark.parametrize("hw", [(480, 640), (427, 640), (640, 480),
                                (375, 500)],
                         ids=["480x640", "427x640", "640x480", "375x500"])
@pytest.mark.parametrize("preset", ["sipmask_r50_fpn_ssd_6x",
                                    "sipmaskpp_r101_fpn_ssd_6x"])
def test_fixed_size_preprocess_and_paste_match_jax(preset, hw):
    """The real-time and SipMask++ presets stretch to 544x544 (sx != sy):
    ``preprocess`` equals the JAX package's ``TestTransform`` exactly
    (canvas, img_shape, scale_factor), and ``paste_masks`` of 272x272
    stride-2 masks equals cv2.resize(m, None, fx=2/sx, fy=2/sy) cropped
    and > mask_thr, as the JAX package pastes, except where cv2's
    probability lies within 1e-6 of the threshold."""
    from sipmask_tpu.config import get_config as j_get_config
    from sipmask_tpu.data.transforms import TestTransform
    from sipmask_tpu_torch.apis.inference import paste_masks, preprocess
    from sipmask_tpu_torch.config import get_config
    cfg = get_config(preset)
    assert cfg.data.fixed_size == (544, 544)
    img = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.uint8)
    want = TestTransform(j_get_config(preset).data)(img)
    padded, img_shape, scale = preprocess(img, cfg)
    assert padded.shape == want.image.shape == (544, 544, 3)
    np.testing.assert_array_equal(padded, want.image)
    np.testing.assert_array_equal(img_shape, want.img_shape)
    np.testing.assert_array_equal(scale, want.scale_factor)
    assert scale[0] != scale[1]
    thr = cfg.model.test.mask_thr
    masks = np.random.RandomState(3).rand(3, 272, 272).astype(np.float32)
    got = paste_masks(torch.from_numpy(masks), scale, hw, thr).numpy()
    prob = np.full(got.shape, -1.0, np.float32)
    for d, m in enumerate(masks):
        up = cv2.resize(m, None, fx=2.0 / want.scale_factor[0],
                        fy=2.0 / want.scale_factor[1],
                        interpolation=cv2.INTER_LINEAR)
        hh, ww = min(hw[0], up.shape[0]), min(hw[1], up.shape[1])
        prob[d, :hh, :ww] = up[:hh, :ww]
    diff = got != (prob > thr)
    assert diff.mean() < 1e-5
    assert (np.abs(prob[diff] - thr) <= 1e-6).all()


def _dets(b=2, d=6, hm=64, wm=80, seed=0):
    rng = np.random.RandomState(seed)
    boxes = np.sort(rng.uniform(0, 150, (b, d, 4)).astype(np.float32)
                    .reshape(b, d, 2, 2), 2).transpose(0, 1, 3, 2)
    return dict(
        boxes=boxes.reshape(b, d, 4),
        scores=rng.rand(b, d).astype(np.float32),
        labels=rng.randint(0, 80, (b, d)).astype(np.int32),
        valid=rng.rand(b, d) > 0.3,
        masks=np.stack([_masks(d, hm, wm, seed + i).astype(np.float32)
                        * 0.5 + rng.rand(d, hm, wm).astype(np.float32) * 0.3
                        for i in range(b)]),
        mask_scores=rng.rand(b, d).astype(np.float32),
        scale_factors=np.array([[1.0667] * 4, [0.913] * 4], np.float32))


def test_postprocess_batch_matches_jax_at_scale_factors_other_than_1():
    """Same dets into both, as numpy and (the port) as tensors, as
    ``decode_batch`` gives them: identical results, RLEs included, or at
    most 0.1% of a mask's pixels apart (the device paste's and cv2's float
    rounding at the 0.4 threshold); the host path (numpy resize, numpy
    codec) likewise; the masks copied to the host once, as bool."""
    from sipmask_tpu.eval.results import postprocess_batch as j_post
    from sipmask_tpu.eval.rle import decode_mask
    from sipmask_tpu_torch.eval.results import (postprocess_batch,
                                                postprocess_batch_plain)
    dets = _dets()
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in dets.items() if k != "scale_factors"}
    tensors["scale_factors"] = dets["scale_factors"]
    label2cat = {i + 1: 100 + i for i in range(80)}
    ori = np.array([[120, 150], [140, 175]])
    for n_valid in (2, 1):
        want = j_post(dets, [7, 9], ori, label2cat, 0.4, n_valid)
        timings = {}
        got = postprocess_batch(tensors, [7, 9], ori, label2cat, 0.4,
                                n_valid, timings=timings)
        assert got == postprocess_batch(dets, [7, 9], ori, label2cat, 0.4,
                                        n_valid)
        n_px = sum(int(dets["valid"][i].sum()) * ori[i].prod()
                   for i in range(n_valid))
        assert timings["copied_mb"] == [n_px / 2 ** 20]
        assert len(timings["paste"]) == len(timings["encode"]) == 1
        host = postprocess_batch_plain(dets, [7, 9], ori, label2cat, 0.4,
                                       n_valid)
        assert len(got) == len(want) == len(host) > 0
        for g, w, h in zip(got, want, host):
            gs, ws, hs = (r.pop("segmentation") for r in (g, w, h))
            assert g == w == h
            for other in (ws, hs):
                if gs != other:
                    diff = decode_mask(gs) != decode_mask(other)
                    assert diff.mean() <= 1e-3


def _coco_case(tmp_path, seed=0):
    """A COCO set with 4 images and results that hit, miss and duplicate
    its gts: polygons, RLE and a crowd gt."""
    rng = np.random.RandomState(seed)
    images, anns, results = [], [], []
    for i in range(4):
        h, w = 60 + 10 * i, 80
        images.append(dict(id=i + 1, width=w, height=h, file_name=f"{i}.png"))
        for k in range(5):
            x, y = rng.randint(0, w - 20), rng.randint(0, h - 20)
            bw, bh = rng.randint(5, 20), rng.randint(5, 20)
            poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
            m = np.zeros((h, w), np.uint8)
            m[y:y + bh + 1, x:x + bw + 1] = 1
            seg = [poly] if k % 2 else {
                "size": [h, w],
                "counts": rle.encode_mask(m)["counts"].decode()}
            cat = 1 + k % 3
            anns.append(dict(id=len(anns) + 1, image_id=i + 1,
                             category_id=cat, bbox=[x, y, bw, bh],
                             area=float(bw * bh), iscrowd=int(k == 4),
                             segmentation=seg))
            for _ in range(rng.randint(0, 3)):
                dx, dy = rng.randint(-3, 4, 2)
                mm = np.roll(np.roll(m, dy, 0), dx, 1)
                results.append(dict(
                    image_id=i + 1, category_id=cat,
                    bbox=[float(x + dx), float(y + dy), float(bw), float(bh)],
                    score=float(rng.rand()), segmentation=rle.encode_mask(mm)))
        for _ in range(3):   # false positives
            mm = _masks(1, h, w, int(rng.randint(1000)))[0]
            results.append(dict(
                image_id=i + 1, category_id=int(rng.randint(1, 4)),
                bbox=list(map(float, rng.uniform(0, 40, 4))),
                score=float(rng.rand()), segmentation=rle.encode_mask(mm)))
    ann_file = tmp_path / "ann.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=c, name=str(c)) for c in (1, 2, 3)])))
    return str(ann_file), results


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
def test_coco_evaluator_matches_jax(tmp_path, iou_type):
    from sipmask_tpu.eval.coco_eval import COCOEvaluator as JEvaluator
    from sipmask_tpu_torch.eval.coco_eval import COCOEvaluator
    ann_file, results = _coco_case(tmp_path)
    j, p = JEvaluator(ann_file, iou_type), COCOEvaluator(ann_file, iou_type)
    j.update(results)
    p.update(results)
    want, got = j.summarize(verbose=False), p.summarize(verbose=False)
    assert got.keys() == want.keys()
    assert 0 < got["AP"] < 1
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-12, k


def test_recall_matches_jax():
    """``eval_recalls`` on random scenes (some images without gts or
    proposals) equals the JAX package's."""
    from sipmask_tpu.eval.recall import eval_recalls as j_eval_recalls
    from sipmask_tpu_torch.eval.recall import eval_recalls
    rng = np.random.RandomState(0)
    gts, props = [], []
    for i in range(6):
        n_g, n_p = rng.randint(0, 8) if i else 0, rng.randint(0, 400)
        xy = rng.uniform(0, 200, (n_g, 2))
        gts.append(np.concatenate([xy, xy + rng.uniform(5, 60, (n_g, 2))],
                                  1).astype(np.float32))
        pxy = rng.uniform(0, 200, (n_p, 2))
        p = np.concatenate([pxy, pxy + rng.uniform(5, 60, (n_p, 2))], 1)
        near = gts[-1][rng.randint(0, n_g, 20 * n_g)] if n_g else p[:0]
        p = np.concatenate([p, near + rng.normal(0, 4, near.shape)])
        props.append(np.concatenate([p, rng.rand(len(p), 1)],
                                    1).astype(np.float32))
    nums, thrs = (10, 100, 300), np.arange(0.5, 0.96, 0.05)
    got = eval_recalls(gts, props, nums, thrs, verbose=False)
    want = j_eval_recalls(gts, props, nums, thrs, verbose=False)
    np.testing.assert_array_equal(got, want)
    assert got[-1, 0] > got[0, 0] > 0 and got[-1, -1] < got[-1, 0]


def test_evaluate_coco_with_proposal_fast_matches_jax(tmp_path):
    """``evaluate_coco(..., ("bbox", "segm", "proposal_fast"))`` gives the
    JAX package's stats: COCOeval's through the codec, and AR@100/300/1000
    (each the mean over IoU 0.5:0.95) from ``fast_eval_recall`` on the
    port's ``CocoDataset``, with and without a dataset given."""
    from sipmask_tpu.apis.test import evaluate_coco as j_evaluate_coco
    from sipmask_tpu_torch.apis.test import evaluate_coco
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.eval.recall import fast_eval_recall
    ann_file, results = _coco_case(tmp_path)
    for r in results:
        r["det_score"] = r["score"] * 0.9
    metrics = ("bbox", "segm", "proposal_fast")
    want = j_evaluate_coco(results, ann_file, metrics)
    got = evaluate_coco(results, ann_file, metrics)
    assert got == want
    assert set(got["proposal_fast"]) == {"AR@100", "AR@300", "AR@1000"}
    assert 0 < got["proposal_fast"]["AR@100"] < 1
    ds = CocoDataset(ann_file, "", test_mode=True)
    assert evaluate_coco(results, ann_file, ("proposal_fast",),
                         dataset=ds) == {"proposal_fast":
                                         want["proposal_fast"]}
    ar = fast_eval_recall(results, ds, verbose=False)
    assert float(ar[0].mean()) == want["proposal_fast"]["AR@100"]
