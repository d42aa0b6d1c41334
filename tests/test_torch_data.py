"""The port's data pipeline (sipmask_tpu_torch/data) against cv2 and against
the JAX package's, which reads and resizes with cv2: the resizes and the
polygon fill of ``imgops``, the PNG reader, ``CocoDataset``, the train and
test transforms and the loaders' batches, on small images."""

import json
import struct
import zlib

import cv2
import numpy as np
import pytest

from sipmask_tpu.config import _r, get_config
from sipmask_tpu_torch.data import image_io, imgops

RESIZES = [((480, 640), (800, 1067)), ((427, 640), (800, 1199)),
           ((600, 500), (1333, 1111)), ((1000, 1500), (800, 1200)),
           ((480, 640), (544, 544)), ((480, 640), (375, 500)),
           ((300, 300), (640, 480)), ((7, 9), (3, 4)), ((64, 48), (32, 24)),
           ((100, 150), (107, 160))]


def _image(hw, channels, seed=0):
    rng = np.random.RandomState(seed)
    shape = hw + ((channels,) if channels > 1 else ())
    return rng.randint(0, 256, shape).astype(np.uint8)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", RESIZES)
def test_resize_bilinear_u8_matches_cv2_bit_for_bit(src, dst, channels):
    img = _image(src, channels)
    want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
    got = imgops.resize_bilinear_u8(img, *dst)
    assert got.dtype == np.uint8
    assert int((got != want).sum()) == 0


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("src,dst", RESIZES[:6])
def test_resize_nearest_and_float_bilinear_match_cv2(src, dst, channels):
    """Nearest: 0 differing values. Float bilinear: cv2's map to 1e-6 of
    the values' scale (cv2 may fuse its multiply-adds)."""
    x = _image(src, channels).astype(np.float32) / 255
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_NEAREST)
    assert int((imgops.resize_nearest(x, *dst) != want).sum()) == 0
    want = cv2.resize(x, dst[::-1], interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(imgops.resize_bilinear_f32(x, *dst), want,
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("hw,sf", [((400, 672), 800 / 480),
                                   ((400, 672), 800 / 427),
                                   ((64, 80), 1.0), ((60, 80), 0.913)])
def test_resize_bilinear_f32_with_fx_matches_cv2(hw, sf):
    """cv2.resize(m, None, fx, fy): the size round(w * fx) and the map
    from 1 / fx, as the mask paste uses them (fx = 2 / scale factor, a
    float32 and a float64 fx); a stack of masks at once. To 1e-6."""
    m = np.random.RandomState(1).rand(3, *hw).astype(np.float32)
    for fx in (np.float32(2) / np.float32(sf), 2.0 / float(np.float32(sf))):
        want = np.stack([cv2.resize(x, None, fx=fx, fy=fx,
                                    interpolation=cv2.INTER_LINEAR)
                         for x in m])
        got = imgops.resize_bilinear_f32(m, fx=fx, fy=fx, axes=(1, 2))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_downsample2x_mask_matches_cv2_bilinear_then_threshold():
    """The gt masks' 0.5x bilinear + > 0.5 (cv2's INTER_AREA at 2x)."""
    rng = np.random.RandomState(2)
    masks = (rng.rand(6, 64, 96) > rng.rand(6, 1, 1)).astype(np.uint8)
    want = np.stack([cv2.resize(m.astype(np.float32), (48, 32),
                                interpolation=cv2.INTER_LINEAR) > 0.5
                     for m in masks])
    assert int((imgops.downsample2x_mask(masks) != want).sum()) == 0


def _polygons(kind, rng):
    """(polygons as int32 (n, 2) arrays, h, w) of one kind."""
    h, w = rng.randint(8, 90), rng.randint(8, 90)
    size = np.array([w - 1, h - 1])
    lo, hi = [0, 0], [w - 1, h - 1]
    if kind == "convex":
        c = rng.uniform(size * 0.2, size * 0.8)
        r = rng.uniform(2, min(h, w) / 2)
        a = np.sort(rng.uniform(0, 2 * np.pi, rng.randint(3, 12)))
        ps = [c + r * np.stack([np.cos(a), np.sin(a)], 1)]
    elif kind == "nonconvex":
        ps = [rng.uniform(0, 1, (rng.randint(4, 25), 2)) * size]
    elif kind == "multipart":
        ps = [rng.uniform(0, 1, (rng.randint(3, 10), 2)) * size
              for _ in range(rng.randint(2, 5))]
    elif kind == "coco_range":   # COCO's [0, w] x [0, h]: x = w is outside
        ps = [rng.uniform(-0.1, 1.1, (rng.randint(3, 16), 2)) * [w, h]
              for _ in range(rng.randint(1, 3))]
        lo, hi = [0, 0], [w, h]
    else:                        # far outside the image
        ps = [rng.uniform(-0.5, 1.5, (rng.randint(3, 12), 2)) * [w, h]]
        lo, hi = [-10 ** 4] * 2, [10 ** 4] * 2
    return [np.clip(np.round(p), lo, hi).astype(np.int32) for p in ps], h, w


# Pixels of cv2.fillPoly's masks the port does not reproduce, over each
# kind's 200 seeded polygon sets. Inside the image it matches pixel for
# pixel. An edge with an end outside the image is filled from its clipped
# segment, extended back to its first row; a few rows beside two such
# edges that meet outside the image still differ (6 of 200 sets each:
# 56 of 174055 set pixels, and 28 of 190732).
FILL_MISMATCH = {"convex": 0, "nonconvex": 0, "multipart": 0,
                 "coco_range": 56, "outside": 28}


@pytest.mark.parametrize("kind", list(FILL_MISMATCH))
def test_fill_polygons_matches_cv2_fillpoly(kind):
    rng = np.random.RandomState(list(FILL_MISMATCH).index(kind))
    wrong = 0
    for _ in range(200):
        pts, h, w = _polygons(kind, rng)
        want = np.zeros((h, w), np.uint8)
        cv2.fillPoly(want, pts, 1)
        wrong += int((imgops.fill_polygons(pts, h, w) != want).sum())
    assert wrong <= FILL_MISMATCH[kind]


# ------------------------------------------------------------------ PNG

@pytest.mark.parametrize("kind", ["bgr", "grey", "16bit", "alpha"])
def test_imread_reads_cv2_pngs_as_cv2_does(tmp_path, kind):
    """cv2 writes Sub-filtered rows; 16-bit keeps the high byte; alpha is
    dropped; grey becomes three equal channels."""
    img = _image((37, 53), 3, seed=3)
    data = {"bgr": img, "grey": img[..., 0],
            "16bit": img.astype(np.uint16) * 257 + 3,
            "alpha": np.dstack([img, img[..., :1]])}[kind]
    path = str(tmp_path / "x.png")
    cv2.imwrite(path, data)
    np.testing.assert_array_equal(image_io.imread(path),
                                  cv2.imread(path, cv2.IMREAD_COLOR))


def test_png_round_trip_and_pnm(tmp_path):
    img = _image((41, 29), 3, seed=4)
    path = str(tmp_path / "x.png")
    image_io.imwrite_png(path, img)
    np.testing.assert_array_equal(image_io.imread(path), img)
    np.testing.assert_array_equal(cv2.imread(path), img)
    for ext, data in (("ppm", img), ("pgm", img[..., 1])):
        path = str(tmp_path / f"x.{ext}")
        cv2.imwrite(path, data)
        np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))


def _png_filtered(img_rgb, filt):
    """A PNG whose every row carries filter type ``filt`` (3 Average or
    4 Paeth), encoded here byte by byte."""
    h, w, _ = img_rgb.shape
    raw = img_rgb.reshape(h, -1).astype(np.int32)
    out = bytearray()
    prev = np.zeros(raw.shape[1], np.int32)
    for row in raw:
        out.append(filt)
        for i, x in enumerate(row):
            a = row[i - 3] if i >= 3 else 0
            b, c = prev[i], (prev[i - 3] if i >= 3 else 0)
            if filt == 3:
                pred = (a + b) >> 1
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out.append((int(x) - int(pred)) & 255)
        prev = row

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [3, 4], ids=["average", "paeth"])
def test_imread_undoes_average_and_paeth(tmp_path, filt):
    img = _image((9, 13), 3, seed=5)
    path = tmp_path / "x.png"
    path.write_bytes(_png_filtered(img, filt))
    np.testing.assert_array_equal(image_io.imread(str(path)), img[..., ::-1])
    np.testing.assert_array_equal(cv2.imread(str(path)), img[..., ::-1])


def test_imread_refuses_jpeg(tmp_path):
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, _image((16, 16), 3))
    with pytest.raises(ValueError, match="x.jpg.*PNG"):
        image_io.imread(path)


# ------------------------------------------------- dataset and transforms

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A tiny COCO set written by the port's synth tool: landscape and
    portrait PNGs, polygons and RLE."""
    from sipmask_tpu_torch.tools.synth_coco import make_dataset
    out = str(tmp_path_factory.mktemp("synth"))
    ann, img_dir = make_dataset(out, sizes=((160, 120), (150, 100),
                                            (120, 160), (96, 128)),
                                repeat=2, min_objs=3, max_objs=7, seed=1)
    with open(ann) as f:
        data = json.load(f)
    segs = [a["segmentation"] for a in data["annotations"]]
    assert any(isinstance(s, dict) for s in segs)
    assert any(isinstance(s, list) for s in segs)
    return ann, img_dir


def _cfg():
    cfg = get_config("sipmask_r50_fpn_gn_1x")
    return _r(cfg, "data", img_scale=(160, 128), max_gts=8)


def test_coco_dataset_matches_jax(synth):
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu_torch.data.coco import CocoDataset
    for test_mode in (False, True):
        j, p = JDataset(*synth, test_mode), CocoDataset(*synth, test_mode)
        assert len(p) == len(j) == 8
        assert p.label2cat == j.label2cat and p.CLASSES == j.CLASSES
        for i in range(len(j)):
            assert p.aspect_flag(i) == j.aspect_flag(i)
            assert p.image_id(i) == j.image_id(i)
            np.testing.assert_array_equal(p.load_image(i), j.load_image(i))
            np.testing.assert_array_equal(p.recall_gts(i), j.recall_gts(i))
            for a, b in zip(p.get_ann(i), j.get_ann(i)):
                np.testing.assert_array_equal(a, b)


FIELDS = ("image", "gt_bboxes", "gt_labels", "gt_masks", "img_shape",
          "scale_factor")


@pytest.mark.parametrize("flip_ratio", [0.0, 1.0], ids=["noflip", "flip"])
@pytest.mark.parametrize("index", [0, 4], ids=["landscape", "portrait"])
def test_train_transform_matches_jax(synth, flip_ratio, index):
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu.data.transforms import TrainTransform as JTransform
    from sipmask_tpu_torch.data.transforms import TrainTransform
    cfg = _r(_cfg(), "data", flip_ratio=flip_ratio)
    ds = JDataset(*synth)
    img, boxes, labels, masks = ds.load_image(index), *ds.get_ann(index)
    want = JTransform(cfg.data, seed=7)(img, boxes, labels, masks)
    got = TrainTransform(cfg.data, seed=7)(img, boxes, labels, masks)
    assert got.landscape == want.landscape == (index < 4)
    assert got.gt_masks.any()
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("hw", [(120, 160), (100, 150), (160, 120)])
def test_test_transform_matches_jax(hw):
    from sipmask_tpu.data.transforms import TestTransform as JTransform
    from sipmask_tpu_torch.data.transforms import TestTransform
    cfg = _cfg()
    img = _image(hw, 3, seed=8)
    want, got = JTransform(cfg.data)(img), TestTransform(cfg.data)(img)
    for f in ("image", "img_shape", "scale_factor"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_ssd_augs_are_refused():
    from sipmask_tpu_torch.config import get_config as p_get_config
    from sipmask_tpu_torch.data.transforms import TrainTransform
    with pytest.raises(NotImplementedError, match="min_iou_random_crop"):
        TrainTransform(p_get_config("sipmaskpp_r101_fpn_ssd_6x").data)


def test_train_loader_batches_match_jax(synth):
    """The first 3 batches, with one worker (the shared rng draws in the
    same order), bit for bit; steps_per_epoch too."""
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu.data.loader import build_train_loader as j_build
    from sipmask_tpu.data.transforms import TrainTransform as JTransform
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    cfg = _cfg()
    j_loader, j_steps = j_build(JDataset(*synth), JTransform(cfg.data, 3), 2,
                                seed=3, num_workers=1)
    loader, steps = build_train_loader(CocoDataset(*synth),
                                       TrainTransform(cfg.data, 3), 2,
                                       seed=3, num_workers=1)
    assert steps == j_steps == 4
    try:
        for _ in range(3):
            want, got = next(j_loader), next(loader)
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        j_loader.close()
        loader.close()


def test_test_loader_batches_match_jax(synth):
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu.data.loader import build_test_loader as j_build
    from sipmask_tpu.data.transforms import TestTransform as JTransform
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_test_loader
    from sipmask_tpu_torch.data.transforms import TestTransform
    cfg = _cfg()
    want = list(j_build(JDataset(*synth, True), JTransform(cfg.data), 3))
    got = list(build_test_loader(CocoDataset(*synth, True),
                                 TestTransform(cfg.data), 3))
    assert [n for _, n in got] == [n for _, n in want] == [3, 1, 3, 1]
    for (g, _), (w, _) in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_train_loader_worker_processes_match_jax(synth):
    """num_worker_procs > 0: spawned worker processes, each sample's rng
    seeded from (seed, step, index) in both packages, so the batches are
    the JAX package's bit for bit whatever the scheduling."""
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu.data.loader import build_train_loader as j_build
    from sipmask_tpu.data.transforms import TrainTransform as JTransform
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    cfg = _cfg()
    j_loader, _ = j_build(JDataset(*synth), JTransform(cfg.data), 2, seed=5,
                          num_worker_procs=2)
    loader, _ = build_train_loader(CocoDataset(*synth),
                                   TrainTransform(cfg.data), 2, seed=5,
                                   num_worker_procs=2)
    try:
        for _ in range(2):
            want, got = next(j_loader), next(loader)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    finally:
        j_loader.close()
        loader.close()
