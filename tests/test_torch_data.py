"""The port's data pipeline (sipmask_tpu_torch/data) against cv2 and against
the JAX package's, which reads and resizes with cv2: the resizes and the
polygon fill of ``imgops``, the PNG and JPEG readers, ``CocoDataset``, the
train and test transforms and the loaders' batches, on small images."""

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
    elif kind == "outside":      # far outside the image
        ps = [rng.uniform(-0.5, 1.5, (rng.randint(3, 12), 2)) * [w, h]]
        lo, hi = [-10 ** 4] * 2, [10 ** 4] * 2
    else:                        # up to twice the image's size beyond it
        ps = [rng.uniform(-2, 3, (rng.randint(3, 16), 2)) * [w, h]
              for _ in range(rng.randint(1, 4))]
        lo, hi = [-10 ** 4] * 2, [10 ** 4] * 2
    return [np.clip(np.round(p), lo, hi).astype(np.int32) for p in ps], h, w


# Pixels of cv2.fillPoly's masks the port does not reproduce, over each
# kind's 200 seeded polygon sets: none, inside the image and at its border
# (edges clipped to the image, and polygons far outside it, up to twice
# its size beyond each side).
FILL_MISMATCH = {"convex": 0, "nonconvex": 0, "multipart": 0,
                 "coco_range": 0, "outside": 0, "twice_outside": 0}


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


def test_imread_reads_jpeg_as_cv2_does(tmp_path):
    """cv2's JPEG file (quality 95, 4:2:0) reads as ``cv2.imread`` reads it,
    pixel for pixel, and ``imdecode`` of its bytes as ``cv2.imdecode``; a
    format the reader does not take (BMP) raises with the file's name."""
    path = str(tmp_path / "x.jpg")
    cv2.imwrite(path, _image((16, 16), 3))
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path))
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(
        image_io.imdecode(data),
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))
    bmp = str(tmp_path / "x.bmp")
    cv2.imwrite(bmp, _image((16, 16), 3))
    with pytest.raises(ValueError, match="x.bmp.*JPEG.*PNG"):
        image_io.imread(bmp)


# ------------------------------------------------- dataset and transforms

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A tiny COCO set written by the port's synth tool: landscape and
    portrait JPEGs, polygons and RLE."""
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


@pytest.mark.parametrize("seed", [0, 1])
def test_synth_shapes_match_the_jax_tool(tmp_path, seed):
    """``--shapes`` against the JAX package's ``tools/synth_coco.py`` (JPEG
    through cv2) on the same seed: the same images, annotation count and
    categories; annotation boxes within 1 px; slab masks (the corner
    polygon, filled as cv2 fills it) exact; disc masks (cv2's ellipse
    polygon through the polygon fill instead of cv2's convex fill) at a
    mask IoU of 0.98 or more with cv2's. The port's ``CocoDataset`` over
    the JAX tool's own JPEG set gives the JAX ``CocoDataset``'s images bit
    for bit."""
    import importlib.util
    import os
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.tools.synth_coco import make_shapes_dataset
    spec = importlib.util.spec_from_file_location(
        "jax_synth_coco", os.path.join(os.path.dirname(__file__), "..",
                                       "tools", "synth_coco.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    j_files = jax_tool.make_dataset(str(tmp_path / "jax"), seed=seed)
    p_files = make_shapes_dataset(str(tmp_path / "port"), seed=seed)
    anns = []
    for ann_file, _ in (j_files, p_files):
        with open(ann_file) as f:
            anns.append(json.load(f))
    j_ann, p_ann = anns
    assert p_ann["categories"] == j_ann["categories"]
    assert len(p_ann["images"]) == len(j_ann["images"]) == 8
    assert len(p_ann["annotations"]) == len(j_ann["annotations"]) >= 16
    for a, b in zip(p_ann["annotations"], j_ann["annotations"]):
        assert (a["image_id"], a["category_id"]) == (b["image_id"],
                                                     b["category_id"])
        assert np.abs(np.subtract(a["bbox"], b["bbox"])).max() <= 1
        assert isinstance(a["segmentation"], list if a["category_id"] == 2
                          else dict)
    j_ds, p_ds = JDataset(*j_files), CocoDataset(*p_files)
    p_on_j = CocoDataset(*j_files)
    ious = {1: [], 2: []}
    for i in range(8):
        (_, jl, jm), (_, pl, pm) = j_ds.get_ann(i), p_ds.get_ann(i)
        np.testing.assert_array_equal(pl, jl)
        for label, a, b in zip(pl, pm, jm):
            ious[int(label)].append((a & b).sum() / (a | b).sum())
        assert p_ds.load_image(i).shape == (256, 256, 3)
        np.testing.assert_array_equal(p_on_j.load_image(i),
                                      j_ds.load_image(i))
    assert ious[1] and ious[2]
    assert min(ious[2]) == 1.0
    assert min(ious[1]) >= 0.98



@pytest.mark.parametrize("tool,kwargs", [
    ("synth_coco", dict(sizes=((61, 45), (40, 70)), repeat=1, min_objs=2,
                        max_objs=3)),
    ("synth_coco", dict(shapes=True, num_images=2, size=72)),
    ("synth_ytvis", dict(num_videos=2, frames=2, size=56)),
])
def test_synth_files_are_the_files_cv2_writes(tmp_path, monkeypatch, tool,
                                              kwargs):
    """Each image the port's synth tools encode is written as the bytes of
    ``cv2.imencode(".jpg", img)`` for the same array (the JAX tools'
    ``cv2.imwrite``), and cv2 decodes the file to the array it decodes
    from its own encoding; the port reads it as cv2 does."""
    import importlib
    module = importlib.import_module(f"sipmask_tpu_torch.tools.{tool}")
    written = []
    real = module.imwrite_jpeg

    def recording(path, img, quality=95):
        written.append((path, img.copy()))
        real(path, img, quality)
    monkeypatch.setattr(module, "imwrite_jpeg", recording)
    make = (module.make_shapes_dataset if kwargs.pop("shapes", False)
            else module.make_dataset)
    make(str(tmp_path / "set"), seed=3, **kwargs)
    assert len(written) >= 2
    for path, img in written:
        assert path.endswith(".jpg")
        with open(path, "rb") as f:
            data = f.read()
        ok, want = cv2.imencode(".jpg", img)
        assert ok and data == want.tobytes()
        np.testing.assert_array_equal(
            cv2.imread(path),
            cv2.imdecode(want, cv2.IMREAD_COLOR))
        np.testing.assert_array_equal(image_io.imread(path),
                                      cv2.imread(path))


@pytest.mark.parametrize("argv,kwargs", [
    (["--shapes", "--num-images", "2", "--size", "64"],
     dict(shapes=True, num_images=2, size=64)),
    (["--shapes", "--num-images", "2", "--size", "64", "--max-objs", "2"],
     dict(shapes=True, num_images=2, size=64, max_objs=2)),
    (["--sizes", "64x48", "--repeat", "1"],
     dict(sizes=((64, 48),), repeat=1)),
    (["--sizes", "64x48", "--repeat", "1", "--max-objs", "9"],
     dict(sizes=((64, 48),), repeat=1, max_objs=9)),
])
def test_synth_coco_cli_passes_max_objs_only_when_given(tmp_path, argv,
                                                        kwargs):
    """The CLI writes what its mode's function writes with that function's
    own ``max_objs`` default (3 for ``--shapes``, 16 otherwise), and the
    given one when ``--max-objs`` is set."""
    from sipmask_tpu_torch.tools import synth_coco
    make = (synth_coco.make_shapes_dataset if kwargs.pop("shapes", False)
            else synth_coco.make_dataset)
    synth_coco.main([str(tmp_path / "cli")] + argv)
    want_file, _ = make(str(tmp_path / "fn"), seed=0, **kwargs)
    with open(tmp_path / "cli" / "ann.json") as f, open(want_file) as g:
        assert json.load(f) == json.load(g)

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


# ------------------------------------------------- the SSD augmentations

def _rng_states_equal(a, b):
    return all(np.array_equal(x, y) for x, y in zip(a.get_state(),
                                                    b.get_state()))


@pytest.mark.parametrize("w", [1, 7, 131, 640])
def test_bgr_hsv_conversions_match_cv2_bit_for_bit(w):
    """cv2's float BGR<->HSV, vector lanes and each row's scalar tail (w %
    8 pixels): values outside 0..255, grey pixels, saturation over 1, hue
    at 0 and 360. 0 differing values, shown with opencv-python 5.0.0
    (baseline SSE3, dispatch up to AVX512_SKX) on an x86-64 host with
    AVX-512. A cv2 that takes 4 or 16 lanes rounds the tails otherwise, so
    a mismatch on such a host points at the lane width first."""
    from sipmask_tpu_torch.data.imgops import bgr_to_hsv_f32, hsv_to_bgr_f32
    rng = np.random.RandomState(w)
    x = (rng.rand(40, w, 3) * 400 - 60).astype(np.float32)
    x[rng.rand(40, w) < 0.3] = rng.randint(0, 256, 3)
    x[:2] = 7
    want = cv2.cvtColor(x, cv2.COLOR_BGR2HSV)
    np.testing.assert_array_equal(bgr_to_hsv_f32(x), want)
    hsv = want.copy()
    hsv[..., 1] *= np.float32(1.4)
    hsv[rng.rand(40, w) < 0.1, 0] = rng.choice([0, 360])
    np.testing.assert_array_equal(hsv_to_bgr_f32(hsv),
                                  cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


SEEDS = range(60)


def _gts(rng, h, w, n):
    """n random boxes in an (h, w) image, labels, and their box masks."""
    xy = np.sort(rng.randint(0, [w, h, w, h], (n, 4)).reshape(n, 2, 2), 1)
    boxes = xy.reshape(n, 4)[:, [0, 2, 1, 3]].astype(np.float32)
    masks = np.zeros((n, h, w), np.uint8)
    for m, (x1, y1, x2, y2) in zip(masks, boxes.astype(int)):
        m[y1:y2 + 1, x1:x2 + 1] = 1
    return boxes, rng.randint(1, 81, n), masks


def test_photometric_distortion_matches_jax():
    """Over 60 seeds: the same image bit for bit (cv2's HSV reproduced,
    values outside 0..255 kept) and the rng left in the same state."""
    from sipmask_tpu.data.transforms import photometric_distortion as jax_pd
    from sipmask_tpu_torch.data.transforms import photometric_distortion
    img = _image((37, 53), 3, seed=9).astype(np.float32)
    for seed in SEEDS:
        r_j, r_p = np.random.RandomState(seed), np.random.RandomState(seed)
        np.testing.assert_array_equal(photometric_distortion(img, r_p),
                                      jax_pd(img, r_j), err_msg=str(seed))
        assert _rng_states_equal(r_p, r_j), seed


def test_expand_matches_jax():
    """Over 60 seeds: canvas, boxes and masks bit for bit, the rng's state
    equal; about half the seeds expand."""
    from sipmask_tpu.data.transforms import expand as jax_expand
    from sipmask_tpu_torch.data.transforms import expand
    rng = np.random.RandomState(10)
    img = rng.rand(23, 31, 3).astype(np.float32) * 255
    boxes, _, masks = _gts(rng, 23, 31, 3)
    mean = np.array([102.9801, 115.9465, 122.7717], np.float32)
    grown = 0
    for seed in SEEDS:
        r_j, r_p = np.random.RandomState(seed), np.random.RandomState(seed)
        got = expand(img, boxes, masks, r_p, mean)
        want = jax_expand(img, boxes, masks, r_j, mean)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=str(seed))
        assert _rng_states_equal(r_p, r_j), seed
        grown += got[0].shape != img.shape
    assert 15 < grown < 45


def test_min_iou_random_crop_matches_jax():
    """Over 60 seeds: image, boxes, labels and masks bit for bit, the rng's
    state equal; some seeds keep the image, most crop it."""
    from sipmask_tpu.data.transforms import min_iou_random_crop as jax_crop
    from sipmask_tpu_torch.data.transforms import min_iou_random_crop
    rng = np.random.RandomState(11)
    img = rng.rand(60, 80, 3).astype(np.float32)
    boxes, labels, masks = _gts(rng, 60, 80, 5)
    cropped = 0
    for seed in SEEDS:
        r_j, r_p = np.random.RandomState(seed), np.random.RandomState(seed)
        got = min_iou_random_crop(img, boxes, labels, masks, r_p)
        want = jax_crop(img, boxes, labels, masks, r_j)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=str(seed))
        assert _rng_states_equal(r_p, r_j), seed
        cropped += got[0].shape != img.shape
    assert 20 < cropped < 60


def test_min_iou_random_crop_crops_an_image_without_gts():
    """No gts: the image is cropped all the same (only the box and mask
    update is skipped), as in the JAX package, over 60 seeds."""
    from sipmask_tpu.data.transforms import min_iou_random_crop as jax_crop
    from sipmask_tpu_torch.data.transforms import min_iou_random_crop
    img = np.random.RandomState(12).rand(40, 30, 3).astype(np.float32)
    none = (np.zeros((0, 4), np.float32), np.zeros((0,), np.int64),
            np.zeros((0, 40, 30), np.uint8))
    cropped = 0
    for seed in SEEDS:
        r_j, r_p = np.random.RandomState(seed), np.random.RandomState(seed)
        got = min_iou_random_crop(img, *none, r_p)
        want = jax_crop(img, *none, r_j)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=str(seed))
        assert _rng_states_equal(r_p, r_j)
        assert len(got[1]) == 0
        cropped += got[0].shape != img.shape
    assert cropped > 30


# The SSD presets' image after the float resize of an augmented image: cv2
# may fuse the resize's multiply-adds, so values (0..255 less the mean)
# differ in the last bits: at most 6.1e-5 over these samples.
SSD_IMAGE_ATOL = 1e-4


@pytest.mark.parametrize("index", [0, 4], ids=["landscape", "portrait"])
@pytest.mark.parametrize("preset", ["sipmask_r50_fpn_ssd_6x",
                                    "sipmaskpp_r101_fpn_ssd_6x"])
def test_ssd_train_transform_matches_jax(synth, preset, index):
    """The real-time and SipMask++ recipes (photometric distortion,
    expand, min-IoU crop, the 576 stretch, flip 0.5), 6 samples in a row
    from one seed: boxes, labels, masks, img_shape and scale_factor
    exact, the rng's state equal after each sample, the image to
    SSD_IMAGE_ATOL."""
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu.data.transforms import TrainTransform as JTransform
    from sipmask_tpu_torch.data.transforms import TrainTransform
    cfg = _r(get_config(preset), "data", max_gts=8)
    assert cfg.data.ssd_augs and cfg.data.train_size == (576, 576)
    ds = JDataset(*synth)
    img, boxes, labels, masks = ds.load_image(index), *ds.get_ann(index)
    j, p = JTransform(cfg.data, seed=index), TrainTransform(cfg.data,
                                                           seed=index)
    for _ in range(6):
        want = j(img, boxes, labels, masks)
        got = p(img, boxes, labels, masks)
        for f in FIELDS[1:]:
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                          err_msg=f)
        np.testing.assert_allclose(got.image, want.image, rtol=0,
                                   atol=SSD_IMAGE_ATOL)
        assert _rng_states_equal(p.rng, j.rng)
        assert got.gt_masks.any()
    assert got.image.shape == (576, 576, 3)


@pytest.mark.parametrize("preset", ["sipmask_r50_fpn_gn_1x",
                                    "sipmask_r50_fpn_ssd_6x"])
def test_train_loader_batches_match_jax(synth, preset):
    """The first 3 batches, with one worker (the shared rng draws in the
    same order), bit for bit (the real-time preset's augmented images to
    SSD_IMAGE_ATOL); steps_per_epoch too, with the real-time preset's
    repeat_times 3."""
    from sipmask_tpu.data.coco import CocoDataset as JDataset
    from sipmask_tpu.data.loader import build_train_loader as j_build
    from sipmask_tpu.data.transforms import TrainTransform as JTransform
    from sipmask_tpu_torch.data.coco import CocoDataset
    from sipmask_tpu_torch.data.loader import build_train_loader
    from sipmask_tpu_torch.data.transforms import TrainTransform
    cfg = (_cfg() if preset == "sipmask_r50_fpn_gn_1x"
           else _r(get_config(preset), "data", max_gts=8))
    reps = cfg.data.repeat_times
    j_loader, j_steps = j_build(JDataset(*synth), JTransform(cfg.data, 3), 2,
                                seed=3, repeat_times=reps, num_workers=1)
    loader, steps = build_train_loader(CocoDataset(*synth),
                                       TrainTransform(cfg.data, 3), 2,
                                       seed=3, repeat_times=reps,
                                       num_workers=1)
    assert steps == j_steps == 4 * reps
    try:
        for _ in range(3):
            want, got = next(j_loader), next(loader)
            assert sorted(got) == sorted(want)
            for k in want:
                if k == "images" and cfg.data.ssd_augs:
                    np.testing.assert_allclose(got[k], want[k], rtol=0,
                                               atol=SSD_IMAGE_ATOL)
                else:
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
