"""The port's JPEG codec (``sipmask_tpu_torch/native/jpeg.cpp`` through
``data/image_io.py``) against cv2 (libjpeg-turbo), the oracle; PIL writes
the files cv2 does not (CMYK, RGB without a colour transform, EXIF
orientation). Decoding pixel for pixel against ``cv2.imread`` /
``cv2.imdecode``: every sampling cv2 writes, baseline and progressive, with
and without restart intervals and optimised Huffman tables, at qualities
5-100 and sizes 1x1 to 250x333; grey, CMYK, RGB, EXIF orientations 0-9,
stray bytes before markers, files cut short (progressive ones
block-smoothed), and the SOFs the codec refuses. Encoding byte for byte
against ``cv2.imencode``. The fixtures under ``tests/data/jpeg`` and their
digests, recomputed with cv2."""

import hashlib
import io
import json
import os
import shutil
import threading

import cv2
import numpy as np
import pytest
from PIL import Image

from sipmask_tpu_torch import native
from sipmask_tpu_torch.data import image_io
from sipmask_tpu_torch.native import jpeg

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SIZES = ((1, 1), (3, 5), (17, 9), (48, 64), (250, 333))
QUALITIES = (5, 50, 95, 100)
SAMPLINGS = {"444": 0x111111, "422": 0x211111, "420": 0x221111,
             "440": 0x121111, "411": 0x411111}
MODES = {"baseline": {}, "baseline_rst_opt": dict(rst_interval=3, optimize=1),
         "progressive": dict(progressive=1),
         "progressive_rst_opt": dict(progressive=1, rst_interval=2,
                                     optimize=1)}


def _image(h, w, seed=0):
    """A gradient with noise: smooth areas and edges, as photographs have."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 7 + yy * 3) % 256, (xx * 2 + yy * 11 + 40) % 256,
                     ((xx - yy) * 5) % 256], -1)
    return (base + rng.randint(0, 40, (h, w, 3))).clip(0, 255).astype(
        np.uint8)


def _cv2_jpeg(img, **params):
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, "IMWRITE_JPEG_" + k.upper()), v]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def _pil_jpeg(img_bgr, mode=None, **kw):
    im = Image.fromarray(np.ascontiguousarray(img_bgr[..., ::-1]))
    if mode:
        im = im.convert(mode)
    bio = io.BytesIO()
    im.save(bio, "JPEG", **kw)
    return bio.getvalue()


def _assert_reads_as_cv2(tmp_path, data, name="x.jpg"):
    """imread against cv2.imread and imdecode against cv2.imdecode."""
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert want is not None
    np.testing.assert_array_equal(image_io.imread(path), want, err_msg=name)
    np.testing.assert_array_equal(
        image_io.imdecode(data),
        cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
        err_msg=name)
    return want


# ---------------------------------------------------------------- decoder

@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("sampling", list(SAMPLINGS))
def test_decode_matches_cv2(tmp_path, sampling, mode):
    for q in QUALITIES:
        for h, w in SIZES:
            img = _image(h, w, seed=h * w + q)
            data = _cv2_jpeg(img, quality=q,
                             sampling_factor=SAMPLINGS[sampling],
                             **MODES[mode])
            _assert_reads_as_cv2(tmp_path, data, f"{sampling}_{mode}_q{q}_"
                                 f"{h}x{w}.jpg")


@pytest.mark.parametrize("progressive", [0, 1])
def test_decode_grey_matches_cv2(tmp_path, progressive):
    for q in QUALITIES:
        for h, w in SIZES:
            data = _cv2_jpeg(_image(h, w, seed=q)[..., 1], quality=q,
                             progressive=progressive)
            got = _assert_reads_as_cv2(tmp_path, data, f"grey_q{q}_{h}x{w}"
                                       ".jpg")
            assert (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("kind", ["cmyk", "cmyk_progressive", "rgb"])
def test_decode_pil_colour_spaces_matches_cv2(tmp_path, kind):
    """CMYK (Adobe APP14, inverted) through OpenCV's CMYK -> BGR rule, and
    RGB without a colour transform (Adobe transform 0)."""
    for h, w in ((1, 1), (3, 5), (17, 9), (48, 64), (250, 333)):
        img = _image(h, w, seed=w)
        if kind == "rgb":
            datas = [_pil_jpeg(img, quality=90, keep_rgb=True,
                               subsampling=0)]
        else:
            datas = [_pil_jpeg(img, "CMYK", quality=q, subsampling=sub,
                               progressive=kind.endswith("progressive"))
                     for q in (50, 95) for sub in (0, 1, 2)]
        for i, data in enumerate(datas):
            _assert_reads_as_cv2(tmp_path, data, f"{kind}{i}_{h}x{w}.jpg")


@pytest.mark.parametrize("orientation", range(10))
def test_exif_orientation_as_cv2_applies_it(tmp_path, orientation):
    """A 53x37 image tagged with each orientation: 5-8 read transposed,
    0 and 9 (not an orientation) as stored."""
    exif = Image.Exif()
    exif[0x0112] = orientation
    data = _pil_jpeg(_image(53, 37, seed=1), quality=90,
                     exif=exif.tobytes())
    got = _assert_reads_as_cv2(tmp_path, data)
    assert got.shape == ((37, 53, 3) if 5 <= orientation <= 8
                         else (53, 37, 3))


@pytest.mark.parametrize("before", [b"\xff\xdb", b"\xff\xd1", b"\xff\xd9"],
                         ids=["DQT", "RST1", "EOI"])
def test_stray_bytes_before_a_marker_are_skipped(tmp_path, before):
    """libjpeg warns "extraneous bytes before marker" and reads on."""
    data = _cv2_jpeg(_image(40, 56, seed=2), quality=90, rst_interval=2)
    i = data.index(before)
    _assert_reads_as_cv2(tmp_path, data[:i] + b"\x00\x12\x34" + data[i:])


@pytest.mark.parametrize("rst", [0, 2])
def test_a_file_cut_short(tmp_path, rst):
    """``imread`` decodes the rest of the scan as grey, as ``cv2.imread``
    (libjpeg's file source) does; ``imdecode`` raises where
    ``cv2.imdecode`` (a suspending memory source) gives None."""
    data = _cv2_jpeg(_image(48, 64, seed=3), quality=90, rst_interval=rst)
    for cut in (0.3, 0.6, 0.9, 0.99):
        part = data[:int(len(data) * cut)]
        path = str(tmp_path / f"cut{cut}.jpg")
        with open(path, "wb") as f:
            f.write(part)
        np.testing.assert_array_equal(image_io.imread(path),
                                      cv2.imread(path))
        assert cv2.imdecode(np.frombuffer(part, np.uint8), 1) is None
        with pytest.raises(ValueError, match="before its EOI"):
            image_io.imdecode(part)


@pytest.mark.parametrize("rst", [0, 2])
@pytest.mark.parametrize("sampling", ["444", "420", "411"])
def test_a_progressive_file_cut_short_is_smoothed_as_cv2(tmp_path, sampling,
                                                          rst):
    """A progressive file cut anywhere: where ``cv2.imread`` decodes it
    (libjpeg block-smooths the coefficients whose scans are missing, from
    the DC values of the 5x5 blocks around each), ``imread`` gives its
    pixels; where cv2 gives None (a cut inside a table segment), ``imread``
    raises. Out-of-range coefficients decoded from garbage, which cv2's
    16-bit SIMD IDCT wraps, are not held (ROADMAP §3)."""
    for h, w in ((48, 64), (33, 45)):
        data = _cv2_jpeg(_image(h, w, seed=w), quality=70, progressive=1,
                         sampling_factor=SAMPLINGS[sampling],
                         rst_interval=rst)
        for cut in np.linspace(0.05, 0.98, 16):
            part = data[:int(len(data) * cut)]
            path = str(tmp_path / "cut.jpg")
            with open(path, "wb") as f:
                f.write(part)
            want = cv2.imread(path)
            if want is None:
                with pytest.raises(ValueError):
                    image_io.imread(path)
            else:
                np.testing.assert_array_equal(image_io.imread(path), want,
                                              err_msg=f"{h}x{w} cut {cut}")


@pytest.mark.parametrize("patch,sof", [
    ((1, 0xC9), "SOF9"), ((1, 0xCA), "SOF10"), ((1, 0xC3), "SOF3"),
    ((1, 0xCB), "SOF11"), ((1, 0xC5), "SOF5"), ((1, 0xCE), "SOF14"),
    ((4, 12), "12-bit")])
def test_refused_files_name_the_file_and_the_sof(tmp_path, patch, sof):
    """Arithmetic coding, lossless, hierarchical and 12-bit frames raise
    ValueError (deviations from cv2, whose libjpeg-turbo decodes some of
    them), patched from a baseline file's SOF0."""
    data = bytearray(_cv2_jpeg(_image(16, 16), quality=90))
    at = data.index(b"\xff\xc0")
    data[at + patch[0]] = patch[1]
    path = str(tmp_path / "refused.jpg")
    with open(path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match=f"refused.jpg.*{sof}"):
        image_io.imread(path)


def test_other_files_raise():
    with pytest.raises(ValueError, match="JPEG only"):
        image_io.imdecode(b"\x89PNG\r\n\x1a\n")
    with pytest.raises(ValueError, match="no SOI|no image"):
        jpeg.decode(b"\xff\xd8\xff\xd9")


def test_threads_decode_in_parallel_to_the_same_pixels():
    """No state in the codec: eight threads decoding different files at
    once give each file's own pixels."""
    datas = [_cv2_jpeg(_image(64 + 8 * i, 48, seed=i), quality=80 + i,
                       progressive=i % 2) for i in range(8)]
    want = [cv2.imdecode(np.frombuffer(d, np.uint8), 1) for d in datas]
    got = [None] * 8

    def work(i):
        for _ in range(5):
            got[i] = image_io.imdecode(datas[i])
    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- encoder

@pytest.mark.parametrize("quality", [1, 10, 50, 75, 95, 100])
def test_encode_matches_cv2_byte_for_byte(tmp_path, quality):
    """Sizes that are not multiples of 16 (the MCU's right and bottom
    edges, dummy blocks), smooth and noise content."""
    for h, w in ((1, 1), (3, 5), (17, 9), (9, 17), (37, 53), (61, 45),
                 (250, 333)):
        for img in (_image(h, w, seed=quality),
                    np.random.RandomState(h * w).randint(0, 256, (h, w, 3),
                                                         np.uint8)):
            ok, want = cv2.imencode(".jpg", img,
                                    [cv2.IMWRITE_JPEG_QUALITY, quality])
            assert image_io.imencode_jpeg(img, quality) == want.tobytes()
    path = str(tmp_path / "w.jpg")
    image_io.imwrite_jpeg(path, img, quality)
    with open(path, "rb") as f:
        assert f.read() == want.tobytes()


def test_imwrite_jpeg_is_cv2_imwrite_at_its_default_quality(tmp_path):
    img = _image(45, 61, seed=7)
    image_io.imwrite_jpeg(str(tmp_path / "port.jpg"), img)
    cv2.imwrite(str(tmp_path / "cv2.jpg"), img)
    assert (tmp_path / "port.jpg").read_bytes() == \
        (tmp_path / "cv2.jpg").read_bytes()
    with pytest.raises(ValueError, match="uint8 BGR"):
        image_io.imencode_jpeg(img[..., 0])


# ---------------------------------------------------------------- fixtures

def _digests():
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        return json.load(f)


def test_fixtures_cover_the_decoder_and_stay_small():
    names = sorted(_digests()["decoded"])
    assert {"progressive.jpg", "sampling_440.jpg", "sampling_411.jpg",
            "restarts.jpg", "grey.jpg", "cmyk.jpg", "exif6.jpg",
            "stray_bytes.jpg"} <= set(names)
    assert sorted(n for n in os.listdir(FIXTURES)
                  if n.endswith(".jpg")) == names
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) < 64 * 1024


@pytest.mark.parametrize("name", sorted(_digests()["decoded"]))
def test_fixture_digest_is_cv2_imread_and_the_port(name):
    """The recorded digest is that of cv2.imread's pixels (so the JSON
    cannot drift from the oracle), and the port's imread gives it."""
    want = _digests()["decoded"][name]
    path = os.path.join(FIXTURES, name)
    for img in (cv2.imread(path, cv2.IMREAD_COLOR), image_io.imread(path)):
        assert list(img.shape) == want["shape"]
        assert hashlib.sha256(img.tobytes()).hexdigest() == want["sha256"]


def test_encode_digests_are_cv2_imencode_and_the_port():
    for e in _digests()["encoded"]:
        h, w = e["shape"]
        img = np.random.RandomState(e["seed"]).randint(0, 256, (h, w, 3),
                                                       np.uint8)
        ok, buf = cv2.imencode(".jpg", img,
                               [cv2.IMWRITE_JPEG_QUALITY, e["quality"]])
        assert hashlib.sha256(buf.tobytes()).hexdigest() == e["sha256"]
        assert hashlib.sha256(image_io.imencode_jpeg(
            img, e["quality"])).hexdigest() == e["sha256"]


# ---------------------------------------------------------------- build

def test_the_codec_builds_beside_the_mask_codec_and_never_falls_back(
        tmp_path, monkeypatch):
    """``build/native/jpeg-<hash>.so`` (the hash of source and flags), in
    the mask codec's build folder; a failed build and a missing g++
    raise."""
    path = jpeg.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.name == native.library_name(jpeg.SRC)
    assert path.name.startswith("jpeg-")
    src = tmp_path / "jpeg.cpp"
    src.write_text("this is not C++")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(src, tmp_path / "out")
    shutil.copy(jpeg.SRC, src)
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found.*jpeg.cpp"):
        native.build(src, tmp_path / "out")
