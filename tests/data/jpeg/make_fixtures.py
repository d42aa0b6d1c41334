"""Write the JPEG fixtures of this folder and ``digests.json``, with cv2 and
PIL (the oracles; the port reads them without either):

    python tests/data/jpeg/make_fixtures.py

Each fixture is small and covers one path of the decoder: progressive
scans, 4:4:0 and 4:1:1 sampling, restart intervals (sequential and
progressive), grey, CMYK and RGB without a colour transform (PIL), EXIF
orientation 6, stray bytes before a marker, and files cut short (baseline:
the rest grey; progressive: block-smoothed).
``digests.json`` holds the SHA-256 of ``cv2.imread``'s pixels of each file
(with their shape), and of ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])``'s bytes for ``RandomState(seed)`` images
(``ENCODED``). ``tests/test_torch_jpeg.py`` recomputes every digest with
cv2; ``chip_smoke.py`` checks the port's decoder and encoder against them.
"""

import hashlib
import io
import json
import os

import cv2
import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))
# (seed, height, width, quality) of the encoded images
ENCODED = ((0, 37, 53, 95), (1, 61, 45, 75), (2, 40, 70, 50), (3, 17, 9, 10))


def image(h, w, seed):
    """A smooth gradient with noise: JPEG's usual content, not all noise."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 7 + yy * 3) % 256, (xx * 2 + yy * 11 + 40) % 256,
                     ((xx - yy) * 5) % 256], -1)
    return (base + rng.randint(0, 40, (h, w, 3))).clip(0, 255).astype(
        np.uint8)


def encoded_image(seed, h, w):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def cv2_file(img, **params):
    flags = []
    for k, v in params.items():
        flags += [getattr(cv2, "IMWRITE_JPEG_" + k.upper()), v]
    ok, buf = cv2.imencode(".jpg", img, flags)
    assert ok
    return buf.tobytes()


def pil_file(img_bgr, mode=None, **kw):
    im = Image.fromarray(np.ascontiguousarray(img_bgr[..., ::-1]))
    if mode:
        im = im.convert(mode)
    bio = io.BytesIO()
    im.save(bio, "JPEG", **kw)
    return bio.getvalue()


def fixtures():
    stray = cv2_file(image(40, 56, 4), quality=90, rst_interval=2)
    i = stray.index(b"\xff\xdb")
    stray = stray[:i] + b"\x00\x12\x34" + stray[i:]
    i = stray.index(b"\xff\xd1")
    stray = stray[:i] + b"\x56\x78" + stray[i:]
    exif = Image.Exif()
    exif[0x0112] = 6
    cut = cv2_file(image(48, 64, 8), quality=90)
    cut_progressive = cv2_file(image(40, 56, 11), quality=80, progressive=1)
    return {
        "progressive.jpg": cv2_file(image(48, 64, 0), quality=90,
                                    progressive=1, optimize=1),
        "sampling_440.jpg": cv2_file(image(33, 45, 1), quality=85,
                                     sampling_factor=0x121111),
        "sampling_411.jpg": cv2_file(image(37, 53, 2), quality=85,
                                     sampling_factor=0x411111),
        "restarts.jpg": cv2_file(image(40, 56, 3), quality=80,
                                 sampling_factor=0x211111, rst_interval=3),
        "restarts_progressive.jpg": cv2_file(image(40, 56, 5), quality=80,
                                             progressive=1, rst_interval=2),
        "grey.jpg": cv2_file(image(31, 43, 6)[..., 1], quality=90),
        "cmyk.jpg": pil_file(image(32, 40, 7), "CMYK", quality=90),
        "rgb.jpg": pil_file(image(24, 36, 9), quality=90, keep_rgb=True,
                            subsampling=0),
        "exif6.jpg": pil_file(image(53, 37, 10), quality=90,
                              exif=exif.tobytes()),
        "stray_bytes.jpg": stray,
        "cut_short.jpg": cut[:int(len(cut) * 0.7)],
        "cut_short_progressive.jpg": cut_progressive[
            :int(len(cut_progressive) * 0.45)],
    }


def main():
    decoded = {}
    for name, data in fixtures().items():
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        decoded[name] = dict(shape=list(img.shape), sha256=sha(img.tobytes()))
    encoded = [dict(seed=s, shape=[h, w], quality=q,
                    sha256=sha(cv2_file(encoded_image(s, h, w), quality=q)))
               for s, h, w, q in ENCODED]
    with open(os.path.join(HERE, "digests.json"), "w") as f:
        json.dump(dict(decoded=decoded, encoded=encoded), f, indent=1)
        f.write("\n")
    print(f"wrote {len(decoded)} fixtures and {len(encoded)} encode digests "
          f"to {HERE}")


if __name__ == "__main__":
    main()
