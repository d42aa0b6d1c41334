"""Image files without cv2 or PIL, as cv2 reads and writes them.

- ``imread(path)`` gives what ``cv2.imread(path, IMREAD_COLOR)`` gives
  (BGR uint8) for JPEG, PNG and binary PPM / PGM files, chosen by the
  file's first bytes; ``imdecode(buf)`` gives ``cv2.imdecode(buf,
  IMREAD_COLOR)``'s image of a JPEG file's bytes. Other formats raise
  ``ValueError``.
- ``imencode_jpeg(img, quality)`` gives the bytes of ``cv2.imencode(".jpg",
  img, [IMWRITE_JPEG_QUALITY, quality])`` (baseline, 4:2:0);
  ``imwrite_jpeg`` writes them. ``imwrite_png`` writes PNG.

JPEG goes through the C++ codec ``native/jpeg.cpp`` (libjpeg-turbo's
arithmetic: the islow IDCT and FDCT, fancy upsampling, its colour tables;
EXIF orientation applied as cv2 applies it; arithmetic-coded, lossless,
hierarchical and 12-bit files raise). PNG rows are unfiltered with numpy:
None and Up at once, Sub as a running sum mod 256 (cv2 writes Sub on every
row), Average and Paeth one row and byte at a time.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from ..native import jpeg

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_JPEG_SIG = b"\xff\xd8\xff"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG colour type -> samples
READS = ("JPEG (baseline and progressive Huffman, 8 bits), PNG (grey or "
         "RGB, with or without alpha, 8 or 16 bits, not interlaced) and "
         "binary PPM / PGM")


def imread(path: str) -> np.ndarray:
    """(h, w, 3) BGR uint8, as ``cv2.imread(path, cv2.IMREAD_COLOR)``:
    grey is repeated into three channels, alpha dropped, 16-bit samples
    keep their high byte; a JPEG file's EXIF orientation is applied, and
    one cut short decodes as libjpeg leaves it (the rest of the scan grey,
    a progressive file's missing coefficients block-smoothed)."""
    with open(path, "rb") as f:
        data = f.read()
    if data.startswith(_JPEG_SIG):
        try:
            return jpeg.decode(data, whole=False)
        except ValueError as e:
            raise ValueError(f"{path}: {e}") from None
    if data.startswith(_PNG_SIG):
        img = _read_png(data, path)
    elif data[:2] in (b"P5", b"P6"):
        img = _read_pnm(data, path)
    else:
        raise ValueError(f"{path}: not a file this reader takes; it reads "
                         f"{READS}")
    if img.shape[2] == 1:
        img = np.repeat(img, 3, 2)
    return np.ascontiguousarray(img[..., ::-1])   # RGB -> BGR


def imdecode(buf) -> np.ndarray:
    """(h, w, 3) BGR uint8 of a JPEG file's bytes (bytes or a uint8
    array), as ``cv2.imdecode(buf, cv2.IMREAD_COLOR)``; data that ends
    before its EOI marker raises, where cv2 gives None."""
    data = (np.frombuffer(buf, np.uint8)
            if isinstance(buf, (bytes, bytearray, memoryview))
            else np.asarray(buf, np.uint8).reshape(-1))
    if data[:3].tobytes() != _JPEG_SIG:
        raise ValueError("imdecode reads JPEG only")
    return jpeg.decode(data)


def imencode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """The JPEG file of an (h, w, 3) BGR uint8 image: the bytes of
    ``cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality])``
    (baseline, 4:2:0, JFIF, the IJG tables scaled by ``quality``)."""
    return jpeg.encode(img, quality)


def imwrite_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write ``imencode_jpeg(img, quality)`` to ``path``, the file
    ``cv2.imwrite(path, img)`` writes at its default quality of 95."""
    data = imencode_jpeg(img, quality)
    with open(path, "wb") as f:
        f.write(data)


def imwrite_png(path: str, img: np.ndarray) -> None:
    """Write an (h, w) grey or (h, w, 3) BGR uint8 image as PNG (filter
    type 0 on every row)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color, rows = 0, img
    elif img.ndim == 3 and img.shape[2] == 3:
        color, rows = 2, img[..., ::-1]
    else:
        raise ValueError(f"imwrite_png takes (h, w) or (h, w, 3) uint8, "
                         f"not {img.shape}")
    h, w = img.shape[:2]
    raw = np.zeros((h, 1 + rows[0].size), np.uint8)
    raw[:, 1:] = rows.reshape(h, -1)

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))
    with open(path, "wb") as f:
        f.write(_PNG_SIG
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0,
                                             0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def _read_png(data: bytes, path: str) -> np.ndarray:
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if interlace or depth not in (8, 16) or color not in _CHANNELS:
        raise ValueError(f"{path}: PNG with bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}; this reader takes "
                         f"{READS}")
    samples = _CHANNELS[color]
    bpp = samples * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    out = _unfilter(raw[:, 0], raw[:, 1:].copy(), bpp)
    if depth == 16:
        out = out[:, 0::2]      # the high byte of each big-endian sample
    img = out.reshape(h, w, samples)
    return img[..., :-1] if color in (4, 6) else img   # alpha dropped


def _unfilter(kinds: np.ndarray, rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo PNG's per-row filters in place (rows: (h, stride) uint8)."""
    h, stride = rows.shape
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        row, kind = rows[y], int(kinds[y])
        if kind == 1:     # Sub: a running sum mod 256 along each byte lane
            row[:] = np.cumsum(row.reshape(-1, bpp), 0,
                               dtype=np.uint8).reshape(-1)
        elif kind == 2:   # Up
            row += prev
        elif kind in (3, 4):
            _unfilter_row(row, prev, bpp, kind)
        elif kind != 0:
            raise ValueError(f"PNG filter type {kind} on row {y}")
        prev = row
    return rows


def _unfilter_row(row, prev, bpp, kind):
    """Average (3) and Paeth (4): each byte needs the one bpp before it,
    reconstructed, so the row goes byte by byte."""
    r = row.astype(np.int32).tolist()
    b = prev.astype(np.int32).tolist()
    for i in range(len(r)):
        a = r[i - bpp] if i >= bpp else 0
        if kind == 3:
            r[i] = (r[i] + ((a + b[i]) >> 1)) & 255
        else:
            c = b[i - bpp] if i >= bpp else 0
            p = a + b[i] - c
            pa, pb, pc = abs(p - a), abs(p - b[i]), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b[i] if pb <= pc else c)
            r[i] = (r[i] + pred) & 255
    row[:] = np.asarray(r, np.uint8)


def _read_pnm(data: bytes, path: str) -> np.ndarray:
    """Binary PGM (P5) / PPM (P6), maxval 255 or 65535."""
    fields, pos = [], 2
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(int(data[pos:end]))
        pos = end
    pos += 1
    w, h, maxval = fields
    c = 3 if data[:2] == b"P6" else 1
    if maxval < 256:
        img = np.frombuffer(data, np.uint8, h * w * c, pos)
    else:
        img = (np.frombuffer(data, ">u2", h * w * c, pos) >> 8
               ).astype(np.uint8)
    return img.reshape(h, w, c)
