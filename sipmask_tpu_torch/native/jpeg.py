"""The JPEG codec (``native/jpeg.cpp``), bound with ``ctypes``: decoding as
``cv2.imdecode(buf, IMREAD_COLOR)`` decodes (BGR uint8, EXIF orientation
applied) and baseline 4:2:0 encoding as ``cv2.imencode(".jpg", img,
[IMWRITE_JPEG_QUALITY, q])`` encodes, byte for byte.

Built like the mask codec (``native/__init__.py``): at first use, with
``g++ -O3 -shared -fPIC -std=c++17``, into ``build/native/jpeg-<hash>.so``
at the root of the checkout. Nothing is built at import; a missing ``g++``
or a failed build raises, and there is no fallback. The C functions hold no
state and take buffers that the caller allocates, and ``ctypes`` releases
the GIL around them, so a loader's threads decode in parallel.

Public API:
  decode(buf) -> (h, w, 3) BGR uint8
  info(buf) -> (height, width, components, orientation)
  encode(img (h, w, 3) BGR uint8, quality=95) -> bytes
  library_path() -> Path of the loaded library
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from . import BUILD_DIR, build

SRC = Path(__file__).resolve().with_name("jpeg.cpp")
# seconds of the build made by this process (None: the library was built)
BUILD_LOG = {"seconds": None}
_ERR_LEN = 512

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_lock = threading.Lock()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    vp, i64, c_int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    sigs = {
        "jpeg_info": (c_int, [vp, i64, vp, ctypes.c_char_p, c_int]),
        "jpeg_decode_bgr": (c_int, [vp, i64, vp, ctypes.c_char_p, c_int]),
        "jpeg_encode_bound": (i64, [c_int, c_int]),
        "jpeg_encode_bgr": (i64, [vp, c_int, c_int, c_int, vp, i64,
                                  ctypes.c_char_p, c_int]),
    }
    for fname, (res, args) in sigs.items():
        fn = getattr(lib, fname)
        fn.restype, fn.argtypes = res, args
    return lib


def load() -> ctypes.CDLL:
    """The loaded codec, built first if needed."""
    global _lib, _lib_path
    with _lock:
        if _lib is None:
            path = build(SRC, BUILD_DIR, BUILD_LOG)
            _lib = _bind(ctypes.CDLL(str(path)))
            _lib_path = path
    return _lib


def library_path() -> Path:
    """Path of the library that ``load`` loaded."""
    load()
    return _lib_path


def _bytes(buf) -> np.ndarray:
    return np.ascontiguousarray(np.frombuffer(buf, np.uint8)
                                if isinstance(buf, (bytes, bytearray,
                                                    memoryview))
                                else np.asarray(buf, np.uint8).reshape(-1))


def info(buf) -> Tuple[int, int, int, int]:
    """(height, width, components, EXIF orientation or 0) from the markers
    before the first scan. Raises ValueError with the codec's message."""
    data = _bytes(buf)
    out = np.zeros(4, np.int32)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if load().jpeg_info(data.ctypes.data, data.size, out.ctypes.data, err,
                        _ERR_LEN) != 0:
        raise ValueError(err.value.decode(errors="replace"))
    return tuple(int(v) for v in out)


def orient(img: np.ndarray, orientation: int) -> np.ndarray:
    """The EXIF orientation applied as ``cv2.imread`` applies it (OpenCV's
    ``ExifTransform``: 2-4 flips, 5-8 a transpose and then a flip; other
    values leave the image as it is)."""
    if orientation >= 5 and orientation <= 8:
        img = img.transpose(1, 0, 2)
    if orientation in (2, 6):
        img = img[:, ::-1]
    elif orientation in (3, 7):
        img = img[::-1, ::-1]
    elif orientation in (4, 8):
        img = img[::-1]
    return np.ascontiguousarray(img)


def decode(buf, whole: bool = True) -> np.ndarray:
    """The (h, w, 3) BGR uint8 image of a JPEG file's bytes, as
    ``cv2.imdecode(buf, IMREAD_COLOR)``. Raises ValueError with the codec's
    message for a file it does not decode, and, when ``whole``, for data
    that ends before its EOI marker (``cv2.imdecode`` gives None there;
    ``cv2.imread`` decodes the rest of the scan as zeros, as ``whole=False``
    does)."""
    data = _bytes(buf)
    h, w, _, orientation = info(data)
    img = np.empty((h, w, 3), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    rc = load().jpeg_decode_bgr(data.ctypes.data, data.size,
                                img.ctypes.data, err, _ERR_LEN)
    if rc < 0:
        raise ValueError(err.value.decode(errors="replace"))
    if rc == 1 and whole:
        raise ValueError("the data ends before its EOI marker")
    return orient(img, orientation)


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """The baseline JPEG file of an (h, w, 3) BGR uint8 image: 4:2:0,
    ``quality`` 1-100, the bytes ``cv2.imencode(".jpg", img,
    [cv2.IMWRITE_JPEG_QUALITY, quality])`` gives."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"JPEG encoding takes (h, w, 3) uint8 BGR, not "
                         f"{img.dtype} {img.shape}")
    img = np.ascontiguousarray(img)
    h, w = img.shape[:2]
    lib = load()
    cap = lib.jpeg_encode_bound(h, w)
    out = np.empty(cap, np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    n = lib.jpeg_encode_bgr(img.ctypes.data, h, w, int(quality),
                            out.ctypes.data, cap, err, _ERR_LEN)
    if n < 0:
        raise ValueError(err.value.decode(errors="replace"))
    return out[:n].tobytes()
