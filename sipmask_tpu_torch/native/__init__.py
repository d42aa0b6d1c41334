"""The C++ mask codec of the evaluation path (``native/maskops.cpp``):
COCO's compressed RLE and run-space mask geometry, bound with ``ctypes``.
The JPEG codec (``native/jpeg.cpp``, bound in ``native/jpeg.py``) is built
by the same helpers.

At first use ``maskops.cpp`` is compiled with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/native/maskops-<hash>.so`` at the root of the
checkout (``jpeg.cpp`` into ``build/native/jpeg-<hash>.so``), where the
hash covers the source and the flags; a changed source builds anew under
another name. Nothing is built when the module is imported, and nothing
falls back: a missing ``g++`` or a failed build raises. The plain numpy versions (``eval/rle.py``, the ``*_plain``
functions of ``eval/maskops.py``) give the same bytes and numbers; the
tests hold the codec against them.

Public API (numpy in and out):
  available() -> bool
  encode_mask(mask (h, w)) -> {'size': [h, w], 'counts': bytes}
  encode_masks(masks (n, h, w)) -> list of RLE dicts, in one C call
  encode_masks_t(masks_t (n, w, h)) -> the same from the masks' transposes
  decode_mask(rle) -> (h, w) uint8
  rle_area(rle) -> int
  inter_matrix(dt_rles, gt_rles) -> (n_dt, n_gt) float64 intersections
  iou_matrix(dt_rles, gt_rles, iscrowd) -> (n_dt, n_gt) float64 IoUs
  greedy_match(ious, thrs, gt_ig, iscrowd) -> (dtm, dt_ig)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().with_name("maskops.cpp")
BUILD_DIR = SRC.parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_lib_path: Optional[Path] = None
_lock = threading.Lock()
# seconds of the build made by this process (None: the library was built)
BUILD_LOG = {"seconds": None}


def find_cxx(src: Path = SRC) -> str:
    """Path of ``g++`` on PATH. Raises RuntimeError when there is none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError(
            f"g++ not found on PATH: sipmask_tpu_torch compiles "
            f"sipmask_tpu_torch/native/{Path(src).name} at first use")
    return found


def library_name(src: Path = SRC) -> str:
    """``<stem>-<hash>.so`` (``maskops-<hash>.so`` for the mask codec): the
    hash covers the source and the flags."""
    digest = hashlib.sha1(Path(src).read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return f"{Path(src).stem}-{digest}.so"


def build(src: Path = SRC, out_dir: Path = BUILD_DIR,
          log: Optional[dict] = None) -> Path:
    """Compile ``src`` into ``out_dir/<stem>-<hash>.so`` unless it is there,
    and return its path; the seconds of a build made here go into
    ``log["seconds"]`` (``BUILD_LOG`` by default). The build goes into a
    temporary file that is then renamed, so that a concurrent process never
    loads a half-written library."""
    out = Path(out_dir) / library_name(src)
    if out.exists():
        return out
    cxx = find_cxx(src)
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        t0 = time.perf_counter()
        res = subprocess.run([cxx, *CXX_FLAGS, str(src), "-o", tmp],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed to build {src} "
                               f"(exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
        (BUILD_LOG if log is None else log)["seconds"] = \
            time.perf_counter() - t0
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    dp = ctypes.POINTER(ctypes.c_double)
    c_int, vp = ctypes.c_int, ctypes.c_void_p
    sigs = {
        "runs_from_mask": (c_int, [u8p, c_int, c_int, u32p, c_int]),
        "mask_from_runs": (c_int, [u32p, c_int, c_int, c_int, u8p]),
        "string_from_runs": (c_int, [u32p, c_int, vp, c_int]),
        "runs_from_string": (c_int, [ctypes.c_char_p, c_int, u32p, c_int]),
        "encode_mask": (c_int, [u8p, c_int, c_int, vp, c_int]),
        "encode_masks": (c_int, [u8p, c_int, c_int, c_int, vp,
                                 ctypes.c_int64, i64p]),
        "encode_masks_cm": (c_int, [u8p, c_int, c_int, c_int, vp,
                                    ctypes.c_int64, i64p]),
        "area_from_runs": (ctypes.c_int64, [u32p, c_int]),
        "rle_iou_matrix": (None, [u32p, i64p, c_int, u32p, i64p, c_int, u8p,
                                  dp]),
        "rle_inter_matrix": (None, [u32p, i64p, c_int, u32p, i64p, c_int,
                                    dp]),
        "greedy_match": (None, [dp, c_int, c_int, dp, c_int, u8p, u8p, i32p,
                                u8p]),
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
            path = build()
            _lib = _bind(ctypes.CDLL(str(path)))
            _lib_path = path
    return _lib


def library_path() -> Path:
    """Path of the library that ``load`` loaded."""
    load()
    return _lib_path


def available() -> bool:
    """True when the codec builds and loads."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _encode(fn, masks: np.ndarray, h: int, w: int) -> List[dict]:
    masks = np.asarray(masks)
    if masks.dtype == np.bool_:
        masks = masks.view(np.uint8)
    masks = np.ascontiguousarray(masks, np.uint8)
    n = masks.shape[0]
    if n == 0:
        return []
    cap = n * (2 * h * w + 16)
    buf = np.empty(cap, np.uint8)
    offs = np.zeros(n + 1, np.int64)
    if fn(_ptr(masks, ctypes.c_uint8), n, h, w, buf.ctypes.data, cap,
          _ptr(offs, ctypes.c_int64)) != 0:
        raise RuntimeError("encode_masks: the counts buffer overflowed")
    return [{"size": [h, w], "counts": buf[offs[i]:offs[i + 1]].tobytes()}
            for i in range(n)]


def encode_masks(masks: np.ndarray) -> List[dict]:
    """(n, h, w) {0, 1} masks (uint8 or bool, row-major) -> n RLE dicts,
    encoded in one call."""
    n, h, w = np.shape(masks)
    return _encode(load().encode_masks, masks, h, w)


def encode_masks_t(masks_t: np.ndarray) -> List[dict]:
    """(n, w, h) transposes of (h, w) {0, 1} masks (uint8 or bool) -> the
    n RLE dicts of the (h, w) masks, in one call: the bytes are read in
    order (COCO's runs are column-major), eight at a time, several times
    faster than the row-major ``encode_masks`` on masks that are mostly
    one value."""
    n, w, h = np.shape(masks_t)
    return _encode(load().encode_masks_cm, masks_t, h, w)


def encode_mask(mask: np.ndarray) -> dict:
    """(h, w) {0, 1} mask -> {'size': [h, w], 'counts': bytes}."""
    return encode_masks(np.asarray(mask)[None])[0]


def _runs_of(rle: dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = counts.encode()
    if isinstance(counts, bytes):
        cap = len(counts) + 8
        runs = np.empty(cap, np.uint32)
        n = load().runs_from_string(counts, len(counts),
                                    _ptr(runs, ctypes.c_uint32), cap)
        if n < 0:
            raise RuntimeError("runs_from_string: the runs buffer overflowed")
        return runs[:n]
    return np.ascontiguousarray(counts, np.uint32)


def decode_mask(rle: dict) -> np.ndarray:
    """RLE (counts as bytes, str or a list of runs) -> (h, w) uint8."""
    h, w = rle["size"]
    runs = _runs_of(rle)
    mask = np.zeros((h, w), np.uint8)
    load().mask_from_runs(_ptr(runs, ctypes.c_uint32), len(runs), h, w,
                          _ptr(mask, ctypes.c_uint8))
    return mask


def rle_area(rle: dict) -> int:
    runs = _runs_of(rle)
    return int(load().area_from_runs(_ptr(runs, ctypes.c_uint32), len(runs)))


def _pack_runs(rles):
    runs = [_runs_of(r) for r in rles]
    cat = np.ascontiguousarray(np.concatenate(runs), np.uint32)
    offs = np.zeros(len(runs) + 1, np.int64)
    np.cumsum([len(r) for r in runs], out=offs[1:])
    return cat, offs


def inter_matrix(dt_rles: Sequence[dict], gt_rles: Sequence[dict]
                 ) -> np.ndarray:
    """Raw intersection areas (n_dt, n_gt), float64, in run space. An
    empty or absent mask is the single zero-run RLE."""
    n_dt, n_gt = len(dt_rles), len(gt_rles)
    out = np.zeros((n_dt, n_gt), np.float64)
    if n_dt == 0 or n_gt == 0:
        return out
    dcat, doffs = _pack_runs(dt_rles)
    gcat, goffs = _pack_runs(gt_rles)
    load().rle_inter_matrix(
        _ptr(dcat, ctypes.c_uint32), _ptr(doffs, ctypes.c_int64), n_dt,
        _ptr(gcat, ctypes.c_uint32), _ptr(goffs, ctypes.c_int64), n_gt,
        _ptr(out, ctypes.c_double))
    return out


def iou_matrix(dt_rles: Sequence[dict], gt_rles: Sequence[dict],
               iscrowd=None) -> np.ndarray:
    """(n_dt, n_gt) IoU in run space (pycocotools rleIou); a crowd gt
    gives inter / area_dt."""
    n_dt, n_gt = len(dt_rles), len(gt_rles)
    out = np.zeros((n_dt, n_gt), np.float64)
    if n_dt == 0 or n_gt == 0:
        return out
    dcat, doffs = _pack_runs(dt_rles)
    gcat, goffs = _pack_runs(gt_rles)
    crowd = (np.zeros(n_gt, np.uint8) if iscrowd is None
             else np.ascontiguousarray(np.asarray(iscrowd), np.uint8))
    load().rle_iou_matrix(
        _ptr(dcat, ctypes.c_uint32), _ptr(doffs, ctypes.c_int64), n_dt,
        _ptr(gcat, ctypes.c_uint32), _ptr(goffs, ctypes.c_int64), n_gt,
        _ptr(crowd, ctypes.c_uint8), _ptr(out, ctypes.c_double))
    return out


def greedy_match(ious: np.ndarray, thrs: np.ndarray, gt_ig: np.ndarray,
                 iscrowd: np.ndarray):
    """COCOeval's greedy matching over IoU thresholds (pycocotools
    evaluateImg's inner loop). ious (n_dt, n_gt) with the gt columns sorted
    ignore-last. Returns (dtm int32 (T, D), 1-based gt index or 0;
    dt_ig uint8 (T, D))."""
    n_dt, n_gt = ious.shape
    n_thr = len(thrs)
    dtm = np.zeros((n_thr, n_dt), np.int32)
    dt_ig = np.zeros((n_thr, n_dt), np.uint8)
    if n_dt == 0 or n_gt == 0:
        return dtm, dt_ig
    ious = np.ascontiguousarray(ious, np.float64)
    thrs = np.ascontiguousarray(thrs, np.float64)
    gt_ig = np.ascontiguousarray(gt_ig, np.uint8)
    iscrowd = np.ascontiguousarray(iscrowd, np.uint8)
    load().greedy_match(
        _ptr(ious, ctypes.c_double), n_dt, n_gt, _ptr(thrs, ctypes.c_double),
        n_thr, _ptr(gt_ig, ctypes.c_uint8), _ptr(iscrowd, ctypes.c_uint8),
        _ptr(dtm, ctypes.c_int32), _ptr(dt_ig, ctypes.c_uint8))
    return dtm, dt_ig
