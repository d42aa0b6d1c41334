"""COCO run-length-encoding codec (pycocotools maskApi.c equivalent), the
port of ``sipmask_tpu/eval/rle.py``: numpy, byte-identical compressed
strings (rleToString/rleFrString, column-major runs starting with a
zero-run). The plain version of the C++ codec (``sipmask_tpu_torch.native``,
which the evaluation path calls through ``eval/maskops.py``): the tests and
``chip_smoke.py`` hold the codec against it. The data loader decodes gt
RLEs with its ``decode_mask``."""

from __future__ import annotations

import numpy as np


def _runs(flat: np.ndarray) -> np.ndarray:
    """Column-major-flattened mask -> run lengths starting with a 0-run."""
    if len(flat) == 0:
        return np.zeros((0,), np.int64)
    change = np.nonzero(flat[1:] != flat[:-1])[0] + 1
    bounds = np.concatenate([[0], change, [len(flat)]])
    runs = np.diff(bounds)
    if flat[0] == 1:
        runs = np.concatenate([[0], runs])
    return runs.astype(np.int64)


def encode_counts(runs) -> bytes:
    """maskApi.c rleToString: 5-bit varint with 3-back delta."""
    s = bytearray()
    runs = list(map(int, runs))
    for i, x in enumerate(runs):
        if i > 2:
            x -= runs[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            s.append(c + 48)
    return bytes(s)


def decode_counts(counts) -> np.ndarray:
    """Inverse of encode_counts -> run lengths array."""
    if isinstance(counts, str):
        counts = counts.encode()
    vals, i = [], 0
    while i < len(counts):
        x, k, more = 0, 0, True
        while more:
            c = counts[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(vals) > 2:
            x += vals[-2]
        vals.append(x)
    return np.asarray(vals, np.int64)


def encode_mask(mask: np.ndarray) -> dict:
    """(h, w) {0,1} mask -> {'size': [h, w], 'counts': bytes}."""
    h, w = mask.shape
    runs = _runs(np.ascontiguousarray(mask.T).reshape(-1).astype(np.uint8))
    return {"size": [h, w], "counts": encode_counts(runs)}


def decode_mask(rle: dict) -> np.ndarray:
    h, w = rle["size"]
    counts = rle["counts"]
    runs = (decode_counts(counts) if isinstance(counts, (bytes, str))
            else np.asarray(counts, np.int64))
    vals = np.zeros(len(runs), np.uint8)
    vals[1::2] = 1
    flat = np.repeat(vals, runs)
    if flat.size < h * w:
        flat = np.concatenate([flat, np.zeros(h * w - flat.size, np.uint8)])
    return flat[:h * w].reshape(w, h).T


def rle_area(rle: dict) -> int:
    counts = rle["counts"]
    runs = (decode_counts(counts) if isinstance(counts, (bytes, str))
            else np.asarray(counts, np.int64))
    return int(runs[1::2].sum())
